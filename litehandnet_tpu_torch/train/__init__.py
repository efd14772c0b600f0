"""Training (port of ``litehandnet_tpu/train``): optimizer and LR schedule,
loss scaling, train state, train/eval steps, checkpoints and the trainer.
Single device; multi-GPU data parallelism is not ported yet."""
