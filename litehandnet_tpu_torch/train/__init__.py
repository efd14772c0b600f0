"""Training (port of ``litehandnet_tpu/train``): optimizer and LR schedule,
loss scaling, train state, train/eval steps on one device or data-parallel
over processes, checkpoints and the trainer."""

from litehandnet_tpu_torch.train.optim import (  # noqa: F401
    make_lr_schedule,
    make_optimizer,
)
from litehandnet_tpu_torch.train.state import TrainState  # noqa: F401
from litehandnet_tpu_torch.train.distributed import (  # noqa: F401
    World,
    batch_spec,
    globalize_batch,
    initialize_multihost,
    is_chief,
    make_eval_step,
    make_mesh,
    make_train_step,
    run_ranks,
)
