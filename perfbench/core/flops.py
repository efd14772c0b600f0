"""Operations per image of the benchmark's reference models, counted from
the shapes of each convolution in one forward on the meta device (so it
costs no device time and is the same work whatever implements it).

A convolution's forward is 2 * out elements * in channels per group * k * k
operations, a transposed convolution's 2 * in elements * out channels * k *
k. A train step adds, for each convolution, the weight gradient (as many
operations as its forward) and the input gradient (as many again, except
for the convolutions that read the image itself). Normalization and
elementwise work is not counted. ``torch.utils.flop_counter`` is not used
for the backward: it counts a grouped convolution's weight gradient as if
it were dense (a depthwise 3x3 over 64 channels comes out 64 times too
high).
"""

from __future__ import annotations

import functools

import torch

from perfbench.reference.common import Conv, ConvT


def conv_ops(model: torch.nn.Module, x: torch.Tensor):
    """(forward operations, those of the convolutions that read ``x``
    itself) of ``model(x)``."""
    counts, on_input = [], []

    def hook(mod, args, out):
        k = mod.weight.shape[-1] * mod.weight.shape[-2]
        if isinstance(mod, ConvT):
            ops = 2 * args[0].numel() * mod.weight.shape[1] * k
        else:
            ops = 2 * out.numel() * mod.weight.shape[1] * k
        counts.append(ops)
        if args[0] is x:
            on_input.append(ops)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, ConvT))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(counts), sum(on_input)


@functools.lru_cache(maxsize=None)
def per_image(reference: str, model_key: str, size: tuple, train: bool,
              batch: int = 2) -> float:
    """Operations per image of a forward (``train`` False) or of a train
    step's forward and backward, of ``reference``'s model built from the
    JSON ``model_key`` at input ``size``."""
    import json

    from perfbench.core import spec

    with torch.device("meta"):
        model = spec.reference(reference).build(json.loads(model_key))
        x = torch.empty(batch, 3, *size)
    model.train(train)
    fwd, on_input = conv_ops(model, x)
    total = 3 * fwd - on_input if train else fwd
    return total / batch
