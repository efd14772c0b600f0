"""The cost functions give hand-counted bytes and operations."""

import torch

from perfbench.core import flops, spec
from perfbench.reference.common import Conv, ConvT


def test_blur_log_cost_at_the_serve_shape():
    cost = spec.module("costs", "blur_log")
    n = 128 * 64 * 64 * 21                      # 11,010,048 elements
    assert cost.bytes_moved((128, 64, 64, 21)) == 2 * 4 * n == 88_080_384
    assert cost.operations((128, 64, 64, 21)) == 48 * n == 528_482_304


def test_moments_cost_at_the_largest_train_site():
    cost = spec.module("costs", "moments")
    assert cost.bytes_moved((32, 128, 64, 64)) == 67_108_864 + 1_024
    assert cost.operations((32, 128, 64, 64)) == 4 * 16_777_216


def test_convolution_operations_by_hand():
    model = torch.nn.Sequential(Conv(3, 8, 3, 1, 1), Conv(8, 8, 3, 1, 1,
                                                           groups=8),
                                ConvT(8, 4, 4, 2, 1))
    with torch.device("meta"):
        for m in model.modules():
            if isinstance(m, (Conv, ConvT)):
                m.to_empty(device="meta")
        x = torch.empty(1, 3, 8, 8)
    fwd, on_input = flops.conv_ops(model.to("meta"), x)
    dense = 2 * (8 * 8 * 8) * 3 * 9            # 27,648
    depthwise = 2 * (8 * 8 * 8) * 1 * 9        # 9,216
    transposed = 2 * (8 * 8 * 8) * 4 * 16      # 65,536: each input to 4x4x4
    assert on_input == dense
    assert fwd == dense + depthwise + transposed


def test_reference_forward_operations_match_torch_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    import json
    cfg = spec.config("litehandnet")
    key = json.dumps(cfg["config"]["MODEL"], sort_keys=True)
    per_image = flops.per_image("litehandnet", key, (256, 256), False)
    with torch.device("meta"):
        model = spec.reference("litehandnet").build(cfg["config"]["MODEL"])
        x = torch.empty(2, 3, 256, 256)
    with FlopCounterMode(display=False) as counter:
        model.eval()(x)
    assert per_image == counter.get_total_flops() / 2 == 2_559_775_232
    train = flops.per_image("litehandnet", key, (256, 256), True)
    # the stem's RepBlock reads the image with a 3x3 and a 1x1 conv, s2,
    # whose input gradients are not needed
    on_image = 2 * 32 * 128 * 128 * 3 * (9 + 1)
    assert train == 3 * per_image - on_image
