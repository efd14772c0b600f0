"""YOLOv6 (``yolov6``, width 0.25, depth 0.33): the port against JAX on the
CPU at 64x64, B = 2 (84 rows: 64 + 16 + 4 cells at strides 8, 16, 32; JAX
``test_model_zoo.py:147-155``), with the ``deconv`` and the ``nearest``
upsamplers. Eval rows ``[B, 84, 6]``: the box columns in float32 (within 1e-4
relative and 1e-5 of the column's largest magnitude), every column in
float64 (rtol 1e-9); the train-mode raw maps in
float64 on both sides (rtol 1e-9) with the running statistics; the deploy
graph against the train graph and JAX's ``fuse_params`` + deploy apply;
the weights both ways (the ConvTranspose upsamplers through the ``deconv``
kind); the row decode against a direct formula."""

import functools

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import yolov6 as jax_yolov6
from litehandnet_tpu.models.reparam import fuse_params as jax_fuse_params
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.models import yolov6
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    apply_jax,
    assert_close_scaled,
    assert_family_forward,
    assert_weights_round_trip,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    zoo_cfg,
)

RULES = rules_for("yolov6")
UPSAMPLE = ["deconv", "nearest"]


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)


def _cfg(upsample):
    return zoo_cfg("yolov6", num_classes=1, width_multiple=0.25,
                   upsample=upsample)


@functools.lru_cache(maxsize=None)
def _jax_side(upsample):
    model = jax_get_model(jax_cfg(_cfg(upsample)))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port(upsample, deploy=False):
    model = get_model(config_from_dict(_cfg(upsample)), deploy=deploy,
                      device="cpu")
    if not deploy:
        load_jax_variables(model, _jax_side(upsample)[1], RULES)
    return model


def assert_rows_close(got, want, rtol=1e-4, atol=1e-5):
    """Rows ``[B, N, 5 + nc]`` column by column, ``atol`` of each column's
    largest magnitude: the box centers reach the image size, the scores
    stay in [0, 1]."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for c in range(want.shape[-1]):
        assert_close_scaled(got[..., c], want[..., c], rtol, atol)


@pytest.mark.parametrize("upsample", UPSAMPLE)
def test_eval_rows_match_jax(upsample, monkeypatch):
    """Float32: the box columns (cx, cy, w, h). The obj and cls columns are
    sigmoids of logits that random weights drive far from 0, where float32
    rounding of the logit (1e-5 of its magnitude) is no longer small against
    the sigmoid's slope; so every column is held in float64 on both sides,
    rtol 1e-9."""
    model, variables = _jax_side(upsample)
    want, _ = apply_jax(model, variables, _x(), False)
    port = _port(upsample).eval()
    with torch.no_grad():
        got = port(to_nchw(_x()))
    assert got.dtype == torch.float32 and got.shape == (2, 84, 6)
    assert_rows_close(got.numpy()[..., :4], want[..., :4])
    with jax_float64(monkeypatch, jax_yolov6):
        want64, _ = apply_jax(model, to_float64(variables),
                              _x().astype(np.float64), False)
    with torch.no_grad():
        got64 = port.double()(to_nchw(_x()).double())
    assert_rows_close(got64.numpy(), want64, 1e-9, 1e-10)


@pytest.mark.parametrize("upsample", UPSAMPLE)
def test_train_raw_maps_match_jax(upsample, monkeypatch):
    """Per scale ``[B, 4 + 1 + nc, ny, nx]``, channels reg4, obj, cls, in
    float64 with the running statistics after the call."""
    model, variables = _jax_side(upsample)
    out = assert_family_forward(_port(upsample), model, variables, _x(),
                                "train", RULES, monkeypatch, [jax_yolov6])
    assert [tuple(o.shape) for o in out] == [(2, 6, 8, 8), (2, 6, 4, 4),
                                              (2, 6, 2, 2)]


@pytest.mark.parametrize("upsample", UPSAMPLE)
def test_deploy_graph_matches_train_graph_and_jax(upsample, monkeypatch):
    """``fuse_params`` of the train graph loads strictly into the deploy
    graph; its rows equal the train graph's and JAX's deploy apply on JAX's
    ``fuse_params``, the box columns in float32 (1e-5 of the column's max)
    and every column in float64 (1e-9: the scores' sigmoids amplify float32
    rounding of their logits, see ``test_eval_rows_match_jax``); the port's
    deploy graph takes JAX's fused weights through the rules."""
    jax_vars = jax_fuse_params(_jax_side(upsample)[1])
    jax_deploy = jax_get_model(jax_cfg(_cfg(upsample)), deploy=True)
    jax_out, _ = apply_jax(jax_deploy, jax_vars, _x(), False)
    with jax_float64(monkeypatch, jax_yolov6):
        jax_out64, _ = apply_jax(
            jax_deploy, jax_fuse_params(to_float64(_jax_side(upsample)[1])),
            _x().astype(np.float64), False)
    for dtype, cols, tol in ((torch.float32, slice(0, 4), 1e-5),
                             (torch.float64, slice(None), 1e-9)):
        train = _port(upsample).to(dtype).eval()
        deploy = _port(upsample, deploy=True).to(dtype).eval()
        deploy.load_state_dict(fuse_params(train))
        x = to_nchw(_x()).to(dtype)
        with torch.no_grad():
            want = train(x).numpy()
            got = deploy(x).numpy()
        assert_rows_close(got[..., cols], want[..., cols], tol, tol)
        jax_want = jax_out if dtype == torch.float32 else jax_out64
        assert_rows_close(got[..., cols], jax_want[..., cols], tol, tol)
    twin = _port(upsample, deploy=True)
    load_jax_variables(twin, jax_vars, rules_for("yolov6", deploy=True))
    with torch.no_grad():
        got = twin.eval()(to_nchw(_x())).numpy()
    assert_rows_close(got[..., :4], jax_out[..., :4], 1e-5, 1e-5)


@pytest.mark.parametrize("upsample", UPSAMPLE)
def test_import_torch_state_dict_round_trip_and_counts(upsample):
    assert_weights_round_trip("yolov6", _port(upsample),
                              _jax_side(upsample)[1])


def test_rows_decode_the_raw_maps():
    """Eval rows are the train-mode maps decoded: ``(xy + grid) * stride``,
    ``exp(wh) * stride``, sigmoid obj and cls, row-major over each scale's
    cells, strides 8, 16, 32 concatenated (float64; the BatchNorms in eval
    mode for both, the head alone switched to its raw maps)."""
    model = _port("deconv").double().eval()
    x = to_nchw(_x()).double()
    with torch.no_grad():
        rows = model(x)
        model.detect.training = True   # its BatchNorms stay in eval mode
        raw = model(x)
    want = []
    for m, stride in zip(raw, (8, 16, 32)):
        B, C, H, W = m.shape
        gy, gx = np.mgrid[0:H, 0:W]
        m = m.numpy()
        r = np.concatenate([
            (m[:, 0:1] + gx) * stride, (m[:, 1:2] + gy) * stride,
            np.exp(np.clip(m[:, 2:4], -30, 30)) * stride,
            1 / (1 + np.exp(-m[:, 4:]))], 1)
        want.append(r.transpose(0, 2, 3, 1).reshape(B, H * W, C))
    assert_rows_close(rows.numpy(), np.concatenate(want, 1), 1e-12, 1e-13)


def test_scaling_and_prior_bias():
    """Channel and repeat scaling as yolo.py:57-71 at width 0.25 / depth
    0.33, and the cls / obj prior bias -log(99)."""
    assert yolov6.scaled_channels(0.25) == jax_yolov6.scaled_channels(0.25)
    assert yolov6.scaled_repeats(0.33) == jax_yolov6.scaled_repeats(0.33)
    model = get_model(config_from_dict(_cfg("deconv")), device="cpu")
    for conv in (*model.detect.cls_preds, *model.detect.obj_preds):
        assert torch.allclose(conv.bias, torch.tensor(-np.log(99.0),
                                                      dtype=torch.float32))
