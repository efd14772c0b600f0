"""Height-sharded serving (``eval/spatial_serving.py``) of the benchmark zoo:
the eval-mode graphs of ``srhandnet`` (24 channels: 21 joints and the
region maps), ``litehrnet`` 18 and 30, ``resnet`` 18 (with and without the
deep stem) and 50, ``mobilenetv2`` at widths 0.5 and 1.0, and the stacked
``hourglass`` (2 stacks, 2 levels, 32 features).

At 64², at the zoo tests' widths (``tests/torch_parity.zoo_cfg``). One
module fixture starts worlds of 2 and 4 gloo ranks
(``tests/torch_workers.py``) that serve every case in float32 and in
float64. Meanwhile one case of each family is held to JAX on the 8-device
CPU mesh (``tests/conftest.py``), in float32, on JAX variables that the
ranks load through ``utils/weights``:

- ``srhandnet``, ``resnet18`` and ``mobilenetv2_w1.0`` to JAX's
  ``make_spatial_serve``, on JAX's ``init(PRNGKey(0))`` (jitted: the same
  values as the eager init, in a third of its time);
- ``litehrnet18`` to JAX's ``make_spatial_serve`` on
  ``tests/torch_parity.init_jax``'s seeded draws: JAX's ``init`` of
  Lite-HRNet runs for tens of seconds on a CPU, eager or jitted, the draws
  for seconds;
- ``hourglass`` to JAX's one-device forward, its last stack
  (``outputs[:, -1]``, as JAX's ``tools/test``) decoded by JAX's
  ``keypoints_from_heatmaps``: JAX's ``make_spatial_serve`` passes the 5-D
  stack to the decode, which raises.

The other cases take the port's seeded weights (``randomize_``: BatchNorm
statistics away from identity). At 64² Lite-HRNet's 2-row branch, and
ResNet's and MobileNetV2's 2-row last stage, leave 2 of 4 ranks without
rows.

Random weights at 64² give flat maxima whose DARK step is ill-posed (Newton
steps many times the map's size): there a map's float32 rounding moves a
coordinate by more than JAX's 5e-3 px, JAX's own height-sharded serve
against its one-device decode included (MobileNetV2 at width 0.5 on JAX's
``init``, which is why the MobileNetV2 case held to JAX is width 1.0). So
the float32 serve is held on its maps (1e-5 of their max) and on the decode
of its gathered map, and the float64 serve, whose maps round to the same
float32 maps as the one-process forward's, on JAX's tolerances for the
coordinates and maxima.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.eval.spatial_serving import (
    make_spatial_serve as jax_make_spatial_serve,
)
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.ops.decode import (
    keypoints_from_heatmaps as jax_keypoints_from_heatmaps,
)
from litehandnet_tpu.train.distributed import make_mesh as jax_make_mesh
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval import (
    make_spatial_serve,
    served_map,
    spatial_model,
)
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.eval.spatial_serving import _bilinear_rows
from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.train.distributed import World, make_mesh
from tests.torch_parity import family_cfg, init_jax, zoo_cfg
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_workers import Ranks, spatial_serve_rank

SIZE = 64
WORLDS = (2, 4)
# the port's sharded maps against its one-process forward, of their max
MAP_TOL = 1e-5
RANKS_TIMEOUT = 300   # s for a world to start and serve every case
F64 = ":float64"      # the name of a case's float64 serve

CASES = {
    "srhandnet": zoo_cfg("srhandnet", output_channel=24, pred_bbox=True),
    "litehrnet18": zoo_cfg("litehrnet", depth=18),
    "litehrnet30": zoo_cfg("litehrnet", depth=30),
    "resnet18": zoo_cfg("resnet", depth=18),
    "resnet18_deep_stem": zoo_cfg("resnet", depth=18, deep_stem=True),
    "resnet50": zoo_cfg("resnet", depth=50),
    "mobilenetv2_w0.5": zoo_cfg("mobilenetv2", widen_factor=0.5),
    "mobilenetv2_w1.0": zoo_cfg("mobilenetv2", widen_factor=1.0),
    "hourglass": zoo_cfg("hourglass", num_stack=2, num_level=2,
                         input_channel=32),
}
# held to JAX's height-sharded serve, and to JAX's one-device decode of the
# last stack
JAX_SERVED = ("srhandnet", "litehrnet18", "resnet18", "mobilenetv2_w1.0")
JAX_ONE_DEVICE = ("hourglass",)
# drawn by tests/torch_parity.init_jax (seed 0), not JAX's init
JAX_DRAWN = ("litehrnet18",)

# All-reduces per request at 64²: (halo fetches at 2 ranks, at 4 ranks,
# gathers). A halo for each convolution wider than 1x1, each transposed
# convolution and max pool, each align-corners resize; a resize or strided
# 1x1 convolution only where it reads another rank's row. One gather of the
# served map, and Lite-HRNet's gates on gathered maps.
# - srhandnet: the 31 3x3 convolutions (stem 3, 3 stages of 2 blocks of 2,
#   4 heads of 2 blocks of 2); its ×2 resizes read aligned bands.
# - litehrnet: stem 3, transitions 4, per stage module 2 blocks of one
#   depthwise 3x3 a branch and the fuse's strided depthwise convolutions
#   (1, 4, 10 at 2, 3, 4 branches), the head's 4 depthwise 3x3 and its 3
#   bilinear resizes: 3 + 4 + 3 × 5 + 4 × 10 + 3 × 18 + 7 = 123 at depth
#   18 (4 modules in stage 1), 163 at depth 30 (8); 4 ranks add the 3
#   nearest resizes from the 2-row branch in each of stage 2's 3 modules.
#   Gathers: one a branch (SpatialWeighting's mean) and one a block (the
#   cross-resolution pool): 3 × 2 × 3 + 4 × 2 × 4 + 3 × 2 × 5 = 80 at
#   depth 18, 112 at 30, and the served map's.
# - resnet: the stem (7x7, or 3 3x3 with the deep stem), the 3x3 max pool,
#   16 3x3 convolutions of the blocks (8 basic blocks of 2, 16 bottlenecks of
#   1), 3 deconvolutions; 4 ranks add the last stage's strided 1x1
#   projection from 4 rows to 2.
# - mobilenetv2: the 3x3 stem, 17 depthwise 3x3, 3 deconvolutions.
# - hourglass: the 7x7 and 3 residuals of ``pre``, per stack 7 residuals of
#   the 2-level hourglass and the features' residual; its pools and resizes
#   read aligned bands.
EXCHANGES = {
    "srhandnet": (31, 31, 1),
    "litehrnet18": (123, 132, 81),
    "litehrnet30": (163, 172, 113),
    "resnet18": (21, 22, 1),
    "resnet18_deep_stem": (23, 24, 1),
    "resnet50": (21, 22, 1),
    "mobilenetv2_w0.5": (21, 21, 1),
    "mobilenetv2_w1.0": (21, 21, 1),
    "hourglass": (20, 20, 1),
}


def _request(seed=0):
    """One unit-normal image, NHWC, and its center and scale."""
    rng = np.random.RandomState(seed)
    img = rng.normal(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    centers = np.full((1, 2), SIZE / 2, np.float32)
    scales = np.full((1, 2), SIZE / 200, np.float32)
    return img, centers, scales


def _jax_case(name):
    """JAX's model of a case and its variables as numpy."""
    model = jax_get_model(jax_config(CASES[name]))
    x = jnp.zeros((1, SIZE, SIZE, 3))
    if name in JAX_DRAWN:
        return model, init_jax(model, np.asarray(x), seed=0, train=False)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x,
                                             train=False))(x)
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 serving every case, started together; JAX's
    height-sharded serve over the 8-device mesh, and its one-device decode
    of the hourglass's last stack, while they run."""
    work = tmp_path_factory.mktemp("spatial_zoo")
    img, centers, scales = _request()
    jax_models, cases = {}, {}
    for name, cfg in CASES.items():
        variables = None
        if name in JAX_SERVED + JAX_ONE_DEVICE:
            jax_models[name], variables = _jax_case(name)
        cases[name] = {"cfg": cfg, "variables": variables,
                       "img": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                       "centers": centers, "scales": scales}
        cases[name + F64] = {**cases[name], "dtype": "float64"}
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    dirs = {n: work / f"world{n}" for n in WORLDS}
    for d in dirs.values():
        d.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        launches = [Ranks(spatial_serve_rank, n, work, str(work / "cases.pkl"),
                          str(dirs[n]), timeout=RANKS_TIMEOUT)
                    for n in WORLDS]
        try:
            jax_out, stack_error = {}, None
            mesh = jax_make_mesh(8)
            for name in JAX_SERVED:
                serve = jax_make_spatial_serve(jax_models[name], mesh)
                preds, maxvals = serve(cases[name]["variables"], img, centers,
                                       scales)
                jax_out[name] = (np.asarray(preds), np.asarray(maxvals))
            for name in JAX_ONE_DEVICE:
                model, variables = jax_models[name], cases[name]["variables"]
                out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
                    variables, img)
                _, preds, maxvals = jax_keypoints_from_heatmaps(
                    out[:, -1], centers, scales, post_process="unbiased",
                    kernel=11)
                jax_out[name] = (np.asarray(preds), np.asarray(maxvals))
                try:
                    jax_make_spatial_serve(model, mesh)(variables, img,
                                                        centers, scales)
                except ValueError as e:
                    stack_error = str(e)
        finally:
            for ranks in launches:
                ranks.join()
    ranks = {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                            weights_only=True) for r in range(n)]
             for n in WORLDS}
    return dict(cases=cases, ranks=ranks, jax=jax_out,
                stack_error=stack_error)


def _decode(hm, case):
    return keypoints_from_heatmaps(
        unpack_outputs(hm, hm.shape[1])[0], torch.from_numpy(case["centers"]),
        torch.from_numpy(case["scales"]), post_process="unbiased",
        kernel=11)[1:]


def _single_process(case):
    """The port's one-process forward (in the case's dtype), its served
    map, and its decode."""
    model = spatial_model(config_from_dict(case["cfg"]), case["variables"],
                          device="cpu")
    img = torch.from_numpy(case["img"])
    if case.get("dtype") == "float64":
        model, img = model.double(), img.double()
    with torch.no_grad():
        hm = served_map(model(img))
    return (model, hm, *_decode(hm, case))


@pytest.mark.parametrize("name", JAX_SERVED + JAX_ONE_DEVICE)
@pytest.mark.parametrize("n", WORLDS)
def test_spatial_serve_matches_jax(worlds, n, name):
    """JAX's tolerances (``tests/test_spatial_serving.py:54-57``); every
    channel decoded, as JAX's serve (SRHandNet's 24)."""
    got = worlds["ranks"][n][0][name]
    preds, maxvals = worlds["jax"][name]
    assert got["preds"].shape == preds.shape
    np.testing.assert_allclose(got["preds"].numpy(), preds, rtol=1e-5,
                               atol=5e-3)
    np.testing.assert_allclose(got["maxvals"].numpy(), maxvals, rtol=1e-4,
                               atol=1e-5)


def test_jax_serve_cannot_decode_the_stack(worlds):
    """JAX's ``make_spatial_serve`` hands the hourglass's ``[B, S, H, W,
    K]`` stack to ``keypoints_from_heatmaps``, which unpacks four axes:
    the port decodes the last stack instead (ROADMAP Queue 3)."""
    assert "too many values to unpack" in worlds["stack_error"]


# The families neither side serves: JAX's ``make_spatial_serve`` decodes
# ``hm[-1]`` of the output with ``keypoints_from_heatmaps``, which needs a
# 4-D map, and none of them gives one (``mynet_stacked``'s last output is
# its SimDR ``pred_y``; AttHandNet returns coordinates, YOLOv6 rows, the
# classifier logits). The port refuses them before the forward, naming the
# class without a rule. AttHandNet needs 224² for its seven halvings, where
# JAX's sharded forward compiles for minutes on a CPU: ``slow``.
REFUSED = {
    "mynet_stacked": (dict(family_cfg("mynet_stacked"), MODEL=dict(
        name="mynet_stacked", main_channels=32, hg_depth=3,
        output_channel=24, simdr_split_ratio=2)), "MSAttHourglassStacked"),
    "atthandnet": (zoo_cfg("atthandnet", size=224, output_channel=42),
                   "AttHandNet"),
    "yolov6": (zoo_cfg("yolov6", num_classes=1, width_multiple=0.25),
               "YOLOv6"),
    "classifier": (zoo_cfg("classifier", size=32, num_classes=10,
                           widen_factor=0.25), "ImageClassifier"),
}


@pytest.mark.parametrize("name", [
    "mynet_stacked", pytest.param("atthandnet", marks=pytest.mark.slow),
    "yolov6", "classifier"])
def test_neither_side_serves_the_other_families(name):
    cfg, cls = REFUSED[name]
    model = spatial_model(config_from_dict(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match=cls):
        make_spatial_serve(model, World(2, 0, torch.device("cpu")))
    jax_model = jax_get_model(jax_config(cfg))
    size = cfg["DATASET"]["image_size"][0]
    img = np.random.RandomState(0).normal(0, 1, (1, size, size, 3)).astype(
        np.float32)
    variables = init_jax(jax_model, img, seed=0, train=False)
    centers = np.full((1, 2), size / 2, np.float32)
    scales = np.full((1, 2), size / 200, np.float32)
    serve = jax_make_spatial_serve(jax_model, jax_make_mesh(2))
    with pytest.raises(ValueError, match="not enough values to unpack"):
        serve(variables, img, centers, scales)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", WORLDS)
def test_gathered_map_matches_one_process(worlds, n, name):
    """Every case: the gathered map (SRHandNet's finest scale, the
    hourglass's last stack) within 1e-5 of the one-process map's max in
    float32 and in float64; the float32 serve's outputs are the decode of
    its gathered map; the float64 serve's within JAX's tolerances of the
    one-process decode."""
    K = 24 if name == "srhandnet" else 21
    for dtype in ("float32", "float64"):
        case = worlds["cases"][name + (F64 if dtype == "float64" else "")]
        got = worlds["ranks"][n][0][name + (F64 if dtype == "float64"
                                            else "")]
        _, hm, preds, maxvals = _single_process(case)
        assert got["hm"].dtype == hm.dtype == getattr(torch, dtype)
        assert got["hm"].shape == hm.shape == (1, K, SIZE // 4, SIZE // 4)
        err = float((got["hm"] - hm).abs().max())
        assert err <= MAP_TOL * float(hm.abs().max()), (dtype, err)
        if dtype == "float32":
            own_preds, own_maxvals = _decode(got["hm"], case)
            assert torch.equal(got["preds"], own_preds)
            assert torch.equal(got["maxvals"], own_maxvals)
            continue
        np.testing.assert_allclose(got["preds"].numpy(), preds.numpy(),
                                   rtol=1e-5, atol=5e-3)
        np.testing.assert_allclose(got["maxvals"].numpy(), maxvals.numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_gets_the_same_bits(worlds, n):
    first = worlds["ranks"][n][0]
    assert set(first) == set(CASES) | {name + F64 for name in CASES}
    for r, other in enumerate(worlds["ranks"][n][1:], start=1):
        for name in first:
            for key in ("hm", "preds", "maxvals"):
                assert torch.equal(first[name][key], other[name][key]), (
                    r, name, key)
            assert first[name]["exchanges"] == other[name]["exchanges"]


@pytest.mark.parametrize("n", WORLDS)
def test_exchanges_per_request(worlds, n):
    """The counts of ``EXCHANGES``, in either dtype: halos and gathers,
    no reduce."""
    for name, (halo2, halo4, gather) in EXCHANGES.items():
        want = {"halo": halo2 if n == 2 else halo4, "gather": gather}
        for key in (name, name + F64):
            assert worlds["ranks"][n][0][key]["exchanges"] == want, key


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_is_the_model(name):
    """A world of one runs the modules' own ops: the same bits as the
    served map of ``model(x)`` and its decode, and no exchange."""
    img, centers, scales = _request(seed=1)
    case = {"cfg": CASES[name], "variables": None,
            "img": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
            "centers": centers, "scales": scales}
    model, hm, preds, maxvals = _single_process(case)
    serve = make_spatial_serve(model, make_mesh(device="cpu"))
    x = torch.from_numpy(case["img"])
    assert torch.equal(serve.heatmaps(x), hm)
    got_preds, got_maxvals = serve(x, centers, scales)
    assert torch.equal(got_preds, preds) and torch.equal(got_maxvals, maxvals)
    assert serve.exchanges == {}


def test_served_map_is_the_last_scale_and_stack():
    """``served_map``: SRHandNet's finest scale with every channel, the
    hourglass's last stack, a single map as it is."""
    scales = tuple(torch.randn(1, 24, s, s) for s in (4, 4, 8, 16))
    assert served_map(scales) is scales[-1]
    stack = torch.randn(1, 2, 21, 16, 16)
    assert torch.equal(served_map(stack), stack[:, -1])
    single = torch.randn(1, 21, 16, 16)
    assert served_map(single) is single


def test_bilinear_rows_are_pytorchs():
    """The rows of the sharded align-corners resize are the only rows
    ``F.interpolate`` weighs: resizing the one-hot rows of an identity
    shows each output row's weights."""
    for h in range(1, 20):
        eye = torch.eye(h, dtype=torch.float64).view(1, h, h, 1)
        for H in range(1, 40):
            w = F.interpolate(eye, size=(H, 1), mode="bilinear",
                              align_corners=True)[0, :, :, 0]
            for o, (h0, h1) in enumerate(_bilinear_rows(h, H)):
                read = set(torch.nonzero(w[:, o]).flatten().tolist())
                assert read <= {h0, h1}, (h, H, o)


@pytest.mark.parametrize("cfg,classes", [
    (family_cfg("mynet_stacked"), "MSAttHourglassStacked"),
    (zoo_cfg("atthandnet", size=224), "AttHandNet"),
    (zoo_cfg("yolov6", num_classes=1, width_multiple=0.25), "YOLOv6"),
    (zoo_cfg("classifier", size=32, num_classes=10), "ImageClassifier"),
], ids=["mynet_stacked", "atthandnet", "yolov6", "classifier"])
def test_the_families_left_raise(cfg, classes):
    """The families without rules yet raise, naming their classes."""
    model = spatial_model(config_from_dict(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match=classes):
        make_spatial_serve(model, World(2, 0, torch.device("cpu")))
