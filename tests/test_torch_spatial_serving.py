"""Height-sharded serving of the port (``eval/spatial_serving.py``) against
JAX's ``make_spatial_serve`` and the port's own single-process forward.

Worlds of gloo ranks run in new processes (``tests/torch_workers.py``), each
world launched once for all of its checks: 2 and 4 ranks serve JAX's test
model (``tests/test_spatial_serving.py``'s; at 64² the 2-row deepest level
leaves two of 4 ranks without rows) and its SE and no-attention variants; 3
ranks hold each sharded op to its unsharded op on uneven bands. The JAX side
runs here, over the 8-device CPU mesh that ``tests/conftest.py`` sets up.
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
from litehandnet_tpu.config.templates import make_cfg as jax_make_cfg
from litehandnet_tpu.eval.spatial_serving import (
    make_spatial_serve as jax_make_spatial_serve,
)
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.train.distributed import make_mesh as jax_make_mesh
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval import make_spatial_serve, spatial_spec
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.eval.spatial_serving import _nearest_rows
from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.serve import deploy_model
from litehandnet_tpu_torch.train.distributed import World, make_mesh
from tests.torch_parity import family_cfg
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_workers import (
    Ranks,
    spatial_op_cases,
    spatial_ops_rank,
    spatial_serve_rank,
)

SIZE = 64
WORLDS = (2, 4)
OPS_WORLD = 3
# the port's sharded maps against its one-process forward, of their max
MAP_TOL = 1e-5


def _cfg_dict(ca_type="ca"):
    """JAX's test model: ``tests/test_spatial_serving.py::_tiny_model``."""
    return jax_make_cfg(
        "litehandnet", "freihand", exp_id=906, image_size=SIZE,
        **{"MODEL.input_channel": 32, "MODEL.num_block": [1, 1, 1],
           "MODEL.ca_type": ca_type})


def _request(seed=0):
    """JAX's test request: one unit-normal image, NHWC."""
    rng = np.random.RandomState(seed)
    img = rng.normal(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    centers = np.full((1, 2), SIZE / 2, np.float32)
    scales = np.full((1, 2), SIZE / 200, np.float32)
    return img, centers, scales


def _jax_spatial(cfg_dict, img, centers, scales):
    """JAX's deploy variables from ``init(PRNGKey(0))`` and its
    height-sharded serve over the 8-device mesh."""
    model = jax_get_model(jax_config(cfg_dict), deploy=True)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    serve = jax_make_spatial_serve(model, jax_make_mesh(8))
    preds, maxvals = serve(variables, img, centers, scales)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return variables, np.asarray(preds), np.asarray(maxvals)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """JAX's result, then the worlds of 2 and 4 serving and the world of 3
    holding the ops, all started together; each rank's saved outputs."""
    work = tmp_path_factory.mktemp("spatial")
    img, centers, scales = _request()
    variables, jax_preds, jax_maxvals = _jax_spatial(
        _cfg_dict(), img, centers, scales)
    cases = {ca: {"cfg": _cfg_dict(ca),
                  "variables": variables if ca == "ca" else None,
                  "img": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                  "centers": centers, "scales": scales}
             for ca in ("ca", "se", "none")}
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    dirs = {n: work / f"world{n}" for n in (*WORLDS, OPS_WORLD)}
    for d in dirs.values():
        d.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        launches = [Ranks(spatial_serve_rank, n, work, str(work / "cases.pkl"),
                          str(dirs[n])) for n in WORLDS]
        launches.append(Ranks(spatial_ops_rank, OPS_WORLD, work,
                              str(dirs[OPS_WORLD])))
        for ranks in launches:
            ranks.join()
    ranks = {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                            weights_only=True) for r in range(n)]
             for n in dirs}
    return dict(cases=cases, ranks=ranks, jax_preds=jax_preds,
                jax_maxvals=jax_maxvals)


def _single_process(case):
    """The port's one-process forward and decode of a case."""
    model = deploy_model(config_from_dict(case["cfg"]), case["variables"],
                         device="cpu")
    img = torch.from_numpy(case["img"])
    with torch.no_grad():
        hm = model(img)
    _, preds, maxvals = keypoints_from_heatmaps(
        unpack_outputs(hm, hm.shape[1])[0], torch.from_numpy(case["centers"]),
        torch.from_numpy(case["scales"]), post_process="unbiased", kernel=11)
    return model, hm, preds, maxvals


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_serve_matches_jax(worlds, n):
    """JAX's tolerances (``tests/test_spatial_serving.py:63-66``)."""
    got = worlds["ranks"][n][0]["ca"]
    np.testing.assert_allclose(got["preds"].numpy(), worlds["jax_preds"],
                               rtol=1e-5, atol=5e-3)
    np.testing.assert_allclose(got["maxvals"].numpy(), worlds["jax_maxvals"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ca", ["ca", "se", "none"])
@pytest.mark.parametrize("n", WORLDS)
def test_gathered_map_matches_one_process(worlds, n, ca):
    """Every channel-attention type: the gathered map within 1e-5 of the
    one-process map's max, and the decode of that map."""
    _, hm, preds, maxvals = _single_process(worlds["cases"][ca])
    got = worlds["ranks"][n][0][ca]
    assert got["hm"].shape == hm.shape == (1, 21, SIZE // 4, SIZE // 4)
    err = float((got["hm"] - hm).abs().max())
    assert err <= MAP_TOL * float(hm.abs().max()), err
    np.testing.assert_allclose(got["preds"].numpy(), preds.numpy(),
                               rtol=1e-5, atol=5e-3)
    np.testing.assert_allclose(got["maxvals"].numpy(), maxvals.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_gets_the_same_bits(worlds, n):
    first = worlds["ranks"][n][0]
    for r, other in enumerate(worlds["ranks"][n][1:], start=1):
        for ca in first:
            for key in ("hm", "preds", "maxvals"):
                assert torch.equal(first[ca][key], other[ca][key]), (r, ca, key)
            assert first[ca]["exchanges"] == other[ca]["exchanges"]


@pytest.mark.parametrize("n", WORLDS)
def test_exchanges_per_request(worlds, n):
    """One gather; a reduce for each channel gate and the shortcut pool;
    the SE and plain variants differ from the CA one only in their gates."""
    ex = {ca: worlds["ranks"][n][0][ca]["exchanges"] for ca in ("ca", "se",
                                                                  "none")}
    assert ex["ca"]["gather"] == 1
    assert ex["ca"]["reduce"] == ex["se"]["reduce"] == 3   # 2 MSABs + shortcut
    assert ex["none"].get("reduce") == 1
    assert ex["ca"]["halo"] == ex["se"]["halo"] == ex["none"]["halo"] > 0


@pytest.mark.parametrize("name", list(spatial_op_cases()))
def test_sharded_op_matches_unsharded(worlds, name):
    """Per op in a world of 3 (uneven bands, empty ones at small outputs):
    the gathered or replicated result of every rank against the op on the
    whole input. Copies and maxima (max pools, resize, global max), the
    transposed convolution and bilinear resize (the module's op on a zero
    map holding the fetched rows) and the cross-resolution pool (on the
    gathered maps) are exact; sums within float32 rounding of the largest
    value."""
    op = spatial_op_cases()[name][0]
    for r, rank in enumerate(worlds["ranks"][OPS_WORLD]):
        got, want = rank[name]["got"], rank[name]["want"]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        if op in ("max_pool2", "max_pool", "resize_nearest", "conv_transpose",
                  "resize_bilinear", "cross_resolution_pool", "amax"):
            assert torch.equal(got, want), r
        else:
            err = float((got - want).abs().max())
            assert err <= 1e-6 * max(1.0, float(want.abs().max())), (r, err)
        assert torch.equal(got, worlds["ranks"][OPS_WORLD][0][name]["got"])


def test_world_of_one_is_the_model():
    """A world of one (no process group) runs the modules' own ops: the
    same bits as ``model(x)`` and its decode."""
    case = {"cfg": _cfg_dict("ca"), "variables": None}
    img, centers, scales = _request(seed=1)
    case.update(img=np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                centers=centers, scales=scales)
    model, hm, preds, maxvals = _single_process(case)
    serve = make_spatial_serve(model, make_mesh(device="cpu"))
    x = torch.from_numpy(case["img"])
    assert torch.equal(serve.heatmaps(x), hm)
    got_preds, got_maxvals = serve(x, centers, scales)
    assert torch.equal(got_preds, preds) and torch.equal(got_maxvals, maxvals)
    assert serve.exchanges == {}


def test_spatial_spec_layout():
    """GSPMD's layout: JAX's ``test_spatial_constraint_actually_splits``
    (8 bands of 8 rows), and trailing empty bands."""
    assert [len(r) for r in spatial_spec(64, 8)] == [8] * 8
    assert spatial_spec(64, 8)[3] == range(24, 32)
    assert [len(r) for r in spatial_spec(2, 4)] == [1, 1, 0, 0]
    assert [len(r) for r in spatial_spec(10, 3)] == [4, 4, 2]
    assert spatial_spec(16, World(4, 1, torch.device("cpu")))[1] == range(4, 8)


def test_nearest_rows_are_pytorchs():
    """The row rule of the sharded resize is ``F.interpolate``'s."""
    for h in range(1, 24):
        for H in range(1, 40):
            x = torch.arange(h, dtype=torch.float32).view(1, 1, h, 1)
            want = F.interpolate(x, size=(H, 1), mode="nearest-exact")
            assert _nearest_rows(h, H) == tuple(
                int(v) for v in want.flatten()), (h, H)


def test_rejects_what_it_cannot_serve():
    """An indivisible height (JAX asserts, ``tests/test_spatial_serving.py
    :79``), a family without rules, a ``Linear`` outside any gate, the
    train graph, train mode, parameters off the world's device."""
    cpu = torch.device("cpu")
    cfg = config_from_dict(_cfg_dict())
    model = deploy_model(cfg, device="cpu")
    serve = make_spatial_serve(model, World(8, 0, cpu))
    with pytest.raises(ValueError, match="height 68"):
        serve(torch.zeros(1, 3, 68, 64), np.zeros((1, 2), np.float32),
              np.ones((1, 2), np.float32))
    with pytest.raises(ValueError, match="height 64"):
        make_spatial_serve(model, World(3, 0, cpu)).heatmaps(
            torch.zeros(1, 3, 64, 64))
    yolov6 = deploy_model(config_from_dict(family_cfg("yolov6")),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="YOLOv6"):
        make_spatial_serve(yolov6, World(2, 0, cpu))
    # a served family with a Linear outside any gate
    stray = deploy_model(config_from_dict(family_cfg("mynet")), device="cpu")
    stray.features.append(torch.nn.Linear(32, 32))
    with pytest.raises(NotImplementedError, match="rule for Linear:"):
        make_spatial_serve(stray, World(2, 0, cpu))
    from litehandnet_tpu_torch.models import get_model

    with pytest.raises(NotImplementedError, match="ConvBN"):
        make_spatial_serve(get_model(cfg, device="cpu"), World(2, 0, cpu))
    with pytest.raises(ValueError, match="eval mode"):
        make_spatial_serve(model.train(), World(2, 0, cpu))
    model.eval()
    with pytest.raises(ValueError, match="parameters lie on"):
        make_spatial_serve(model.to("meta"), World(2, 0, cpu))
