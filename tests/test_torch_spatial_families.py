"""Height-sharded serving (``eval/spatial_serving.py``) of the hand families
beyond the flagship: the deploy graph of ``litehandnet_msrb``, and the
eval-mode graphs of ``mynet`` and ``hourglass_ablation`` with every gate
(``ca``, ``se``, ``1x1``, ``identity``, ``cbam``), with ``rca`` and with
``msrb=False``.

At 64² and 32 channels (``tests/torch_parity.family_cfg``). One module
fixture starts worlds of 2 and 4 gloo ranks (``tests/torch_workers.py``)
that serve every case, and meanwhile runs JAX's ``make_spatial_serve`` on
the 8-device CPU mesh (``tests/conftest.py``) for one case of each family,
on JAX variables that the ranks load through ``utils/weights``; the other
cases take the port's seeded weights (``randomize_``: BatchNorm statistics
away from identity). At 64² the deepest level has 2 rows, so 2 of 4 ranks
hold none of it.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.eval.spatial_serving import (
    make_spatial_serve as jax_make_spatial_serve,
)
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models.reparam import fuse_params as jax_fuse_params
from litehandnet_tpu.train.distributed import make_mesh as jax_make_mesh
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval import make_spatial_serve, spatial_model
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.train.distributed import World, make_mesh
from tests.torch_parity import family_cfg
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_workers import Ranks, spatial_serve_rank

SIZE = 64
WORLDS = (2, 4)
# the port's sharded maps against its one-process forward, of their max
MAP_TOL = 1e-5

CASES = {
    "msrb_ca": family_cfg("litehandnet_msrb", msrb_ca="ca", rbu_ca="ca"),
    "msrb_se": family_cfg("litehandnet_msrb", msrb_ca="se", rbu_ca="se"),
    "msrb_none": family_cfg("litehandnet_msrb", msrb_ca="none",
                            rbu_ca="none"),
    "mynet": family_cfg("mynet"),
    "mynet_output_activation": family_cfg("mynet", output_acitivation=True),
    **{f"ablation_{ca}": family_cfg("hourglass_ablation", ca_type=ca)
       for ca in ("cbam", "ca", "se", "1x1", "identity")},
    "ablation_rca": family_cfg("hourglass_ablation", rca=True),
    "ablation_no_msrb": family_cfg("hourglass_ablation", msrb=False,
                                   num_block=(2, 2, 2, 2)),
}
# held to JAX's make_spatial_serve: one case of each family
JAX_CASES = ("msrb_ca", "mynet", "ablation_cbam")

# All-reduces per request at 64² and 2 ranks: (halo fetches, reduces,
# maxima), and one gather. Halos: one per convolution wider than 1x1; 4
# ranks add two (around the 2-row level, a max pool or stride-2 1x1 and a
# resize read another rank's row).
# - litehandnet_msrb: halos stem 5, encoder and decoder 11 each (the MSRB's
#   4 depthwise convs, 7 shuffle units' 1), neck 2 = 29; reduces one a gate
#   (2 in the MSRB, 1 a shuffle unit; the stem's and neck's 4 units are
#   always gated) = 22, and the shortcut pool; ungated 4 + 1.
# - mynet: halos stem 3, each ME_att 8, each of 6 residual towers 4, the
#   features' bottleneck 1 = 44; reduces the 2 RCA gates and the shortcut.
# - hourglass_ablation: CBAM adds two 3x3 convs and the 7x7 gate to each
#   ME_att (6 halos), a mean in place of the RCA pool, and a max; rca gates
#   the 6 towers; msrb=False puts towers of 4 halos in place of the
#   ME_atts' 8.
EXCHANGES = {
    "msrb_ca": (29, 23, 0), "msrb_se": (29, 23, 0), "msrb_none": (29, 5, 0),
    "mynet": (44, 3, 0), "mynet_output_activation": (44, 3, 0),
    "ablation_cbam": (50, 3, 2), "ablation_ca": (44, 3, 0),
    "ablation_se": (44, 3, 0), "ablation_1x1": (44, 1, 0),
    "ablation_identity": (44, 1, 0), "ablation_rca": (44, 9, 0),
    "ablation_no_msrb": (36, 1, 0),
}


def _request(seed=0):
    """One unit-normal image, NHWC, and its center and scale."""
    rng = np.random.RandomState(seed)
    img = rng.normal(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    centers = np.full((1, 2), SIZE / 2, np.float32)
    scales = np.full((1, 2), SIZE / 200, np.float32)
    return img, centers, scales


def _jax_case(cfg_dict):
    """JAX's served model and its variables as numpy: ``init(PRNGKey(0))``,
    as JAX's own spatial test draws them, fused by JAX's ``fuse_params``
    for msrb's deploy graph."""
    cfg = jax_config(cfg_dict)
    model = jax_get_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    if cfg.MODEL.name == "litehandnet_msrb":
        model, variables = (jax_get_model(cfg, deploy=True),
                            jax_fuse_params(variables))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 serving every case, started together; JAX's
    height-sharded serve over the 8-device mesh while they run."""
    work = tmp_path_factory.mktemp("spatial_families")
    img, centers, scales = _request()
    jax_models, cases = {}, {}
    for name, cfg in CASES.items():
        variables = None
        if name in JAX_CASES:
            jax_models[name], variables = _jax_case(cfg)
        cases[name] = {"cfg": cfg, "variables": variables,
                       "img": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                       "centers": centers, "scales": scales}
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    dirs = {n: work / f"world{n}" for n in WORLDS}
    for d in dirs.values():
        d.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        launches = [Ranks(spatial_serve_rank, n, work, str(work / "cases.pkl"),
                          str(dirs[n])) for n in WORLDS]
        try:
            jax_out = {}
            for name, model in jax_models.items():
                serve = jax_make_spatial_serve(model, jax_make_mesh(8))
                preds, maxvals = serve(cases[name]["variables"], img, centers,
                                       scales)
                jax_out[name] = (np.asarray(preds), np.asarray(maxvals))
        finally:
            for ranks in launches:
                ranks.join()
    ranks = {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                            weights_only=True) for r in range(n)]
             for n in WORLDS}
    return dict(cases=cases, ranks=ranks, jax=jax_out)


def _single_process(case):
    """The port's one-process forward and decode of a case."""
    model = spatial_model(config_from_dict(case["cfg"]), case["variables"],
                          device="cpu")
    img = torch.from_numpy(case["img"])
    with torch.no_grad():
        hm = model(img)
    _, preds, maxvals = keypoints_from_heatmaps(
        unpack_outputs(hm, hm.shape[1])[0], torch.from_numpy(case["centers"]),
        torch.from_numpy(case["scales"]), post_process="unbiased", kernel=11)
    return model, hm, preds, maxvals


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("n", WORLDS)
def test_spatial_serve_matches_jax(worlds, n, name):
    """JAX's tolerances (``tests/test_spatial_serving.py:63-66``)."""
    got = worlds["ranks"][n][0][name]
    preds, maxvals = worlds["jax"][name]
    np.testing.assert_allclose(got["preds"].numpy(), preds, rtol=1e-5,
                               atol=5e-3)
    np.testing.assert_allclose(got["maxvals"].numpy(), maxvals, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", WORLDS)
def test_gathered_map_matches_one_process(worlds, n, name):
    """Every variant: the gathered map within 1e-5 of the one-process
    map's max, and the decode of that map."""
    _, hm, preds, maxvals = _single_process(worlds["cases"][name])
    got = worlds["ranks"][n][0][name]
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
    assert set(first) == set(CASES)
    for r, other in enumerate(worlds["ranks"][n][1:], start=1):
        for name in first:
            for key in ("hm", "preds", "maxvals"):
                assert torch.equal(first[name][key], other[name][key]), (
                    r, name, key)
            assert first[name]["exchanges"] == other[name]["exchanges"]


@pytest.mark.parametrize("n", WORLDS)
def test_exchanges_per_request(worlds, n):
    """The counts of ``EXCHANGES``: halos (2 more at 4 ranks), reduces,
    maxima, one gather."""
    for name, (halo, reduce, maxima) in EXCHANGES.items():
        want = {"halo": halo + (2 if n == 4 else 0), "reduce": reduce,
                "gather": 1}
        if maxima:
            want["max"] = maxima
        assert worlds["ranks"][n][0][name]["exchanges"] == want, name


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_is_the_model(name):
    """A world of one runs the modules' own ops: the same bits as
    ``model(x)`` and its decode, and no exchange."""
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


def test_spatial_model_is_the_msrb_deploy_graph():
    """``spatial_model`` fuses msrb's seeded train graph into its deploy
    graph (which ``serve.deploy_model`` leaves unfused); the train graph
    is refused, naming the class without a rule."""
    cfg = config_from_dict(CASES["msrb_ca"])
    model = spatial_model(cfg, device="cpu")
    assert model.deploy and not model.training
    make_spatial_serve(model, World(2, 0, torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="rule for ConvBN:"):
        make_spatial_serve(get_model(cfg, device="cpu"),
                           World(2, 0, torch.device("cpu")))


def test_rejects_the_stacked_family():
    """``mynet_stacked`` (SimDR heads: a ``Linear`` outside any gate, and
    its own classes) has no rules yet."""
    model = spatial_model(config_from_dict(family_cfg("mynet_stacked")),
                          device="cpu")
    with pytest.raises(NotImplementedError,
                       match="Linear, .*MSAttHourglassStacked"):
        make_spatial_serve(model, World(2, 0, torch.device("cpu")))
