"""``python -m litehandnet_tpu_torch.tools.test`` on the CPU.

Against JAX: a small LiteHandNet (32 features, 64x64 input) with the JAX
variables of ``model.init(PRNGKey(0), ...)`` (what JAX ``tools/test
--allow-init`` evaluates) carried into a port checkpoint; both CLIs run on
the same FreiHAND-style fixture. Random-init heatmaps have flat maxima
where DARK's Newton step is ill-conditioned, so the decoded predictions
are held to 1e-3 px only where the step is well conditioned
(``ops.decode.dark_conditioning``: |det H| of the log-blurred map at an
interior maximum >= 1e-2 and a step of at most 1 heatmap px), and to
``ALL_TOL`` px everywhere; the metrics to
within one joint crossing a threshold (PCK and AUC to 1 / visible joints,
EPE to the largest prediction gap).

CLI behaviour: ``--load-best``, ``--train`` (the ``train_`` prefix and an
unchanged ``config.json``), the missing checkpoint, ``--vis-dir``,
``--decode-procs 2``, ``--bf16``, ``--data-parallel``, an MPII-action
``mynet`` run and a SimDR configuration whose checkpoint restores its
criterion."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import get_config as jax_get_config
from litehandnet_tpu.data import hand as jax_hand
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.tools import test as jax_test_cli
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data import hand as port_hand
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.ops.decode import dark_conditioning
from litehandnet_tpu_torch.tools import test as test_cli
from litehandnet_tpu_torch.tools import train as train_cli
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

SIZE, N_RECORDS, BATCH = 64, 10, 4
WELL_TOL, ALL_TOL = 1e-3, 0.1    # image px

_CFG = '''
from {pkg}.config.templates import make_cfg

SPLIT = dict(ann_file={ann!r}, img_prefix={prefix!r})


def _get_cfg():
    return make_cfg({model!r}, {dataset!r}, exp_id={exp_id}, image_size={size},
                    **{{"MODEL.input_channel": 32,
                       "DATASET.train": SPLIT, "DATASET.val": SPLIT,
                       "DATASET.test": SPLIT, "TRAIN.batch_per_gpu": {batch},
                       "OPTIMIZER.warmup_steps": 2,
                       "CHECKPOINT.save_root": {root!r},
                       "CHECKPOINT.resume": False, **{extra!r}}})
'''


def write_cfg(path, root, ann, prefix, pkg="litehandnet_tpu_torch",
              model="litehandnet", dataset="freihand", exp_id=9, extra=None):
    path.write_text(_CFG.format(pkg=pkg, ann=str(ann), prefix=prefix,
                                model=model, dataset=dataset, exp_id=exp_id,
                                size=SIZE, batch=BATCH, root=str(root) + "/",
                                extra=extra or {}))
    return str(path)


def write_hand_fixture(root):
    from PIL import Image

    rng = np.random.RandomState(0)
    (root / "images").mkdir(exist_ok=True)
    images, anns = [], []
    for i in range(N_RECORDS):
        name = f"images/{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8)).save(
            root / name)
        images.append(dict(id=i, file_name=name, width=SIZE, height=SIZE))
        kpts = [v for xy in rng.uniform(8, SIZE - 8, (21, 2))
                for v in (float(xy[0]), float(xy[1]), int(rng.rand() > 0.1))]
        anns.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                         keypoints=kpts, bbox=[0.0, 0.0, float(SIZE),
                                               float(SIZE)]))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name="hand")])))
    return ann, str(root) + "/"


@pytest.fixture
def hand(tmp_path):
    ann, prefix = write_hand_fixture(tmp_path)
    return tmp_path, ann, prefix


def save_checkpoint(cfg, model=None, best=False, criterion=None):
    """A port checkpoint of ``model`` (PyTorch init from seed 0 when None)
    in the config's run directory, as ``Trainer`` writes it."""
    if model is None:
        torch.manual_seed(0)
        model = get_model(cfg, device="cpu")
    tx, _ = make_optimizer_from_config(cfg, 1)
    state = TrainState.create(model, criterion or get_loss(cfg), tx)
    CheckpointManager(run_dir(cfg), cfg).save(state, 0, best=best)
    return state


def well_conditioned(hm: np.ndarray) -> np.ndarray:
    """[N, K] mask of the joints whose DARK step is well conditioned
    (``ops.decode.dark_conditioning``)."""
    return dark_conditioning(torch.from_numpy(np.array(hm, np.float32)))[0].numpy()


def capture_results(monkeypatch, module, store, key):
    original = module.FreiHandDataset.evaluate

    def evaluate(self, results, *a, **kw):
        store[key] = results
        return original(self, results, *a, **kw)

    monkeypatch.setattr(module.FreiHandDataset, "evaluate", evaluate)


def test_metrics_equal_jax_on_carried_init(hand, monkeypatch):
    root, ann, prefix = hand
    jax_path = write_cfg(root / "jax_cfg.py", root / "jax_ckpt", ann, prefix,
                         pkg="litehandnet_tpu")
    port_path = write_cfg(root / "port_cfg.py", root / "port_ckpt", ann,
                          prefix)
    jcfg, cfg = jax_get_config(jax_path), get_config(port_path)
    # the variables JAX tools/test --allow-init evaluates (init reads only
    # the input's shape)
    variables = jax_get_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    save_checkpoint(cfg, model)

    store = {}
    capture_results(monkeypatch, jax_hand, store, "jax")
    capture_results(monkeypatch, port_hand, store, "port")
    want = jax_test_cli.main(["--cfg", jax_path, "--allow-init",
                              "--batch-size", str(BATCH)])
    got = test_cli.main(["--cfg", port_path, "--batch-size", str(BATCH),
                         "--device", "cpu"])

    gaps, cond = [], []
    for w, g in zip(store["jax"], store["port"], strict=True):
        np.testing.assert_allclose(g["output_heatmap"], w["output_heatmap"],
                                   rtol=1e-5, atol=1e-4)
        gaps.append(np.abs(g["preds"][..., :2] - w["preds"][..., :2]).max(-1))
        cond.append(well_conditioned(np.asarray(w["output_heatmap"])))
        np.testing.assert_allclose(g["preds"][..., 2], w["preds"][..., 2],
                                   rtol=1e-5, atol=1e-4)
        assert g["bbox_ids"] == [int(i) for i in w["bbox_ids"]]
    gaps, cond = np.concatenate(gaps), np.concatenate(cond)
    assert cond.sum() >= 5, "too few well-conditioned coordinates to hold"
    assert gaps[cond].max() <= WELL_TOL, gaps[cond].max()
    assert gaps.max() <= ALL_TOL, gaps.max()

    visible = sum(int(v > 0) for a in json.loads(ann.read_text())["annotations"]
                  for v in a["keypoints"][2::3])
    assert set(got) == set(want) == {"PCK", "AUC", "EPE"}
    assert abs(got["PCK"] - want["PCK"]) <= 1.0 / visible
    assert abs(got["AUC"] - want["AUC"]) <= 1.0 / visible
    assert abs(got["EPE"] - want["EPE"]) <= gaps.max() + 1e-4
    written = json.loads((root / "port_ckpt" / "freihand" / "litehandnet" / "9"
                          / "checkpoint_pth_metric.json").read_text())
    assert written == {k: float(v) for k, v in got.items()}


def test_multiscale_srhandnet_metrics_equal_jax(hand, monkeypatch):
    """A multi-scale family evaluates with no change to ``tools/test``:
    SRHandNet (24 channels, 4 scales) on the fixture, its finest map cut to
    the 21 joints, against JAX ``tools/test`` on the same carried init: the
    evaluated heatmaps to 1e-5, the metrics within one joint crossing a
    threshold."""
    from litehandnet_tpu_torch.utils.weights import rules_for

    root, ann, prefix = hand
    kw = dict(model="srhandnet", exp_id=51)
    jax_path = write_cfg(root / "jax_cfg.py", root / "jax_ckpt", ann, prefix,
                         pkg="litehandnet_tpu", **kw)
    port_path = write_cfg(root / "port_cfg.py", root / "port_ckpt", ann,
                          prefix, **kw)
    jcfg, cfg = jax_get_config(jax_path), get_config(port_path)
    variables = jax_get_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables),
                       rules_for("srhandnet"))
    save_checkpoint(cfg, model)

    store = {}
    capture_results(monkeypatch, jax_hand, store, "jax")
    capture_results(monkeypatch, port_hand, store, "port")
    want = jax_test_cli.main(["--cfg", jax_path, "--allow-init",
                              "--batch-size", str(BATCH)])
    got = test_cli.main(["--cfg", port_path, "--batch-size", str(BATCH),
                         "--device", "cpu"])
    gaps = []
    for w, g in zip(store["jax"], store["port"], strict=True):
        assert g["output_heatmap"].shape[-1] == 21
        np.testing.assert_allclose(g["output_heatmap"], w["output_heatmap"],
                                   rtol=1e-5, atol=1e-5)
        gaps.append(np.abs(g["preds"][..., :2] - w["preds"][..., :2]).max())
    visible = sum(int(v > 0) for a in json.loads(ann.read_text())["annotations"]
                  for v in a["keypoints"][2::3])
    assert set(got) == set(want) == {"PCK", "AUC", "EPE"}
    assert abs(got["PCK"] - want["PCK"]) <= 1.0 / visible
    assert abs(got["AUC"] - want["AUC"]) <= 1.0 / visible
    assert abs(got["EPE"] - want["EPE"]) <= max(gaps) + 1e-4


def test_load_best_train_split_and_missing_checkpoint(hand):
    root, ann, prefix = hand
    path = write_cfg(root / "cfg.py", root / "ckpt", ann, prefix)
    cfg = get_config(path)
    run = root / "ckpt" / "freihand" / "litehandnet" / "9"
    with pytest.raises(FileNotFoundError, match="--allow-init"):
        test_cli.main(["--cfg", path, "--device", "cpu"])
    save_checkpoint(cfg, best=True)
    with pytest.raises(FileNotFoundError):
        test_cli.main(["--cfg", path, "--device", "cpu"])  # no checkpoint slot
    config_before = (run / "config.json").read_bytes()
    best = test_cli.main(["--cfg", path, "--device", "cpu", "--load-best",
                          "--batch-size", str(BATCH)])
    train = test_cli.main(["--cfg", path, "--device", "cpu", "--load-best",
                           "--train", "--batch-size", str(BATCH)])
    assert json.loads((run / "best_pth_metric.json").read_text()) == {
        k: float(v) for k, v in best.items()}
    assert json.loads((run / "train_best_pth_metric.json").read_text()) == {
        k: float(v) for k, v in train.items()}
    assert not (run / "checkpoint_pth_metric.json").exists()
    # read-only: the run's config.json is the training run's
    assert (run / "config.json").read_bytes() == config_before
    # the same records in both splits here
    assert dict(best) == dict(train)


def test_vis_dir_decode_procs_and_bf16(hand):
    root, ann, prefix = hand
    path = write_cfg(root / "cfg.py", root / "ckpt", ann, prefix)
    save_checkpoint(get_config(path))
    vis = root / "vis"
    base = test_cli.main(["--cfg", path, "--device", "cpu", "--batch-size",
                          str(BATCH), "--vis-dir", str(vis)])
    assert sorted(os.listdir(vis)) == [
        "checkpoint_pth_metric.json", "pred_heatmaps.png", "pred_joints.png"]
    procs = test_cli.main(["--cfg", path, "--device", "cpu", "--batch-size",
                           str(BATCH), "--decode-procs", "2"])
    assert dict(procs) == dict(base)
    bf16 = test_cli.main(["--cfg", path, "--device", "cpu", "--batch-size",
                          str(BATCH), "--bf16"])
    assert set(bf16) == set(base) and all(np.isfinite(list(bf16.values())))


def test_data_parallel_and_cuda_default(hand, monkeypatch):
    """``--data-parallel`` refuses a batch that the local device count does
    not divide (JAX's message; ``tests/test_torch_multiprocess.py`` runs
    it); without CUDA the default device raises."""
    root, ann, prefix = hand
    path = write_cfg(root / "cfg.py", root / "ckpt", ann, prefix)
    monkeypatch.setattr(test_cli, "local_devices",
                        lambda device: [torch.device("cpu")] * 3)
    with pytest.raises(SystemExit, match="--batch-size 32 must divide the 3"):
        test_cli.main(["--cfg", path, "--data-parallel", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main(["--cfg", path, "--allow-init"])


def test_simdr_checkpoint_restores_its_criterion(hand):
    """A SimDR configuration (simdr_split_ratio 2, loss_weight [1.0, 0.5],
    SGD) trains one epoch with ``tools/train``; its checkpoint holds the
    criterion's decoders, which ``tools/test`` restores."""
    root, ann, prefix = hand
    path = write_cfg(root / "cfg.py", root / "ckpt", ann, prefix, extra={
        "PIPELINE.simdr_split_ratio": 2, "LOSS.loss_weight": [1.0, 0.5],
        "OPTIMIZER.type": "SGD", "OPTIMIZER.lr": 0.01})
    trained = train_cli.main(["--cfg", path, "--device", "cpu", "--epochs",
                              "1", "--workers", "2"])
    saved = trained.criterion.state_dict()
    assert {"simdr.x_decoder.weight", "simdr.y_decoder.weight"} <= set(saved)
    assert saved["simdr.x_decoder.weight"].shape == (2 * SIZE, (SIZE // 4) ** 2)
    state = test_cli.restore_state(get_config(path), load_best=False,
                                   allow_init=False)
    for k, v in saved.items():
        assert torch.equal(state.criterion.state_dict()[k], v.cpu()), k
    fresh = get_loss(get_config(path)).state_dict()
    assert not torch.equal(fresh["simdr.x_decoder.weight"],
                           saved["simdr.x_decoder.weight"])
    metrics = test_cli.main(["--cfg", path, "--device", "cpu", "--batch-size",
                             str(BATCH)])
    assert set(metrics) == {"PCK", "AUC", "EPE"}


MPII_NAMES = [
    "rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis", "thorax",
    "upperneck", "head", "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
]


def write_mpii_fixture(root, n=6):
    """MPII-action json list, 96x96 JPEGs and the GT ``.mat``."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.RandomState(1)
    (root / "images").mkdir(exist_ok=True)
    pos = rng.uniform(20, 76, (16, 2, n))
    hb0 = rng.uniform(10, 30, (2, n))
    missing = (rng.rand(16, n) < 0.1).astype(np.float64)
    savemat(root / "mpii_gt_val.mat", dict(
        dataset_joints=np.array([MPII_NAMES], dtype=object),
        jnt_missing=missing, pos_gt_src=pos,
        headboxes_src=np.stack([hb0, hb0 + 20.0])))
    anno = []
    for i in range(n):
        name = f"{i:09d}.jpg"
        Image.fromarray(rng.randint(0, 255, (96, 96, 3), np.uint8)).save(
            root / "images" / name)
        anno.append(dict(image=name, center=[48.0, 40.0], scale=0.4,
                         joints=pos[:, :, i].tolist(),
                         joints_vis=(1 - missing[:, i]).tolist()))
    ann = root / "mpii_action_val.json"
    ann.write_text(json.dumps(anno))
    return ann, str(root / "images") + "/"


def test_mpii_action_mynet(tmp_path):
    """``mynet`` (pred_bbox, 16 joints) at 32 features evaluates MPII-action
    PCKh; the config's own metric list (PCKh, AUC, EPE) is refused by the
    MPII evaluator, as in JAX, so this run asks for PCKh."""
    ann, prefix = write_mpii_fixture(tmp_path)
    extra = {"MODEL.pred_bbox": True, "MODEL.output_channel": 16,
             "MODEL.num_block": [1, 1, 1], "EVAL.metric": ["PCKh"]}
    path = write_cfg(tmp_path / "cfg.py", tmp_path / "ckpt", ann, prefix,
                     model="mynet", dataset="mpii_action", exp_id=1,
                     extra=extra)
    got = test_cli.main(["--cfg", path, "--device", "cpu", "--allow-init",
                         "--batch-size", "4"])
    assert {"Head", "Shoulder", "PCKh", "PCKh@0.1"} <= set(got)
    assert 0.0 <= got["PCKh"] <= 100.0
    path = write_cfg(tmp_path / "cfg_auc.py", tmp_path / "ckpt", ann, prefix,
                     model="mynet", dataset="mpii_action", exp_id=1,
                     extra=dict(extra, **{"EVAL.metric": ["PCKh", "AUC"]}))
    with pytest.raises(KeyError, match="AUC"):
        test_cli.main(["--cfg", path, "--device", "cpu", "--allow-init",
                       "--batch-size", "4"])


def test_unpack_outputs_cuts_region_channels_contiguous():
    """A K+3-channel map in channels_last memory is cut to K channels and
    made K-innermost contiguous (``blur_log``'s fast-path layout); tuples,
    stacks and SimDR heads unpack as in JAX."""
    from litehandnet_tpu_torch.kernels.blur_log import plan

    x = torch.randn(2, 19, 8, 8).contiguous(memory_format=torch.channels_last)
    hm, px, py = test_cli.unpack_outputs(x, 16)
    assert px is None and py is None
    assert hm.shape == (2, 8, 8, 16) and hm.is_contiguous()
    assert torch.equal(hm, x[:, :16].permute(0, 2, 3, 1))
    assert plan(tuple(hm.shape), hm.stride())["path"] == 1
    # the uncut view would take the general path
    view = x[:, :16].permute(0, 2, 3, 1)
    assert plan(tuple(view.shape), view.stride())["path"] == 0
    stacked = torch.randn(2, 3, 16, 8, 8)
    assert torch.equal(test_cli.unpack_outputs(stacked, 16)[0],
                       stacked[:, -1].permute(0, 2, 3, 1))
    coarse, fine = torch.randn(2, 16, 4, 4), torch.randn(2, 16, 8, 8)
    assert torch.equal(test_cli.unpack_outputs((coarse, fine), 16)[0],
                       fine.permute(0, 2, 3, 1))
    sx, sy = torch.randn(2, 16, 128), torch.randn(2, 16, 96)
    hm, px, py = test_cli.unpack_outputs((fine, sx, sy), 16)
    assert px is sx and py is sy and hm.shape == (2, 8, 8, 16)
