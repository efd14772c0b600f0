"""``litehandnet_tpu_torch.tools.twin_accuracy`` against JAX's twin tool and
the stored runs in ``reports/``.

The corpus, the batch order and the marker colours equal JAX's bit for bit;
the targets and ``decode_and_score`` equal JAX's within 1e-6 (the maps
decoded are encoded targets, where DARK is well conditioned). Each stored
run's init checksum and step-0 loss come out of the port's model under the
shared init (the loss within 1e-5 relative of the stored ``loss_first``).
The port side resumes bit-exactly from its snapshot and does not resume a
stale one; the reports refuse another init or protocol."""

import json
import os

import numpy as np
import pytest
import torch

import litehandnet_tpu_torch
from litehandnet_tpu.tools import twin_accuracy as jax_twin
from litehandnet_tpu_torch.tools import twin_accuracy as twin

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
STORED_256 = ("litehandnet", "resnet18")


@pytest.mark.parametrize("seed,n,size", [(0, 6, 64), (10, 12, 128),
                                         (3, 4, 37)])
def test_make_split_equals_jax(seed, n, size):
    imgs, joints = twin.make_split(seed, n, size)
    want_imgs, want_joints = jax_twin.make_split(seed, n, size)
    assert imgs.dtype == want_imgs.dtype == np.float32
    assert imgs.tobytes() == want_imgs.tobytes()
    assert joints.tobytes() == want_joints.tobytes()


@pytest.mark.parametrize("idx", [[5, 0, 3], [11], [2, 2, 7]])
def test_split_images_render_the_same_rows(idx):
    imgs, joints = twin.split_images(10, 12, 128, idx)
    want_imgs, want_joints = jax_twin.make_split(10, 12, 128)
    assert imgs.tobytes() == want_imgs[idx].tobytes()
    assert joints.tobytes() == want_joints.tobytes()


@pytest.mark.parametrize("seed,n,batch,steps", [(11, 2048, 16, 1200),
                                                (11, 8, 2, 3),
                                                (5, 100, 7, 40)])
def test_batch_schedule_equals_jax(seed, n, batch, steps):
    got = twin.batch_schedule(seed, n, batch, steps)
    want = jax_twin.batch_schedule(seed, n, batch, steps)
    assert len(got) == len(want) == steps
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_marker_colors_equal_jax():
    got, want = twin._marker_colors(), jax_twin._marker_colors()
    assert got.shape == (21, 3) and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("size", [128, 256])
def test_heatmap_targets_match_jax(size):
    _, joints = twin.split_images(20, 300, size, [])
    got = twin.heatmap_targets(joints, size, size // 4).numpy()
    want = jax_twin.heatmap_targets(joints, size, size // 4)
    assert got.shape == want.shape == (300, size // 4, size // 4, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_srhandnet_targets_match_jax():
    proto = twin.protocol("srhandnet")
    out_hw = twin.Side(proto, CPU).out_hw
    _, joints = twin.split_images(50, 40, 128, [])
    got = twin.srhandnet_targets(joints, 128, out_hw)
    want = jax_twin.srhandnet_targets(joints, 128, out_hw)
    assert len(got) == len(want) == 4
    for g, w, (h, wd) in zip(got, want, out_hw):
        assert g.shape == w.shape == (40, h, wd, 24)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [128, 256])
def test_decode_and_score_matches_jax(size):
    """Encoded targets as maps, plus a little noise so no map is exact."""
    _, joints = twin.split_images(11, 64, size, [])
    hm = twin.heatmap_targets(joints, size, size // 4).numpy()
    hm = hm + np.random.RandomState(0).uniform(0, 1e-3, hm.shape).astype(
        np.float32)
    got = twin.decode_and_score(torch.from_numpy(hm), joints, size)
    want = jax_twin.decode_and_score(hm, joints, size)
    assert set(got) == set(want) == {"pck20", "pck05", "auc", "epe"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["pck05"] == 1.0


@pytest.mark.parametrize("tag", sorted(twin.TWIN_RUNS))
def test_init_checksum_equals_the_stored_run(tag):
    run = twin.TWIN_RUNS[tag]
    model = twin.init_model(twin.build_config(run.experiment, run.overrides))
    name, digest = twin._checksum(model.state_dict())
    stored = twin.stored_side(tag, "torch")
    assert [name, digest] == stored["init_checksum"]
    assert digest == run.checksum
    assert twin.stored_side(tag, "flax")["init_checksum"] == [name, digest]


def test_the_flagship_takes_the_stored_runs_reduction():
    """With the JAX experiment copy's reduction (4, from its template) the
    flagship's init does not reproduce the stored run."""
    run = twin.TWIN_RUNS["litehandnet"]
    model = twin.init_model(twin.build_config(run.experiment, {}))
    assert twin._checksum(model.state_dict())[1] == "ce8c30178c71f249"


@pytest.mark.parametrize("tag", sorted(twin.TWIN_RUNS))
def test_step_zero_loss_equals_the_stored_run(tag):
    proto = twin.protocol(tag)
    stored = twin.stored_side(tag, "torch")
    assert {k: proto[k] for k in twin.PROTOCOL} == {
        k: stored["args"][k] for k in twin.PROTOCOL}
    got = twin.step_zero(proto, CPU)
    assert got["init_checksum"] == stored["init_checksum"]
    assert abs(got["loss_first"] / stored["loss_first"] - 1) <= LOSS_RTOL, (
        got["loss_first"], stored["loss_first"])


@pytest.mark.parametrize("tag", STORED_256)
def test_step_zero_loss_equals_the_stored_run_at_256(tag):
    proto = twin.protocol(tag, size=256)
    stored = twin.stored_side(f"{tag}_256", "torch")
    assert proto["steps"] == stored["args"]["steps"] and proto["size"] == 256
    got = twin.step_zero(proto, CPU)
    assert abs(got["loss_first"] / stored["loss_first"] - 1) <= LOSS_RTOL


@pytest.mark.parametrize("tag,gap", [("litehandnet", 0.028),
                                     ("mynet", 0.059),
                                     ("mobilenetv2", 0.163)])
def test_module_order_alone_misses_three_stored_runs(tag, gap, monkeypatch):
    """Drawn in ``model.modules()`` order, with no reference bias, the
    flagship (RepBlock's identity BN), ``mynet`` (BRC's conv) and
    MobileNetV2 (its reference conv biases) keep their stored checksums
    but miss their stored step-0 losses by percents."""
    monkeypatch.setattr(twin, "REFERENCE_ORDER", {})
    monkeypatch.setattr(twin, "REFERENCE_BIAS", {})
    proto = twin.protocol(tag)
    stored = twin.stored_side(tag, "torch")
    got = twin.step_zero(proto, CPU)
    assert got["init_checksum"] == stored["init_checksum"]
    rel = abs(got["loss_first"] / stored["loss_first"] - 1)
    assert abs(rel - gap) < 0.001, rel


def test_reference_order_changes_only_the_named_classes():
    """The shared init draws the reference's order: the flagship's stem
    RepBlock with an identity BN draws it first; Lite-HRNet has none of
    the reordered classes, so its draws are ``model.modules()`` order."""
    from litehandnet_tpu_torch.models.layers import RepBlock

    run = twin.TWIN_RUNS["litehandnet"]
    model = twin.init_model(twin.build_config(run.experiment, run.overrides))
    order = [name for name, _ in twin._reference_order(model)]
    block = next(n for n, m in model.named_modules()
                 if isinstance(m, RepBlock) and m.rbr_identity is not None)
    assert order.index(f"{block}.rbr_identity") < order.index(
        f"{block}.rbr_dense")
    run = twin.TWIN_RUNS["litehrnet18"]
    model = twin.init_model(twin.build_config(run.experiment, run.overrides))
    assert [n for n, _ in twin._reference_order(model)] == [
        n for n, _ in model.named_modules()]


def test_perturb_moves_every_parameter_by_its_seed():
    run = twin.TWIN_RUNS["mynet"]
    cfg = twin.build_config(run.experiment, run.overrides)
    base = {n: p.detach() for n, p in twin.init_model(cfg).named_parameters()}
    moved = []
    for seed in (1, 1, 2):
        model = twin.init_model(cfg)
        twin.perturb_(model, 1e-6, seed)
        moved.append({n: p.detach() for n, p in model.named_parameters()})
    for name, p in base.items():
        assert torch.equal(moved[0][name], moved[1][name])
        d = (moved[0][name] - p).abs().max()
        assert 0 < d <= 1e-5 * max(float(p.abs().max()), 1.0), name
    assert any(not torch.equal(moved[0][n], moved[2][n]) for n in base)


TINY = ["--side", "port", "--tag", "litehandnet", "--size", "64",
        "--train-n", "8", "--eval-n", "4", "--batch", "2", "--steps", "3",
        "--seed", "7", "--device", "cpu"]


def test_port_side_resumes_bit_exactly(tmp_path):
    """The port's counterpart of ``tests/test_tools_cli.py:164-200``: the
    step-0 snapshot resumes to the uninterrupted run, bit for bit; a
    snapshot of another protocol (a changed key, another ``--batch``) is
    not resumed."""
    argv = TINY + ["--workdir", str(tmp_path)]
    full = json.loads(open(twin.main(list(argv))).read())
    ck = torch.load(tmp_path / "port_ckpt.pt", map_location="cpu",
                    weights_only=False)
    assert ck["next_si"] == 1 and len(ck["losses"]) == 1
    assert ck["protocol"] == full["args"]
    resumed = json.loads(open(twin.main(list(argv))).read())
    for key in ("init_checksum", "loss_first", "loss_tail", "train", "eval"):
        assert resumed[key] == full[key], key
    assert resumed["args"] == full["args"]
    assert full["args"]["tag"] == "litehandnet" and full["side"] == "port"
    ck["protocol"] = dict(ck["protocol"], seed=999)
    ck["losses"] = [123.0]
    torch.save(ck, tmp_path / "port_ckpt.pt")
    fresh = json.loads(open(twin.main(list(argv))).read())
    assert fresh["loss_first"] == full["loss_first"]
    assert fresh["loss_tail"] == full["loss_tail"]
    batch4 = list(argv)
    batch4[batch4.index("--batch") + 1] = "4"
    other = json.loads(open(twin.main(batch4)).read())
    assert other["loss_first"] != full["loss_first"]
    fresh = json.loads(open(twin.main(list(argv))).read())
    assert fresh["loss_first"] == full["loss_first"]
    assert fresh["loss_tail"] == full["loss_tail"]
    assert fresh["args"]["batch"] == 2


def test_perturbed_replicate_writes_its_own_json(tmp_path):
    argv = TINY + ["--workdir", str(tmp_path), "--perturb", "1e-6",
                   "--perturb-seed", "2"]
    out = twin.main(argv)
    assert os.path.basename(out) == "port_pert2.json"
    r = json.loads(open(out).read())
    assert r["args"]["perturb"] == 1e-6 and r["args"]["perturb_seed"] == 2
    assert os.path.exists(tmp_path / "port_pert2_ckpt.pt")


def test_protocol_comes_from_the_stored_run():
    proto = twin.protocol("resnet18")
    assert (proto["seed"], proto["steps"], proto["size"]) == (20, 1200, 128)
    assert proto["refcfg"] == (
        "config/resnet/_2_freihand2d_224x224_dark_resnet18.py")
    cut = twin.protocol("resnet18", steps=25, eval_n=32)
    assert (cut["seed"], cut["steps"], cut["eval_n"]) == (20, 25, 32)
    assert twin.protocol("litehandnet", size=256)["steps"] == 700
    other = twin.protocol(experiment="mynet/freihand_256")
    assert (other["seed"], other["steps"], other["family"]) == (0, 1500,
                                                               "mynet")


def test_stored_sides_read_both_layouts():
    assert twin.stored_side("litehandnet", "flax")["args"]["seed"] == 10
    assert twin.stored_side("mynet", "torch")["args"]["seed"] == 70
    assert twin.stored_side("resnet18_256", "flax")["args"]["size"] == 256
    assert twin.stored_side("nothing", "torch") is None


def _fake_port(tag, size=128, **change):
    stored = twin.stored_side(twin.stored_tag(tag, size), "torch")
    proto = twin.protocol(tag, size=size)
    proto.update(change)
    m = dict(pck20=0.9, pck05=0.8, auc=0.85, epe=7.5)
    return dict(side="port", init_checksum=list(stored["init_checksum"]),
                loss_first=stored["loss_first"], loss_tail=0.01, train=m,
                eval=m, wall_s=12.0, ms_step=20.0, card="H100, 700 W",
                args=proto)


def test_report_writes_the_delta_table_and_refuses_mismatches(tmp_path):
    work, out = tmp_path / "litehandnet", tmp_path / "report.md"
    work.mkdir()
    (work / "port.json").write_text(json.dumps(_fake_port("litehandnet")))
    argv = ["--side", "report", "--workdir", str(work), "--report-out",
            str(out)]
    twin.main(argv)
    text = out.read_text()
    stored = twin.stored_side("litehandnet", "torch")["eval"]
    assert "346bc09f805329e6" in text and "flax/TPU" in text
    assert f"{0.85 - stored['auc']:+.4f}" in text
    assert "2.206287" in text
    bad = _fake_port("litehandnet")
    bad["init_checksum"][1] = "0000000000000000"
    (work / "port.json").write_text(json.dumps(bad))
    with pytest.raises(AssertionError, match="same weights"):
        twin.main(argv)
    (work / "port.json").write_text(json.dumps(
        _fake_port("litehandnet", steps=25)))
    with pytest.raises(AssertionError, match="different protocols"):
        twin.main(argv)


def test_report_all_merges_every_run(tmp_path):
    for tag, size in (("litehandnet", 128), ("mynet", 128),
                      ("resnet18", 256)):
        d = tmp_path / twin.stored_tag(tag, size)
        d.mkdir()
        (d / "port.json").write_text(json.dumps(_fake_port(tag, size)))
    out = tmp_path / "all.md"
    twin.main(["--side", "report-all", "--workdir", str(tmp_path),
               "--report-out", str(out)])
    text = out.read_text()
    for stag in ("litehandnet", "mynet", "resnet18_256"):
        assert f"| {stag} | " in text
    assert text.count("| port |") == 3 and "## Deltas" in text
    (tmp_path / "mynet" / "port.json").write_text(json.dumps(
        _fake_port("mynet", seed=71)))
    with pytest.raises(AssertionError, match="different protocols"):
        twin.main(["--side", "report-all", "--workdir", str(tmp_path),
                   "--report-out", str(out)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_default_device_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([a for a in TINY if a not in ("--device", "cpu")]
                  + ["--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_stored_runs_are_read_where_the_tool_looks():
    for root in twin.STORED_ROOTS:
        assert os.path.isdir(root)
    assert os.path.basename(twin.PORT_ROOT) == "twin_port"


def test_departure_reads_both_logs(tmp_path):
    stag = "mynet"
    root = tmp_path / "stored"
    (root / stag).mkdir(parents=True)
    (root / stag / "torch.log").write_text(
        "generating ...\ntorch step 0/700 loss=1.238454 (1s)\n"
        "torch step 25/700 loss=0.061204 (24s)\n"
        "torch step 50/700 loss=0.045930 (46s)\n")
    port = tmp_path / "port"
    port.mkdir()
    assert twin.departure(str(port), stag, [str(root)]) == "no port.log"
    (port / "port.log").write_text(
        "port step 0/700 loss=1.238454 (3s)\n"
        "port step 25/700 loss=0.061300 (6s)\n"
        "port step 50/700 loss=0.047589 (9s)\n")
    assert twin.logged_losses(port / "port.log") == {
        0: 1.238454, 25: 0.0613, 50: 0.047589}
    assert "at step 50: port 0.047589, torch 0.045930" in twin.departure(
        str(port), stag, [str(root)])
    assert twin.departure(str(port), "litehandnet", [str(root)]) == (
        "no stored torch.log")


def test_the_port_runs_pair_with_the_stored_sides(tmp_path):
    """Every stored port run (``reports/twin_port``) has the init checksum,
    the protocol and, within 1e-5, the step-0 loss of its stored torch
    side, and ``report-all`` takes them all."""
    runs = sorted(d for d in os.listdir(twin.PORT_ROOT)
                  if os.path.isfile(os.path.join(twin.PORT_ROOT, d,
                                                 "port.json")))
    assert set(runs) >= set(twin.TWIN_RUNS) | {"litehandnet_256",
                                               "resnet18_256"}
    for stag in runs:
        with open(os.path.join(twin.PORT_ROOT, stag, "port.json")) as f:
            port = json.load(f)
        stored, _ = twin._pair(port)
        assert abs(port["loss_first"] / stored["loss_first"] - 1) <= LOSS_RTOL
    out = tmp_path / "all.md"
    twin.main(["--side", "report-all", "--report-out", str(out)])
    assert out.read_text().count("| port |") == len(runs)


def test_card_line_names_no_card_on_the_cpu():
    assert twin.card_line(torch.device("cpu")) == "cpu"
    assert twin.card_line is litehandnet_tpu_torch.card_line
