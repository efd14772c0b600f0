"""Rank bodies for the port's multi-process tests, and the launcher that
runs them: a world of gloo ranks on the CPU, meeting in a ``FileStore``
under the test's ``tmp_path`` (no ports to collide between test workers).

This module imports torch and the port only, never JAX: each rank is a new
interpreter that imports it to find its body. Every launch has a deadline;
past it the ranks are killed and the test fails instead of hanging.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import timedelta

import pytest
import torch

#: seconds a rank waits at the rendezvous or in a collective
RANK_TIMEOUT = 60
#: seconds a launch may take, ranks' start-up included
JOIN_TIMEOUT = 120


@pytest.fixture
def rank_env(tmp_path_factory, monkeypatch):
    """Ranks that a command starts from this test run on one thread each
    (``OMP_NUM_THREADS``; the test workers share the machine's cores) and
    find a ``tensorflow`` that fails to import (a new process receives this
    one's ``sys.path``), so the chief's ``MetricLogger`` takes TensorBoard's
    own event writer instead of importing TensorFlow for ~12 s."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path_factory.mktemp("no_tensorflow")
    (root / "tensorflow").mkdir()
    (root / "tensorflow" / "__init__.py").write_text(
        'raise ImportError("TensorFlow is left out of test ranks")\n')
    monkeypatch.syspath_prepend(str(root))
    assert str(root) in sys.path


class Ranks:
    """``fn(rank, world, *args)`` running in ``world`` new processes joined
    in one gloo process group; ``join`` waits for them."""

    def __init__(self, fn, world: int, tmp_path, *args,
                 timeout: float = JOIN_TIMEOUT):
        self.name, self.world = fn.__name__, world
        store = os.path.join(str(tmp_path), f"store_{time.monotonic_ns()}")
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.ctx = torch.multiprocessing.start_processes(
            _entry, args=(fn, world, store, args), nprocs=world, join=False,
            start_method="spawn")

    def join(self) -> None:
        """Raises when a rank failed or the deadline passed; the processes
        are gone when it returns or raises."""
        try:
            while not self.ctx.join(
                    timeout=max(self.deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"{self.world} ranks of {self.name} "
                                       f"did not finish in {self.timeout} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def run_world(fn, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT):
    """``Ranks(...)`` joined: returns when every rank has returned."""
    Ranks(fn, world, tmp_path, *args, timeout=timeout).join()


def _entry(rank: int, fn, world: int, store: str, args: tuple) -> None:
    torch.set_num_threads(1)
    from litehandnet_tpu_torch.train.distributed import initialize_multihost

    initialize_multihost(f"file://{store}", world, rank, device="cpu",
                         timeout=timedelta(seconds=RANK_TIMEOUT))
    import torch.distributed as dist

    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# -- rank bodies -------------------------------------------------------------

def step_rank(rank: int, world: int, cfg_dict: dict, init_path: str,
              batch_path: str, sync_bn: bool, out_dir: str) -> None:
    """One data-parallel train step on this rank's rows of the global batch
    at ``batch_path``, from the model and criterion weights at
    ``init_path`` (Adam, LR not scaled); saves the step's metrics and the
    model's state dict to ``out_dir/rank<r>.pt``."""
    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import set_sync_bn
    from litehandnet_tpu_torch.train.distributed import (
        batch_spec,
        make_mesh,
        make_train_step,
    )
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState

    cfg = config_from_dict(cfg_dict)
    mesh = make_mesh(world, device="cpu")
    init = torch.load(init_path, weights_only=True)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(init["model"])
    criterion = get_loss(cfg)
    criterion.load_state_dict(init["criterion"])
    if sync_bn:
        set_sync_bn(model, mesh.group)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10, world_size=1)
    state = TrainState.create(model, criterion, tx)
    batch = torch.load(batch_path, weights_only=True)
    rows = batch_spec(mesh, len(batch["img"]))
    local = {k: v[rows] for k, v in batch.items()}
    metrics = make_train_step("cpu", mesh)(state, local)
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "model": model.state_dict(),
                "criterion": criterion.state_dict(),
                "rows": (rows.start, rows.stop)},
               os.path.join(out_dir, f"rank{rank}.pt"))


def remat_rank(rank: int, world: int, cfg_dict: dict, init_path: str,
               batch_path: str, out_dir: str) -> None:
    """Three data-parallel Adam steps with SyncBN, each from the model at
    ``init_path`` on this rank's rows of the batch at ``batch_path``: plain
    and remat with dropout generator seed 7, remat with seed 8; saves the
    first two's metrics and state dicts and the third's loss to
    ``out_dir/remat_rank<r>.pt``."""
    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import set_sync_bn
    from litehandnet_tpu_torch.train.distributed import (
        batch_spec,
        make_mesh,
        make_train_step,
    )
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState

    cfg = config_from_dict(cfg_dict)
    mesh = make_mesh(world, device="cpu")
    init = torch.load(init_path, weights_only=True)
    batch = torch.load(batch_path, weights_only=True)
    rows = batch_spec(mesh, len(batch["img"]))
    local = {k: v[rows] for k, v in batch.items()}
    out = {}
    for key, remat, seed in (("plain", False, 7), ("remat", True, 7),
                             ("other", True, 8)):
        model = get_model(cfg, device="cpu")
        model.load_state_dict(init["model"])
        set_sync_bn(model, mesh.group)
        tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
        state = TrainState.create(model, get_loss(cfg), tx)
        metrics = make_train_step("cpu", mesh, remat=remat)(
            state, local, torch.Generator().manual_seed(seed))
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "model": model.state_dict()}
    out["other_seed_loss"] = out.pop("other")["metrics"]["loss"]
    torch.save(out, os.path.join(out_dir, f"remat_rank{rank}.pt"))


def fit_rank(rank: int, world: int, cfg_dict: dict, batch_path: str,
             log_dir: str, out_dir: str) -> None:
    """``Trainer.fit`` for the epochs of ``cfg_dict`` over this rank's rows
    of the batches at ``batch_path`` (each rank its own rows; validation on
    the first), counting this rank's ``torch.save`` calls, then a restore
    of the best slot into a fresh state; saves what each rank saw to
    ``out_dir/rank<r>.pt``."""
    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.train.distributed import batch_spec
    from litehandnet_tpu_torch.train.trainer import Trainer

    cfg = config_from_dict(cfg_dict)
    batches = torch.load(batch_path, weights_only=True)
    trainer = Trainer(cfg, steps_per_epoch=len(batches), log_dir=log_dir,
                      device="cpu")
    rows = batch_spec(trainer.world, len(batches[0]["img"]))
    local = [{k: v[rows] for k, v in b.items()} for b in batches]
    state = trainer.init_state(seed=0)
    saves, save = [], torch.save
    torch.save = lambda *a, **kw: saves.append(1) or save(*a, **kw)
    try:
        state = trainer.fit(state, lambda epoch: local, lambda: local[:1],
                            seed=0)
    finally:
        torch.save = save
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    trainer.close()
    fresh = trainer.init_state(seed=1)
    restored, meta = trainer.ckpt.restore(fresh, best=True)
    torch.save({"trained": trained,
                "restored": restored.model.state_dict(),
                "meta": meta, "step": state.step, "saves": len(saves),
                "min_val_loss": trainer.min_val_loss,
                "lrs": [trainer.schedule(t) for t in range(3 * len(batches))],
                "world": trainer.world.size},
               os.path.join(out_dir, f"rank{rank}.pt"))


def spatial_serve_rank(rank: int, world: int, cases_path: str,
                       out_dir: str) -> None:
    """Each case of ``cases_path`` (a pickle the test wrote: config dict,
    JAX variables or None for the port's seed-0 weights, image, centers,
    scales, and optionally ``dtype`` "float64" for a model and image in
    float64) through ``make_spatial_serve`` over this world, on the graph
    ``spatial_model`` builds; saves the
    gathered maps, the decoded outputs and the exchange counts of each
    case to ``out_dir/rank<r>.pt``."""
    import pickle

    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.eval.spatial_serving import (
        make_spatial_serve,
        spatial_model,
    )
    from litehandnet_tpu_torch.train.distributed import make_mesh

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in cases.items():
        model = spatial_model(config_from_dict(case["cfg"]), case["variables"],
                              device="cpu")
        img = torch.from_numpy(case["img"])
        if case.get("dtype") == "float64":
            model, img = model.double(), img.double()
        serve = make_spatial_serve(model, mesh)
        hm = serve.heatmaps(img)
        preds, maxvals = serve(img, case["centers"], case["scales"])
        out[name] = {"hm": hm, "preds": preds, "maxvals": maxvals,
                     "exchanges": dict(serve.exchanges)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spatial_op_cases() -> dict:
    """name -> (op, input shape, argument) of the per-op checks: odd and
    uneven heights, so that a world of 3 holds bands of unequal size and
    some ranks hold none of a small output."""
    cases = {}
    for k, s, d, groups, h in [(1, 1, 1, 1, 10), (3, 1, 1, 1, 10),
                               (3, 2, 1, 1, 10), (3, 2, 1, 1, 11),
                               (7, 1, 1, 6, 10), (3, 1, 2, 6, 10),
                               (3, 1, 2, 6, 4), (1, 2, 1, 1, 11),
                               (3, 2, 1, 6, 5)]:
        cases[f"conv_k{k}_s{s}_d{d}_g{groups}_h{h}"] = (
            "conv", (1, 6, h, 9), dict(kernel_size=k, stride=s, dilation=d,
                                       groups=groups, padding=d * (k // 2)))
    cases["conv_k3_unpadded_h10"] = ("conv", (1, 6, 10, 9),
                                     dict(kernel_size=3, padding=0))
    for h in (11, 7, 2):
        cases[f"max_pool2_h{h}"] = ("max_pool2", (1, 6, h, 9), None)
    for h, size in [(5, (10, 18)), (4, (7, 9)), (3, (8, 5)), (10, (10, 9)),
                    (2, (4, 4))]:
        cases[f"resize_{h}_to_{size[0]}x{size[1]}"] = (
            "resize_nearest", (1, 6, h, 9), size)
    for h, size in [(10, (3, 4)), (12, (2, 2)), (16, (5, 3)), (8, (8, 9))]:
        cases[f"banded_pool_{h}_to_{size[0]}x{size[1]}"] = (
            "banded_pool", (1, 6, h, 9), size)
    for h in (10, 7, 3):
        cases[f"global_pool3x3_h{h}"] = ("global_pool", (1, 6, h, 9), (3, 3))
        cases[f"mean_h{h}"] = ("mean", (1, 6, h, 9), None)
    # 3x3 regions that overlap on 2 rows; a rank without rows
    cases["global_pool3x3_h2"] = ("global_pool", (1, 6, 2, 9), (3, 3))
    for h in (10, 7, 3, 2):
        cases[f"global_max_h{h}"] = ("amax", (1, 6, h, 9), None)
    # ResNet's stem pool (3x3, stride 2, padding 1) on all-negative inputs:
    # a -inf halo, and rank 2 of 3 without output rows at heights 2, 3, 7
    for h in (11, 10, 7, 3, 2):
        cases[f"max_pool_k3_s2_p1_h{h}"] = ("max_pool", (1, 6, h, 9),
                                            (3, 2, 1, False))
    cases["max_pool_k2_s2_ceil_h7"] = ("max_pool", (1, 6, 7, 9),
                                       (2, 2, 0, True))
    # the deconvolution head's ConvTranspose2d(4, 2, 1); at heights 1 and 2
    # rank 2 of 3 holds no input rows, at 1 no output rows either; then a
    # 3x3 one with output padding and YOLOv6's 2x2 one
    for h in (1, 2, 3, 5):
        cases[f"conv_transpose_k4_s2_p1_h{h}"] = (
            "conv_transpose", (1, 6, h, 5),
            dict(kernel_size=4, stride=2, padding=1))
    cases["conv_transpose_k3_s2_p1_op1_h3"] = (
        "conv_transpose", (1, 6, 3, 5),
        dict(kernel_size=3, stride=2, padding=1, output_padding=1))
    cases["conv_transpose_k2_s2_h3"] = ("conv_transpose", (1, 6, 3, 5),
                                        dict(kernel_size=2, stride=2))
    # Lite-HRNet's align-corners bilinear resize up its iterative head
    for h, size in [(2, (4, 4)), (4, (8, 8)), (7, (15, 9)), (8, (16, 17))]:
        cases[f"resize_bilinear_{h}_to_{size[0]}x{size[1]}"] = (
            "resize_bilinear", (1, 6, h, size[1] // 2 + 1), size)
    # the cross-resolution pool: the branches gathered in one all-reduce,
    # pooled to the last one's size and concatenated with it, replicated;
    # the last of 2 rows leaves rank 2 of 3 without rows
    for sizes in [((16, 18), (8, 9), (4, 5), (2, 3)), ((8, 8), (4, 4)),
                  ((12, 9), (6, 5), (3, 3))]:
        name = "_".join(f"{h}x{w}" for h, w in sizes)
        cases[f"cross_resolution_pool_{name}"] = ("cross_resolution_pool",
                                                  (1, 6, *sizes[-1]), sizes)
    return cases


def spatial_ops_rank(rank: int, world: int, out_dir: str) -> None:
    """Each case of ``spatial_op_cases`` on this rank's band of a seeded
    random input: the sharded op, gathered (or replicated), beside the
    unsharded op on the whole input; saved to ``out_dir/rank<r>.pt``."""
    import torch.nn.functional as F

    from litehandnet_tpu_torch.eval.spatial_serving import Band, ShardedOps
    from litehandnet_tpu_torch.models import layers as L
    from litehandnet_tpu_torch.models.litehrnet import (
        resize_bilinear_align_corners,
    )
    from litehandnet_tpu_torch.train.distributed import make_mesh

    sh = ShardedOps(make_mesh(device="cpu"), torch.contiguous_format)
    out = {}
    for i, (name, (op, shape, arg)) in enumerate(spatial_op_cases().items()):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(shape, generator=gen)
        rows = sh.rows(shape[2])
        band = Band(x[:, :, rows.start:rows.stop], shape[2])
        if op == "conv":
            torch.manual_seed(i)
            conv = torch.nn.Conv2d(shape[1], 6, **arg)
            got, want = sh.gather(sh.conv(band, conv)), conv(x)
        elif op == "max_pool2":
            got, want = sh.gather(sh.max_pool2(band)), L.max_pool2(x)
        elif op == "resize_nearest":
            got = sh.gather(sh.resize_nearest(band, arg))
            want = L.resize_nearest(x, arg)
        elif op == "banded_pool":
            got = sh.gather(sh.adaptive_avg_pool(band, arg, banded=True))
            want = L.adaptive_avg_pool(x, arg)
        elif op == "global_pool":
            got = sh.adaptive_avg_pool(band, arg, banded=False)
            want = F.adaptive_avg_pool2d(x, arg)
        elif op == "max_pool":
            # every value negative: a -inf halo, not a 0 one
            k, st, pad, ceil = arg
            neg = -x.abs() - 1.0
            band = Band(neg[:, :, rows.start:rows.stop], shape[2])
            pool = torch.nn.MaxPool2d(k, st, pad, ceil_mode=ceil)
            got = sh.gather(sh.run(pool, band))
            want = pool(neg)
        elif op == "conv_transpose":
            torch.manual_seed(i)
            conv = torch.nn.ConvTranspose2d(shape[1], 4, **arg)
            got, want = sh.gather(sh.conv_transpose(band, conv)), conv(x)
        elif op == "resize_bilinear":
            got = sh.gather(sh.resize_bilinear(band, arg))
            want = resize_bilinear_align_corners(x, arg)
        elif op == "cross_resolution_pool":
            xs = [torch.randn((1, shape[1], h, w), generator=gen)
                  for h, w in arg]
            bands = [Band(t[:, :, sh.rows(h).start:sh.rows(h).stop], h)
                     for t, (h, w) in zip(xs, arg)]

            def pool(maps):
                return torch.cat([L.adaptive_avg_pool(t, arg[-1])
                                  for t in maps[:-1]] + [maps[-1]], dim=1)

            got, want = pool(sh.gather_all(bands)), pool(xs)
        elif op == "amax":
            # every value negative: a rank without rows must not put in 0
            neg = -x.abs() - 1.0
            band = Band(neg[:, :, rows.start:rows.stop], shape[2])
            got, want = sh.amax(band), neg.amax(dim=(2, 3), keepdim=True)
        else:
            got, want = sh.mean(band), x.mean(dim=(2, 3), keepdim=True)
        out[name] = {"got": got.detach(), "want": want.detach(),
                     "counts": dict(sh.counts)}
        sh.counts.clear()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
