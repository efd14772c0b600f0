"""Twin-accuracy protocol on the port (port of
``litehandnet_tpu/tools/twin_accuracy.py``).

The JAX tool trains the reference's torch model and the flax model from one
checksum-identical init for hundreds of identical Adam steps on a synthetic
marker corpus, and scores both through one DARK decoder with the
reference's PCK / AUC / EPE. Its stored runs are ``reports/twin_r4/`` and
``reports/twin_r5/``. The port's side trains the port's own model under the
same protocol: the same corpus bytes, the same batch order, the same seeded
init (its checksum equals the stored one) and the same step-0 loss, then
decodes through the port's ``keypoints_from_heatmaps`` (the ``blur_log``
kernel on a CUDA tensor) and scores with the port's ``eval/metrics``:

    python -m litehandnet_tpu_torch.tools.twin_accuracy --side port \\
        --tag litehandnet [--size 256] [--perturb 1e-6 --perturb-seed 1] \\
        [--device cuda|cpu]
    python -m litehandnet_tpu_torch.tools.twin_accuracy --side report \\
        --workdir reports/twin_port/litehandnet
    python -m litehandnet_tpu_torch.tools.twin_accuracy --side report-all

``--tag`` names a stored run (``TWIN_RUNS``). Every protocol argument comes
from that run's stored ``args`` (the ``torch.json`` of the tag at
``--size``) unless it is given on the command line; ``--experiment`` with
``--family`` runs a configuration outside the table on the JAX tool's
defaults. A run writes ``port.json`` (``port_pert<seed>.json`` for a
``--perturb`` replicate, ``port_<precision>.json`` below ``highest``) into
``--workdir`` (``reports/twin_port/<tag>`` or ``<tag>_<size>``) and a
snapshot every 25 steps; a run started again with the same protocol
resumes from its snapshot. ``report`` and ``report-all`` merge ``port.json``
with the stored torch and flax sides of the same run and refuse a
different init checksum or protocol.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import itertools
import json
import os
import re
import time

import numpy as np
import torch

from litehandnet_tpu_torch import card_line, resolve_device

K = 21
SNAPSHOT_EVERY = 25

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STORED_ROOTS = (os.path.join(_REPO, "reports", "twin_r4"),
                os.path.join(_REPO, "reports", "twin_r5"))
PORT_ROOT = os.path.join(_REPO, "reports", "twin_port")

# the JAX tool's defaults, for a run without a stored protocol
DEFAULTS = dict(size=128, train_n=2048, eval_n=256, batch=16, steps=1500,
                lr=2e-3, seed=0)
PROTOCOL = ("family", "refcfg", "mode", "size", "train_n", "eval_n",
            "batch", "steps", "lr", "seed")

TwinRun = collections.namedtuple(
    "TwinRun", "family experiment mode overrides checksum")

#: The stored runs: tag -> (registry family, the port's experiment, mode,
#: MODEL overrides, stored init checksum of ``_checksum``).
TWIN_RUNS = {
    # The stored run built its model from the reference's own config file,
    # which gives reduction 2 (the JAX tool passes that config on,
    # twin_accuracy.py:351); the JAX package's copy of the experiment
    # takes reduction 4 from its template (config/templates.py:81), and
    # with 4 the init checksum is ce8c30178c71f249.
    "litehandnet": TwinRun(
        "litehandnet", "litehandnet/_2_freihand_224x244_dark_h4_ca_none",
        "heatmap", {"MODEL.reduction": 2}, "346bc09f805329e6"),
    "litehrnet18": TwinRun(
        "litehrnet", "litehrnet/_2_freihand_224x244_dark_18", "heatmap", {},
        "0ff1c0ff87c199fb"),
    "litehrnet30": TwinRun(
        "litehrnet", "litehrnet/_1_rhd2d_256x256_dark_30", "heatmap", {},
        "7ae9579e0519f4ea"),
    "mobilenetv2": TwinRun(
        "mobilenetv2", "mobilenetv2/_1_freihand2d_224x224_dark", "heatmap",
        {}, "f7c59dbcd4abed46"),
    "resnet18": TwinRun(
        "resnet", "resnet/_2_freihand2d_224x224_dark_resnet18", "heatmap", {},
        "807cef94b777768b"),
    "srhandnet": TwinRun(
        "srhandnet", "srhandnet/_1_freihand2d_224x224_region", "srhandnet",
        {}, "09a9c9817104e7fd"),
    "mynet": TwinRun(
        "mynet", "mynet/_2_freihand2d_224x224_dark", "heatmap", {},
        "f65705a67e17bc1d"),
}


# ---------------------------------------------------------------- corpus


def _marker_colors():
    """21 well-separated RGB-cube colours."""
    grid = [np.array(c, np.float32)
            for c in itertools.product((0.0, 0.5, 1.0), repeat=3)]
    return np.stack([c for c in grid if c.sum() >= 1.0][:K])


def split_images(seed: int, n: int, size: int, idx, marker_sigma: float = 2.5):
    """Images ``idx`` of ``make_split(seed, n, size)`` and all n joints: the
    same draws, with only the images asked for rendered. Returns (images
    float32 ``[len(idx), S, S, 3]`` in [-1, 1], joints ``[n, K, 2]``)."""
    idx = np.asarray(idx, np.int64)
    rng = np.random.RandomState(seed)
    colors = _marker_colors()
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    joints = rng.uniform(8, size - 8, size=(n, K, 2)).astype(np.float32)
    amps = rng.uniform(0.5, 1.0, size=(n, K)).astype(np.float32)
    rows = {int(i): [] for i in idx}
    for j, i in enumerate(idx):
        rows[int(i)].append(j)
    imgs = np.empty((len(idx), size, size, 3), np.float32)
    for i in range(int(idx.max()) + 1 if len(idx) else 0):
        img = rng.uniform(0, 0.3, (size, size, 3)).astype(np.float32)
        if i not in rows:
            continue
        for k in range(K):
            x, y = joints[i, k]
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                          / (2 * marker_sigma**2))
            img += (amps[i, k] * blob)[..., None] * colors[k]
        imgs[rows[i]] = np.clip(img, 0.0, 1.0)
    return imgs * 2.0 - 1.0, joints


def make_split(seed: int, n: int, size: int, marker_sigma: float = 2.5):
    """n images of 21 colour markers at uniform-random positions with
    per-marker amplitude jitter on noise; positions are continuous, so
    train and eval splits are disjoint. Returns (images float32
    ``[n, S, S, 3]`` in [-1, 1], joints ``[n, K, 2]``)."""
    return split_images(seed, n, size, np.arange(n), marker_sigma)


def batch_schedule(seed: int, n: int, batch: int, steps: int):
    rng = np.random.RandomState(seed)
    batches = []
    while len(batches) < steps:
        perm = rng.permutation(n)
        batches += [perm[j:j + batch]
                    for j in range(0, n - batch + 1, batch)]
    return batches[:steps]


# --------------------------------------------------------------- targets


def _gaussians(joints, size: int, hm_wh, device, sigma: float = 2.0):
    """Unbiased Gaussian heatmaps of every joint (``ops.encode``), NHWC, in
    chunks of 256 samples."""
    from litehandnet_tpu_torch.ops.encode import msra_heatmaps

    outs = []
    for j in range(0, len(joints), 256):
        jt = torch.from_numpy(np.ascontiguousarray(joints[j:j + 256])).to(device)
        t, _ = msra_heatmaps(jt, torch.ones(jt.shape[:2], device=device),
                             (size, size), hm_wh, sigma, unbiased=True)
        outs.append(t.permute(0, 2, 3, 1))
    return torch.cat(outs)


def heatmap_targets(joints, size: int, hm: int, sigma: float = 2.0,
                    device="cpu") -> torch.Tensor:
    """Unbiased-encoding Gaussian heatmaps, joints ``[N, K, 2]`` image px ->
    float32 ``[N, hm, hm, K]`` on ``device``."""
    return _gaussians(joints, size, (hm, hm), device, sigma)


def srhandnet_targets(joints, size: int, out_hw, device="cpu") -> list:
    """Per-scale SRHandNet targets ``[N, h, w, K + 3]``: 21 joint
    Gaussians, the centre Gaussian and the 5x5 w/h-ratio patches around the
    centre cell (the reference's ``SRHandNetGenerateTarget`` layout). Centre
    and size derive from the joint cloud."""
    n = joints.shape[0]
    centers = joints.mean(axis=1, keepdims=True)           # [N, 1, 2] px
    wh = ((joints.max(1) - joints.min(1)) / size).astype(np.float32)
    outs = []
    for h, w in out_hw:
        kpt = _gaussians(joints, size, (h, w), device)
        cen = _gaussians(centers, size, (h, w), device)
        whmap = np.zeros((n, h, w, 2), np.float32)
        cx = np.clip((centers[:, 0, 0] * w / size).astype(int), 0, w - 1)
        cy = np.clip((centers[:, 0, 1] * h / size).astype(int), 0, h - 1)
        for i in range(n):
            whmap[i, max(cy[i] - 2, 0):cy[i] + 3,
                  max(cx[i] - 2, 0):cx[i] + 3] = wh[i]
        outs.append(torch.cat([kpt, cen, torch.from_numpy(whmap).to(device)],
                              -1))
    return outs


# ------------------------------------------------------------------ init


# Where the reference registers a module's children in another order than
# the port, or builds a convolution with a bias that the JAX import folds
# into the next BatchNorm (``utils/torch_import.py`` kind ``conv_fold``), the
# shared init draws as the reference does. The model classes are unchanged.
#: class name -> the children that the reference registers first
REFERENCE_ORDER = {
    "RepBlock": ("rbr_identity",),   # RepVGG's order: identity BN first
    "BRC": ("conv", "bn"),           # pose_hg_ms_att.py: conv before its BN
}
#: family -> the convolutions that carry a bias in the reference
REFERENCE_BIAS = {
    "mobilenetv2": re.compile(
        r"(conv1|conv2|layer\d+\.\d+\.conv\.\d+)\.conv\.0"),
}


def _reference_order(module, prefix=""):
    """(name, module) of ``module`` and its descendants, each parent before
    its children, the children as the reference registers them."""
    yield prefix, module
    kids = dict(module.named_children())
    first = [n for n in REFERENCE_ORDER.get(type(module).__name__, ())
             if n in kids]
    for name in first + [n for n in kids if n not in first]:
        yield from _reference_order(kids[name],
                                    f"{prefix}.{name}" if prefix else name)


def sane_reinit(model, seed: int = 0, family: str = ""):
    """Xavier weights and randomized BatchNorm statistics, drawn from
    ``torch.manual_seed(seed)`` module by module in the reference's order.
    A convolution that carries a bias in the reference (``REFERENCE_BIAS``)
    draws one after its weight, and the BatchNorm after it takes the bias
    into its running mean (``mean - bias``, JAX's ``conv_fold``)."""
    import torch.nn as tnn

    biased = REFERENCE_BIAS.get(family)
    fold = None
    torch.manual_seed(seed)
    for name, mod in _reference_order(model):
        if isinstance(mod, (tnn.Conv2d, tnn.ConvTranspose2d, tnn.Linear)):
            tnn.init.xavier_normal_(mod.weight)
            if mod.bias is not None:
                tnn.init.normal_(mod.bias, 0, 0.1)
            elif biased is not None and biased.fullmatch(name):
                fold = torch.empty(mod.weight.shape[0]).normal_(0, 0.1)
        elif isinstance(mod, (tnn.BatchNorm2d, tnn.BatchNorm1d)):
            tnn.init.normal_(mod.weight, 1.0, 0.1)
            tnn.init.normal_(mod.bias, 0, 0.1)
            mod.running_mean.normal_(0, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
            if fold is not None:
                mod.running_mean.sub_(fold)
                fold = None


def zero_dropout(model) -> None:
    """p = 0 on every dropout: its draws cannot be twinned across
    frameworks."""
    from litehandnet_tpu_torch.models.layers import Dropout

    for mod in model.modules():
        if isinstance(mod, (Dropout, torch.nn.modules.dropout._DropoutNd)):
            mod.p = 0.0


def _checksum(sd):
    name = sorted(k for k in sd if k.endswith("weight"))[0]
    arr = np.ascontiguousarray(sd[name].detach().cpu().numpy())
    return name, hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def build_config(experiment: str, overrides: dict):
    from litehandnet_tpu_torch.config import get_config

    cfg = get_config(experiment)
    for key, value in overrides.items():
        section, name = key.split(".")
        cfg[section][name] = value
    return cfg


def init_model(cfg):
    """The model of ``cfg`` on the CPU under the shared seeded init, in
    train mode, dropout off."""
    from litehandnet_tpu_torch.models import get_model

    model = get_model(cfg, device="cpu")
    sane_reinit(model, family=cfg.MODEL.name.lower())
    zero_dropout(model)
    return model.train()


def perturb_(model, eps: float, seed: int) -> None:
    """Chaos-band replicate: add ``eps`` times each float parameter's
    standard deviation of Gaussian noise to it (BatchNorm statistics are
    buffers and stay)."""
    prng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            a = p.detach().cpu().numpy()
            if a.dtype.kind != "f" or a.size == 0:
                continue
            scale = float(np.abs(a).std()) or 1.0
            noise = (eps * scale * prng.standard_normal(a.shape)).astype(a.dtype)
            p.copy_(torch.from_numpy(a + noise))


# ------------------------------------------------------------- the side


@contextlib.contextmanager
def precision(mode: str, deterministic: bool):
    """float32 convolutions and matrix products as ``--matmul-precision``
    asks: ``highest`` without TF32, ``high`` with TF32, ``default`` at
    ``torch.set_float32_matmul_precision("medium")``; cuDNN's deterministic
    algorithms when ``deterministic``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    tf32 = mode != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision(
        {"highest": "highest", "high": "high", "default": "medium"}[mode])
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, matmul,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.set_float32_matmul_precision(matmul)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as the model takes it: channels_last on the card,
    contiguous NCHW on the CPU (the CPU backward in channels_last memory is
    unsafe under some builds)."""
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


class Side:
    """One run's model (the shared init, perturbed for a replicate) and
    criterion on ``device``, its targets and batches."""

    def __init__(self, proto: dict, device):
        from litehandnet_tpu_torch.losses import get_loss

        self.proto, self.device = proto, device
        self.cfg = build_config(proto["experiment"], proto["overrides"])
        model = init_model(self.cfg)
        self.checksum = list(_checksum(model.state_dict()))
        if proto.get("perturb"):
            perturb_(model, proto["perturb"], proto["perturb_seed"])
        fmt = (torch.channels_last if device.type == "cuda"
               else torch.contiguous_format)
        self.model = model.to(device, memory_format=fmt)
        self.criterion = get_loss(self.cfg).to(device).train()
        size = proto["size"]
        if proto["mode"] == "srhandnet":
            # the pyramid's per-scale shapes, from an eval-mode probe
            self.model.eval()
            with torch.no_grad():
                probe = self.model(torch.zeros(1, 3, size, size, device=device))
            self.model.train()
            self.out_hw = [tuple(o.shape[2:]) for o in probe]

    def targets(self, joints):
        size = self.proto["size"]
        if self.proto["mode"] == "srhandnet":
            return srhandnet_targets(joints, size, self.out_hw, self.device)
        return heatmap_targets(joints, size, size // 4, device=self.device)

    def batch(self, imgs: torch.Tensor, targets, idx):
        """(input, criterion batch) of rows ``idx`` of ``imgs`` / ``targets``
        (NHWC tensors on the device, or a list of them per scale)."""
        n = len(idx)
        if self.proto["mode"] == "srhandnet":
            meta = {"target": [_nchw(t[idx]) for t in targets],
                    "target_weight": [torch.ones(n, K + 3, device=self.device)]
                    * len(targets)}
        else:
            meta = {"target": _nchw(targets[idx]),
                    "target_weight": torch.ones(n, K, device=self.device)}
        return _nchw(imgs[idx]), meta

    def loss(self, x, meta) -> torch.Tensor:
        loss, _ = self.criterion(self.model(x), meta)
        return loss

    def heatmaps(self, imgs: torch.Tensor) -> torch.Tensor:
        """Eval-mode maps ``[N, H, W, K]`` of ``imgs`` in batches of
        ``batch`` (SRHandNet: its last scale's first K channels), one
        contiguous NHWC tensor."""
        B = self.proto["batch"]
        self.model.eval()
        outs = []
        with torch.no_grad():
            for j in range(0, len(imgs), B):
                o = self.model(_nchw(imgs[j:j + B]))
                if self.proto["mode"] == "srhandnet":
                    o = o[-1][:, :K]
                outs.append(o.permute(0, 2, 3, 1))
        self.model.train()
        return torch.cat(outs)


def decode_and_score(hm_nhwc, joints, size: int) -> dict:
    """DARK decode (``keypoints_from_heatmaps``, ``blur_log`` on a CUDA
    tensor) and the reference's metrics of ``hm_nhwc`` ``[N, H, W, K]``
    against ``joints`` ``[N, K, 2]`` image px."""
    from litehandnet_tpu_torch.eval.metrics import (
        keypoint_auc, keypoint_epe, keypoint_pck_accuracy,
    )
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps

    hm = torch.as_tensor(hm_nhwc)
    n = hm.shape[0]
    center = torch.full((n, 2), size / 2.0, device=hm.device)
    scale = torch.full((n, 2), size / 200.0, device=hm.device)
    _, preds, _ = keypoints_from_heatmaps(hm, center, scale,
                                          post_process="unbiased", kernel=11)
    preds = preds.cpu().numpy()
    mask = np.ones((n, K), bool)
    norm = np.tile([[size, size]], (n, 1)).astype(np.float32)
    _, pck20, _ = keypoint_pck_accuracy(preds, joints, mask, 0.2, norm)
    _, pck05, _ = keypoint_pck_accuracy(preds, joints, mask, 0.05, norm)
    auc = keypoint_auc(preds, joints, mask, float(size), num_step=20)
    epe = keypoint_epe(preds, joints, mask)
    return dict(pck20=float(pck20), pck05=float(pck05), auc=float(auc),
                epe=float(epe))


def step_zero(proto: dict, device) -> dict:
    """The init checksum and the step-0 loss of a run's protocol on
    ``device`` (the first scheduled batch, train mode, no update)."""
    first = batch_schedule(11, proto["train_n"], proto["batch"], 1)[0]
    imgs, joints = split_images(proto["seed"], proto["train_n"],
                                proto["size"], first)
    with precision(proto["matmul_precision"], device.type == "cuda"):
        side = Side(proto, device)
        tgts = side.targets(joints[first])
        rows = torch.arange(len(first), device=device)
        x, meta = side.batch(torch.from_numpy(imgs).to(device), tgts, rows)
        with torch.no_grad():
            loss = float(side.loss(x, meta))
    return {"init_checksum": side.checksum, "loss_first": loss}


def run_port_side(proto: dict, data, device, ckpt_path: str) -> dict:
    """Train the port's model on the protocol (``SNAPSHOT_EVERY``-step
    snapshots, resumed when ``ckpt_path`` holds one of the same protocol),
    then score the eval split and as many train images."""
    train_imgs, train_joints, eval_imgs, eval_joints, batches = data
    card = card_line(device)
    with precision(proto["matmul_precision"], device.type == "cuda"):
        side = Side(proto, device)
        model, criterion = side.model, side.criterion
        train_x = torch.from_numpy(train_imgs).to(device)
        train_t = side.targets(train_joints)
        order = torch.from_numpy(np.stack(batches)).to(device)
        opt = torch.optim.Adam(
            list(model.parameters()) + list(criterion.parameters()),
            lr=proto["lr"])
        losses, start_si, prev_wall = [], 0, 0.0
        if os.path.exists(ckpt_path):
            ck = torch.load(ckpt_path, map_location=device, weights_only=False)
            if ck.get("protocol") == proto:
                model.load_state_dict(ck["model"])
                opt.load_state_dict(ck["optimizer"])
                criterion.load_state_dict(ck["criterion"])
                losses = list(ck["losses"])
                start_si, prev_wall = ck["next_si"], ck["wall_s"]
                print(f"port resume from step {start_si} "
                      f"({prev_wall:.0f}s banked)", flush=True)
        t0 = time.time()
        pending, snap_s = [], 0.0
        for si in range(start_si, len(batches)):
            x, meta = side.batch(train_x, train_t, order[si])
            loss = side.loss(x, meta)
            opt.zero_grad()
            loss.backward()
            opt.step()
            pending.append(loss.detach())
            if si % SNAPSHOT_EVERY == 0:
                ts = time.time()
                losses += torch.stack(pending).tolist()
                pending = []
                print(f"port step {si}/{len(batches)} loss={losses[-1]:.6f} "
                      f"({prev_wall + time.time() - t0:.0f}s)", flush=True)
                tmp = ckpt_path + ".tmp"
                torch.save({
                    "protocol": proto,
                    "model": model.state_dict(),
                    "optimizer": opt.state_dict(),
                    "criterion": criterion.state_dict(),
                    "losses": losses, "next_si": si + 1,
                    "wall_s": prev_wall + time.time() - t0,
                }, tmp)
                os.replace(tmp, ckpt_path)
                snap_s += time.time() - ts
        if pending:
            losses += torch.stack(pending).tolist()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps_run = len(batches) - start_si
        loop_s = time.time() - t0 - snap_s
        n_eval = len(eval_imgs)
        ev = decode_and_score(
            side.heatmaps(torch.from_numpy(eval_imgs).to(device)),
            eval_joints, proto["size"])
        tr = decode_and_score(side.heatmaps(train_x[:n_eval]),
                              train_joints[:n_eval], proto["size"])
    wall = prev_wall + time.time() - t0
    ms_step = loop_s / steps_run * 1e3 if steps_run else None
    print(f"port: wall_s {wall:.1f}, {ms_step} ms/step over {steps_run} steps "
          f"({card})", flush=True)
    return dict(side="port", init_checksum=side.checksum,
                loss_first=losses[0], loss_tail=float(np.mean(losses[-25:])),
                train=tr, eval=ev, wall_s=wall, ms_step=ms_step, card=card)


# --------------------------------------------------------------- reports


def stored_tag(tag: str, size: int) -> str:
    """The stored runs' name of ``tag`` at ``size``: the tag at 128², else
    ``<tag>_<size>``."""
    return tag if size == 128 else f"{tag}_{size}"


def stored_side(stag: str, side: str):
    """The stored ``side`` json ("torch" or "flax") of run ``stag``, flat
    (``<root>/<stag>_<side>.json``) or per directory
    (``<root>/<stag>/<side>.json``), or None."""
    for root in STORED_ROOTS:
        for path in (os.path.join(root, f"{stag}_{side}.json"),
                     os.path.join(root, stag, f"{side}.json")):
            if os.path.isfile(path):
                with open(path) as f:
                    return json.load(f)
    return None


_STEP_LINE = re.compile(r"^\w+ step (\d+)/\d+ loss=(\S+)")
LOG_RTOL = 1e-2   # a logged loss this far from the stored torch side's


def logged_losses(path: str) -> dict:
    """``{step: loss}`` of the ``<side> step N/M loss=X`` lines a side
    printed (every ``SNAPSHOT_EVERY`` steps)."""
    with open(path) as f:
        return {int(m.group(1)): float(m.group(2))
                for m in map(_STEP_LINE.match, f) if m}


def departure(port_dir: str, stag: str, roots=STORED_ROOTS) -> str:
    """Where ``port_dir/port.log``'s losses first leave the stored
    ``<root>/<stag>/torch.log`` by more than ``LOG_RTOL``, as text."""
    torch_log = next((os.path.join(r, stag, "torch.log") for r in roots
                      if os.path.isfile(os.path.join(r, stag, "torch.log"))),
                     None)
    port_log = os.path.join(port_dir, "port.log")
    if torch_log is None or not os.path.isfile(port_log):
        return "no stored torch.log" if torch_log is None else "no port.log"
    port, ref = logged_losses(port_log), logged_losses(torch_log)
    steps = sorted(set(port) & set(ref))
    off = [s for s in steps if abs(port[s] / ref[s] - 1) > LOG_RTOL]
    if not off:
        return (f"logged losses within {LOG_RTOL:g} of torch.log at all "
                f"{len(steps)} logged steps")
    return (f"logged losses leave torch.log (> {LOG_RTOL:g} relative) at "
            f"step {off[0]}: port {port[off[0]]:.6f}, torch {ref[off[0]]:.6f}")


def _pair(port: dict) -> tuple:
    """(torch, flax) stored sides of ``port``'s run, checked: the same init
    checksum and the same protocol as the port's."""
    a = port["args"]
    stag = stored_tag(a["tag"], a["size"])
    t, f = stored_side(stag, "torch"), stored_side(stag, "flax")
    if t is None or f is None:
        raise SystemExit(f"no stored torch and flax runs of {stag!r}")
    for name, r in (("torch", t), ("flax", f)):
        assert r["init_checksum"] == port["init_checksum"], (
            "the sides did not start from the same weights", stag, name,
            r["init_checksum"], port["init_checksum"])
        mismatch = {k: (a.get(k), r["args"].get(k)) for k in PROTOCOL
                    if a.get(k) != r["args"].get(k)}
        assert not mismatch, ("the sides ran different protocols", stag,
                              name, mismatch)
    return t, f


def _delta_rows(rows) -> list:
    lines = ["| run | ΔAUC port−torch | ΔAUC port−flax | ΔPCK@0.2 "
             "port−torch | ΔPCK@0.2 port−flax | ΔEPE px port−torch "
             "| ΔEPE px port−flax | step-0 loss port | step-0 loss torch "
             "| step-0 loss flax |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for stag, p, t, f in rows:
        d = {k: (p["eval"][k] - t["eval"][k], p["eval"][k] - f["eval"][k])
             for k in ("auc", "pck20", "epe")}
        lines.append(
            f"| {stag} | {d['auc'][0]:+.4f} | {d['auc'][1]:+.4f} "
            f"| {d['pck20'][0]:+.4f} | {d['pck20'][1]:+.4f} "
            f"| {d['epe'][0]:+.3f} | {d['epe'][1]:+.3f} "
            f"| {p['loss_first']:.6f} | {t['loss_first']:.6f} "
            f"| {f['loss_first']:.6f} |")
    return lines


def _side_rows(rows) -> list:
    lines = ["| run | steps | side | eval AUC | eval PCK@0.2 | eval PCK@0.05 "
             "| eval EPE px | train AUC | tail loss |",
             "|---|---|---|---|---|---|---|---|---|"]
    for stag, p, t, f in rows:
        for side, r in (("port", p), ("torch (ref)", t), ("flax/TPU", f)):
            m, mt = r["eval"], r["train"]
            lines.append(
                f"| {stag} | {p['args']['steps']} | {side} | {m['auc']:.4f} "
                f"| {m['pck20']:.4f} | {m['pck05']:.4f} | {m['epe']:.3f} "
                f"| {mt['auc']:.4f} | {r['loss_tail']:.6f} |")
    return lines


def _run_lines(rows, dirs) -> list:
    return [f"- {stag}: port {p['wall_s']:.1f} s, {p.get('ms_step')} ms/step "
            f"({p.get('card')}); {departure(d, stag)}"
            for (stag, p, _, _), d in zip(rows, dirs)]


def _write(lines, out) -> str:
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return out


def write_report(args) -> str:
    """``port.json`` of ``--workdir`` beside its stored torch and flax
    sides."""
    with open(os.path.join(args.workdir, "port.json")) as f:
        p = json.load(f)
    t, fl = _pair(p)
    stag = stored_tag(p["args"]["tag"], p["args"]["size"])
    a = p["args"]
    lines = [
        f"# Twin accuracy: {stag} (port, torch, flax)", "",
        f"Protocol: family `{a['family']}` (`{a['experiment']}`), "
        f"{a['size']}x{a['size']} input, {a['steps']} Adam steps (lr "
        f"{a['lr']}, batch {a['batch']}) on {a['train_n']} synthetic marker "
        f"images; {a['eval_n']} held-out images. Init checksum "
        f"`{p['init_checksum'][1]}` identical on the three sides.", ""]
    rows = [(stag, p, t, fl)]
    lines += _side_rows(rows) + [""] + _delta_rows(rows) + [""]
    lines += _run_lines(rows, [args.workdir])
    return _write(lines, args.report_out)


def write_report_all(args) -> str:
    """Every ``<run>/port.json`` under ``--workdir`` beside its stored torch
    and flax sides, one table."""
    rows = []
    for stag in sorted(os.listdir(args.workdir)):
        path = os.path.join(args.workdir, stag, "port.json")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            p = json.load(f)
        rows.append((stag, p, *_pair(p)))
    if not rows:
        raise SystemExit(f"no port runs under {args.workdir}")
    lines = ["# Twin accuracy: the port beside the stored torch and flax "
             "sides", "",
             "Each run starts the three sides from the same init (checksum "
             "checked) on the same protocol (checked); eval columns are the "
             "held-out split.", ""]
    lines += _side_rows(rows) + ["", "## Deltas", ""] + _delta_rows(rows)
    lines += ["", "## Port runs"] + _run_lines(
        rows, [os.path.join(args.workdir, r[0]) for r in rows])
    return _write(lines, args.report_out)


# ------------------------------------------------------------------ main


def protocol(tag=None, experiment=None, family=None, mode=None,
             perturb=0.0, perturb_seed=1, matmul_precision="highest",
             **given) -> dict:
    """A run's protocol: the JAX tool's defaults, under the stored run's
    ``args`` (for a ``tag`` of ``TWIN_RUNS``), under the ``given`` values
    (``size``, ``train_n``, ``eval_n``, ``batch``, ``steps``, ``lr``,
    ``seed``; None keeps the default)."""
    given = {k: v for k, v in given.items() if v is not None}
    if set(given) - set(DEFAULTS):
        raise TypeError(f"unknown protocol keys {set(given) - set(DEFAULTS)}")
    if tag:
        run = TWIN_RUNS[tag]
        size = given.get("size", DEFAULTS["size"])
        torch_side = stored_side(stored_tag(tag, size), "torch")
        base = {**DEFAULTS, "refcfg": None}
        if torch_side is not None:
            base.update({k: torch_side["args"][k] for k in PROTOCOL})
        base.update(family=run.family, mode=run.mode, tag=tag,
                    experiment=run.experiment, overrides=dict(run.overrides))
    elif experiment:
        base = {**DEFAULTS, "refcfg": None, "tag": None,
                "family": family or experiment.split("/")[0],
                "mode": mode or "heatmap", "experiment": experiment,
                "overrides": {}}
    else:
        raise SystemExit("--side port needs --tag or --experiment")
    base.update(given)
    base.update(perturb=perturb, perturb_seed=perturb_seed,
                matmul_precision=matmul_precision)
    return base


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--side", choices=["port", "report", "report-all"],
                   required=True)
    p.add_argument("--tag", choices=sorted(TWIN_RUNS), default=None,
                   help="a stored run; its protocol is the default")
    p.add_argument("--experiment", default=None,
                   help="a configuration outside TWIN_RUNS")
    p.add_argument("--family", default=None)
    p.add_argument("--mode", choices=["heatmap", "srhandnet"], default=None)
    for name, kind in (("size", int), ("train-n", int), ("eval-n", int),
                       ("batch", int), ("steps", int), ("lr", float),
                       ("seed", int)):
        p.add_argument(f"--{name}", type=kind, default=None)
    p.add_argument("--perturb", type=float, default=0.0,
                   help="relative init perturbation of a chaos-band "
                        "replicate (writes port_pert<perturb-seed>.json)")
    p.add_argument("--perturb-seed", type=int, default=1)
    p.add_argument("--matmul-precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="highest: TF32 off; high: TF32 on; default: "
                        "float32 matmul precision 'medium'")
    p.add_argument("--workdir", default=None)
    p.add_argument("--report-out", default="ACCURACY_TWIN.md")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.side == "report":
        if args.workdir is None:
            raise SystemExit("--side report needs --workdir")
        return write_report(args)
    if args.side == "report-all":
        args.workdir = args.workdir or PORT_ROOT
        return write_report_all(args)

    device = resolve_device(args.device)
    proto = protocol(args.tag, args.experiment, args.family, args.mode,
                     args.perturb, args.perturb_seed,
                     args.matmul_precision,
                     **{k: getattr(args, k) for k in DEFAULTS})
    name = proto["tag"] or proto["experiment"].replace("/", "_")
    args.workdir = args.workdir or os.path.join(
        PORT_ROOT, stored_tag(name, proto["size"]))
    os.makedirs(args.workdir, exist_ok=True)
    stem = "port"
    if proto["perturb"]:
        stem = f"port_pert{proto['perturb_seed']}"
    elif proto["matmul_precision"] != "highest":
        stem = f"port_{proto['matmul_precision']}"

    print(f"generating {proto['train_n']}+{proto['eval_n']} images at "
          f"{proto['size']}^2 ...", flush=True)
    train_imgs, train_joints = make_split(proto["seed"], proto["train_n"],
                                          proto["size"])
    eval_imgs, eval_joints = make_split(proto["seed"] + 1, proto["eval_n"],
                                        proto["size"])
    batches = batch_schedule(11, proto["train_n"], proto["batch"],
                             proto["steps"])
    data = (train_imgs, train_joints, eval_imgs, eval_joints, batches)
    result = run_port_side(proto, data, device,
                           os.path.join(args.workdir, f"{stem}_ckpt.pt"))
    result["args"] = proto
    out = os.path.join(args.workdir, f"{stem}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return out


if __name__ == "__main__":
    main()
