"""Plain PyTorch pieces that every reference model of the benchmark shares.

The references are frozen copies of the layer equations of the models the
benchmark serves and trains, written here once more in plain ``torch`` so
that the comparison that decides ``correct`` never runs code of the program
under test. Nothing here imports the program.

Layers keep the program's state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so one seeded
state dict loads into both sides.

Precision: every product runs in float32 with TF32 off (:func:`exact_fp32`).
:func:`fp8_products` rounds each convolution's input and weight to
float8 e4m3 with a per-tensor scale, which is how the serve controls compute
one precision below the served bfloat16.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)   # the served and trained inputs'
IMAGENET_STD = (0.229, 0.224, 0.225)    # normalization, per RGB channel
_FP8 = contextvars.ContextVar("fp8_products", default=False)
FP8_MAX = 448.0  # largest finite float8 e4m3 value


@contextlib.contextmanager
def fp8_products():
    """Inside, every reference convolution reads its input and weight
    rounded to float8 e4m3 (one scale per tensor, its absolute maximum at
    448), as an fp8 deployment of the served graph would."""
    token = _FP8.set(True)
    try:
        yield
    finally:
        _FP8.reset(token)


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32, in cuDNN and cuBLAS alike; the
    process's settings are put back on exit."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _fp8(t: torch.Tensor) -> torch.Tensor:
    tf = t.float()
    scale = FP8_MAX / tf.detach().abs().amax().clamp(min=1e-30)
    return ((tf * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


class Conv(nn.Module):
    """``nn.Conv2d``'s parameters and arithmetic (integer padding)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups

    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x):
        w = self.weight
        if _FP8.get():
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvT(nn.Module):
    """``nn.ConvTranspose2d``'s parameters ``[in, out, k, k]`` and
    arithmetic."""

    def __init__(self, cin, cout, k, stride, padding, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def fan_in(self) -> int:
        # each output sums in * k * k / stride^2 products
        return self.weight[:, 0].numel() // (self.stride * self.stride)

    def forward(self, x):
        w = self.weight
        if _FP8.get():
            x, w = _fp8(x), _fp8(w)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding)


class BN(nn.Module):
    """BatchNorm, eps 1e-5: in train mode the batch mean and biased
    variance (two passes), in eval mode the running statistics."""

    eps = 1e-5

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


class ChannelDropout(nn.Module):
    """Whole channels dropped with probability ``p`` in train mode, the rest
    scaled by 1 / (1 - p); the mask is ``rand([B, C, 1, 1]) < 1 - p``,
    drawn from ``generator``."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand((x.shape[0], x.shape[1], 1, 1),
                       generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def set_generator(model: nn.Module, generator) -> None:
    for m in model.modules():
        if isinstance(m, ChannelDropout):
            m.generator = generator


def seeded_layout(model: nn.Module):
    """Every leaf of ``model``'s state that a seed sets, in module order:
    ``(key, shape, draw, scale, shift)``. Conv weights are N(0, 1/fan_in),
    biases N(0, 0.1^2); BatchNorm scale 0.5 + U(0, 1), shift and running
    mean N(0, 0.1^2), running variance 0.5 + U(0, 1): weights whose fusion
    and normalization do real work."""
    out = []
    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, (Conv, ConvT)):
            out.append((p + "weight", tuple(mod.weight.shape), "normal",
                        mod.fan_in() ** -0.5, 0.0))
            if mod.bias is not None:
                out.append((p + "bias", tuple(mod.bias.shape), "normal",
                            0.1, 0.0))
        elif isinstance(mod, BN):
            c = (mod.weight.shape[0],)
            out += [(p + "weight", c, "uniform", 1.0, 0.5),
                    (p + "bias", c, "normal", 0.1, 0.0),
                    (p + "running_mean", c, "normal", 0.1, 0.0),
                    (p + "running_var", c, "uniform", 1.0, 0.5)]
    return out


def batchnorm_inputs(model: nn.Module, x: torch.Tensor) -> List[Tuple]:
    """The input shapes of every BatchNorm in one train-mode forward of
    ``model`` on ``x``, in call order."""
    shapes, hooks = [], []
    for m in model.modules():
        if isinstance(m, BN):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape))))
    try:
        was = model.training
        model.train()
        with torch.no_grad():
            model(x)
        model.train(was)
    finally:
        for h in hooks:
            h.remove()
    return shapes


# -- the heatmap loss, Adam and the LR schedule ------------------------------

def balanced_l2(output, target, target_weight, value=0.5):
    """The balanced L2 heatmap loss: squared error times the joint's weight,
    positives (target > 0.5) scaled by numel / (n_pos + 1) * 0.1, negatives
    by numel / (n_neg + 1), then the mean."""
    loss = (output - target).square() * target_weight[:, :, None, None]
    pos = target > value
    numel = float(loss.numel())
    n_pos = pos.sum().to(loss.dtype)
    pos_f = numel / (n_pos + 1.0) * 0.1
    neg_f = numel / (numel - n_pos + 1.0)
    return torch.where(pos, loss * pos_f, loss * neg_f).mean()


def warmup_lr(base: float, warmup: int, t: int) -> float:
    """Step ``t``'s LR: linear from base / warmup to base over ``warmup``
    steps, then base (the milestones lie far past any run)."""
    if t >= warmup:
        return base
    return (base / warmup - base) * (1.0 - t / warmup) + base


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) leaf by leaf:
    ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: Sequence[torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


# -- the DARK decode -----------------------------------------------------------

DARK_COND_DET, DARK_COND_STEP = 1e-2, 1.0


def cv2_taps(ksize: int) -> torch.Tensor:
    """``cv2.getGaussianKernel(ksize, 0)`` for ksize > 7: sigma
    0.3 * ((ksize - 1) / 2 - 1) + 0.8, normalized, float64."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) * 0.5
    k = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def dark_decode(maps: torch.Tensor, center, scale, kernel: int = 11):
    """Argmax, classic DARK and the unwarp of ``maps`` ``[B, H, W, K]``
    (heatmap space to image pixels, the bbox scale in units of 200 px),
    the refinement in float64.

    Returns:
        (preds [B, K, 2] image px, maxvals [B, K, 1], well [B, K]: the
        argmax is interior with a positive maximum and the Newton step is
        well posed, |det H| >= DARK_COND_DET and at most DARK_COND_STEP
        heatmap px).
    """
    B, H, W, K = maps.shape
    flat = maps.reshape(B, H * W, K)
    idx = flat.argmax(dim=1)                      # the first maximum
    maxvals = flat.amax(dim=1)[..., None]
    px = (idx % W).double()
    py = (idx // W).double()
    pos = maxvals[..., 0] > 0.0
    px = torch.where(pos, px, torch.full_like(px, -1.0))
    py = torch.where(pos, py, torch.full_like(py, -1.0))

    # blur with zero padding, rescale to each map's maximum, log
    m = maps.double().permute(0, 3, 1, 2).reshape(B * K, 1, H, W)
    taps = cv2_taps(kernel).to(m.device)
    pad = (kernel - 1) // 2
    blurred = F.conv2d(F.pad(m, (pad, pad, pad, pad)),
                       taps.view(1, 1, 1, -1))
    blurred = F.conv2d(blurred, taps.view(1, 1, -1, 1))
    ratio = (m.amax(dim=(2, 3), keepdim=True)
             / blurred.amax(dim=(2, 3), keepdim=True).clamp(min=1e-20))
    logm = torch.log((blurred * ratio).clamp(min=1e-10))
    logm = logm.reshape(B, K, H * W).permute(0, 2, 1)

    ix, iy = px.long(), py.long()
    interior = (ix > 1) & (ix < W - 2) & (iy > 1) & (iy < H - 2)
    ix, iy = ix.clamp(2, W - 3), iy.clamp(2, H - 3)

    def v(dx, dy):
        i = ((iy + dy) * W + (ix + dx))[:, None, :]
        return torch.gather(logm, 1, i)[:, 0, :]

    gx = 0.5 * (v(1, 0) - v(-1, 0))
    gy = 0.5 * (v(0, 1) - v(0, -1))
    dxx = 0.25 * (v(2, 0) - 2.0 * v(0, 0) + v(-2, 0))
    dyy = 0.25 * (v(0, 2) - 2.0 * v(0, 0) + v(0, -2))
    dxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))
    det = dxx * dyy - dxy * dxy
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    off_x = -(dyy * gx - dxy * gy) / safe
    off_y = -(-dxy * gx + dxx * gy) / safe
    moves = (interior & (det != 0.0)).double()
    hx = px + off_x * moves
    hy = py + off_y * moves
    step = torch.hypot(off_x, off_y)
    well = (interior & pos & (det.abs() >= DARK_COND_DET)
            & (step <= DARK_COND_STEP))

    s = scale.double() * 200.0
    c = center.double()
    x_img = hx * (s[:, None, 0] / W) + c[:, None, 0] - s[:, None, 0] * 0.5
    y_img = hy * (s[:, None, 1] / H) + c[:, None, 1] - s[:, None, 1] * 0.5
    preds = torch.stack([x_img, y_img], dim=-1)
    return preds, maxvals.double(), well
