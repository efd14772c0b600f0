"""One output row of Lite-HRNet's cross-resolution fuse in one pass.

Replaces no TPU kernel: the JAX package leaves the fuse to XLA, which fuses
it. The hand-written CUDA C++ kernel ``csrc/fuse_sum_relu.cu`` for Hopper
(``sm_90a``), built with ``nvcc`` at first use and bound through ctypes, was
added because the eager fuse (``models/litehrnet.py`` ``StageModule``) is a
doubling, one nearest upsample and one add per coarser branch, one add per
finer branch and a ReLU, each a full-resolution pass over device memory, and
under CUDA autocast each upsample hands on float32, so most of those passes
are float32.

For terms ``t_0 .. t_{n-1}`` (1 <= n <= 4), each ``[N, C, H / f, W / f]``
with f a power of two (``t_0`` at f = 1), and the dtype each enters the sum
in (``dtypes``: a term stored as bfloat16 enters as float32 where the eager
upsample hands it on as float32) it gives

    s = ((2 t_0 + up(t_1)) + up(t_2)) + ... + up(t_{n-1}),   relu(s)

with ``up`` the nearest-exact upsample to ``(H, W)`` (pixel repeat), bit for
bit as PyTorch's eager ops give them, in the dtype and the memory layout
they give (``t_0``'s): the partial sum is rounded after the doubling and
after each add to the dtype PyTorch's promotion gives that op (bfloat16
while every term so far enters as bfloat16, else float32).

Bound: memory, each term read once at its own resolution and dtype and each
output written once (``perfbench/costs/fuse_sum_relu.py``). ``plan`` takes
terms of C a multiple of 8, each with its channels innermost (channels_last
memory) or, at the output's resolution, its w innermost (NCHW memory), with
16-byte aligned data and strides that keep the vectors aligned, bfloat16 or
float32 stored and entering; it declines (None) everything else.

``fuse_sum_relu`` launches the kernel for CUDA tensors (and raises where
``plan`` declines) and uses the plain version, ``fuse_sum_relu_reference``,
only for CPU tensors. It counts the rows it sums in ``fuse_sum_relu.rows``
(CPU rows too), its launches in ``fuse_sum_relu.launches`` and their shapes
in ``fuse_sum_relu.shapes``: ``((N, C, H, W, the outputs' item size), ((C,
H_j, W_j, item size) of each term), whether s is written)``. The launch
synchronises nothing and allocates only its outputs, on the current stream.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels import _device
from litehandnet_tpu_torch.kernels._device import DTYPES, blocks_for
from litehandnet_tpu_torch.utils.profiling import register_counters

THREADS = 256        # threads per block (csrc kThreads)
BLOCKS_PER_SM = 2    # csrc kBlocksPerSm
MAX_TERMS = 4        # csrc kMaxTerms
VEC = 8              # channels of a work item (csrc kVec)
MAX_SHIFT = 7        # coarsest term: 1 / 2^7 of the output (csrc kMaxShift)

# a term: its shape, element strides, stored dtype and whether its data
# starts on a 16-byte boundary
TermMeta = Tuple[Sequence[int], Sequence[int], torch.dtype, bool]


def layout(strides: Sequence[int]) -> Optional[str]:
    """``"c"`` where the channels of ``[N, C, H, W]`` are innermost, ``"w"``
    where w is, None otherwise."""
    if strides[1] == 1:
        return "c"
    if strides[3] == 1:
        return "w"
    return None


def _dense_both(shape: Sequence[int], strides: Sequence[int]) -> bool:
    """Whether the strides are both NCHW's and NHWC's dense ones (then the
    layout PyTorch gives a sum cannot be read off them)."""
    N, C, H, W = shape
    nchw = (C * H * W, H * W, W, 1)
    nhwc = (H * W * C, 1, W * C, C)
    same = [n == 1 or (s == a and s == b)
            for n, s, a, b in zip(shape, strides, nchw, nhwc)]
    return all(same)


def plan(terms: Sequence[TermMeta], dtypes: Sequence[torch.dtype],
         write_sum: bool, sm_count: int) -> Optional[Dict[str, object]]:
    """The launch of ``csrc/fuse_sum_relu.cu`` for terms of these shapes,
    strides, stored dtypes and alignments entering the sum as ``dtypes``,
    on a card of ``sm_count`` SMs; None where the kernel does not take them.

    The outputs take ``t_0``'s layout (``out_w_inner``) and the dtype the
    sum's promotion gives (``out_dtype``); bit j of ``bf16_steps`` says the
    sum after term j is bfloat16. ``Q`` neighbouring pixels (4, 2 or 1, as
    W and the w-innermost terms' strides allow) times 8 channels make a work
    item; ``grid_x`` blocks of THREADS walk the ``items``.
    """
    n = len(terms)
    if not 1 <= n <= MAX_TERMS or len(dtypes) != n:
        return None
    shape0 = tuple(terms[0][0])
    if len(shape0) != 4:
        return None
    N, C, H, W = shape0
    if min(shape0) < 1 or C % VEC:
        return None
    out_layout = layout(terms[0][1])
    if out_layout is None or _dense_both(shape0, terms[0][1]):
        return None
    step, steps = None, 0
    rows: List[Dict[str, int]] = []
    w_inner_strides = [shape0[3]]
    for j, ((shape, strides, stored, aligned), enters) in enumerate(
            zip(terms, dtypes)):
        if (stored not in DTYPES or enters not in DTYPES or not aligned
                or torch.promote_types(stored, enters) != enters
                or len(shape) != 4 or len(strides) != 4):
            return None
        n_, c_, h, w = shape
        if n_ != N or c_ != C or h < 1 or w < 1 or H % h or W % w:
            return None
        f = H // h
        shift = f.bit_length() - 1
        if f != 1 << shift or W != w * f or shift > MAX_SHIFT:
            return None
        kind = layout(strides)
        sn, sc, sh, sw = strides
        if kind == "c":
            chunk = 16 // stored.itemsize
            if any(s % chunk for size, s in ((N, sn), (h, sh), (w, sw))
                   if size > 1):
                return None
        elif kind == "w" and shift == 0:
            w_inner_strides += [s for size, s in ((N, sn), (C, sc), (h, sh))
                                if size > 1]
        else:
            return None
        step = enters if step is None else torch.promote_types(step, enters)
        steps |= int(step == torch.bfloat16) << j
        rows.append(dict(bf16=DTYPES[stored], w_inner=int(kind == "w"),
                         shift=shift, sn=sn, sc=sc, sh=sh, sw=sw))
    Q = next(q for q in (4, 2, 1) if not any(s % q for s in w_inner_strides))
    items = N * H * (W // Q) * (C // VEC)
    if items >= 1 << 31:
        return None
    blank = dict(bf16=0, w_inner=0, shift=0, sn=0, sc=0, sh=0, sw=0)
    rows += [blank] * (MAX_TERMS - n)
    p: Dict[str, object] = dict(
        N=N, C=C, H=H, W=W, Q=Q, terms=n, out_bf16=DTYPES[step],
        out_w_inner=int(out_layout == "w"), bf16_steps=steps,
        grid_x=blocks_for(-(-items // THREADS), sm_count * BLOCKS_PER_SM),
        items=items, out_dtype=step, write_sum=bool(write_sum))
    for j, row in enumerate(rows):
        for key, value in row.items():
            p[f"t{j}_{key}"] = value
    return p


def _upsample(t: torch.Tensor, H: int) -> torch.Tensor:
    f = H // t.shape[2]
    if f == 1:
        return t
    return t.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def fuse_sum_relu_reference(terms: Sequence[torch.Tensor],
                            dtypes: Optional[Sequence[torch.dtype]] = None,
                            write_sum: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version, the kernel's arithmetic: the partial sum held
    in float32 (float64 where a term enters as float64), rounded after the
    doubling and after each add to the dtype the sum has there, the
    coarser terms repeated to ``t_0``'s size; the outputs in ``t_0``'s
    layout."""
    dtypes = [t.dtype for t in terms] if dtypes is None else list(dtypes)
    wide = torch.promote_types(torch.float32,
                               max(dtypes, key=lambda d: d.itemsize))
    H = terms[0].shape[2]
    step = dtypes[0]
    s = (2 * terms[0].to(wide)).to(step)
    for t, enters in zip(terms[1:], dtypes[1:]):
        step = torch.promote_types(step, enters)
        s = (s.to(wide) + _upsample(t, H).to(wide)).to(step)
    return F.relu(s), (s if write_sum else None)


# The plan as ``lhn_fuse_sum_relu`` reads it: one int64 each, in this order
# (csrc/fuse_sum_relu.cu ``enum Plan`` and ``enum TermPlan``).
PLAN_FIELDS = ("N", "C", "H", "W", "Q", "terms", "out_bf16", "out_w_inner",
               "bf16_steps", "grid_x") + tuple(
    f"t{j}_{key}" for j in range(MAX_TERMS)
    for key in ("bf16", "w_inner", "shift", "sn", "sc", "sh", "sw"))


def _term_meta(t: torch.Tensor) -> TermMeta:
    return (tuple(t.shape), t.stride(), t.dtype, t.data_ptr() % 16 == 0)


def _make(x, dtype, aligned, rest, dtypes, write_sum):
    if not x.is_cuda:
        return None
    return plan([(tuple(x.shape), x.stride(), dtype, aligned), *rest], dtypes,
                write_sum, _device.sm_count(x.device))


_KERNEL = _device.Kernel(
    "fuse_sum_relu", "lhn_fuse_sum_relu", "lhn_fsr_plan_fields", PLAN_FIELDS,
    (_device.PTR,) * 6 + (_device.PLAN, _device.PTR), _make,
    [("lhn_fsr_threads", ctypes.c_int, (), THREADS)])


def launch_plan(terms: Sequence[torch.Tensor], dtypes: Sequence[torch.dtype],
                write_sum: bool = False):
    """The cached plan of these terms (``Kernel.plan``), None where ``plan``
    declines them or they are not on a CUDA card."""
    return _KERNEL.plan(terms[0], tuple(_term_meta(t) for t in terms[1:]),
                        tuple(dtypes), bool(write_sum))


def _check(terms: Sequence[torch.Tensor],
           dtypes: Optional[Sequence[torch.dtype]]) -> List[torch.dtype]:
    """The dtypes the terms enter in; raises ValueError or TypeError for
    what no version takes."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"expected 1 to {MAX_TERMS} terms, got {len(terms)}")
    dtypes = [t.dtype for t in terms] if dtypes is None else list(dtypes)
    if len(dtypes) != len(terms):
        raise ValueError(f"{len(terms)} terms but {len(dtypes)} dtypes")
    if terms[0].dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got {tuple(terms[0].shape)}")
    N, C, H, W = terms[0].shape
    for t, enters in zip(terms, dtypes):
        h = t.shape[2] if t.dim() == 4 else 0
        f = H // h if h else 0
        if (t.dim() != 4 or t.shape[:2] != (N, C) or f < 1 or f & (f - 1)
                or tuple(t.shape[2:]) != (H // f, W // f) or H % f or W % f):
            raise ValueError(f"term {tuple(t.shape)} is not [{N}, {C}, "
                             f"{H}, {W}] over a power of two")
        if not (t.is_floating_point() and enters.is_floating_point
                and torch.promote_types(t.dtype, enters) == enters):
            raise TypeError(f"a {t.dtype} term cannot enter the sum as "
                            f"{enters}")
        if t.device != terms[0].device:
            raise TypeError(f"terms on {t.device} and {terms[0].device}: "
                            "all must be on one device")
    return dtypes


def fuse_sum_relu(terms: Sequence[torch.Tensor],
                  dtypes: Optional[Sequence[torch.dtype]] = None,
                  write_sum: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(relu(s), s)`` for ``s = ((2 t_0 + up(t_1)) + ...) + up(t_{n-1})``.

    Args:
        terms: 1 to 4 tensors ``[N, C, H / f, W / f]``, f a power of two,
            ``t_0`` at f = 1; on CUDA as ``plan`` takes them.
        dtypes: the dtype each term enters the sum in (default its own): a
            bfloat16 term may enter as float32, as an upsample under CUDA
            autocast hands it on.
        write_sum: whether s is returned too (else None in its place).

    Returns:
        relu(s) and s (or None), in the dtype of the sum's type promotion
        and in ``t_0``'s layout.

    Raises:
        ValueError: shapes no version takes, or CUDA terms ``plan``
            declines.
        TypeError: a dtype or device it does not take.
        RuntimeError: the launch failed.
    """
    terms = list(terms)
    dtypes = _check(terms, dtypes)
    fuse_sum_relu.rows += 1
    x = terms[0]
    if x.device.type == "cpu":
        return fuse_sum_relu_reference(terms, dtypes, write_sum)
    planned = launch_plan(terms, dtypes, write_sum)
    if planned is None:
        raise ValueError(
            "fuse_sum_relu does not take terms "
            f"{[(tuple(t.shape), t.stride(), t.dtype) for t in terms]} "
            f"entering as {dtypes} (kernels/fuse_sum_relu.py plan)")
    packed, p = planned
    fmt = (torch.contiguous_format if p["out_w_inner"]
           else torch.channels_last)
    out = torch.empty(x.shape, dtype=p["out_dtype"], device=x.device,
                      memory_format=fmt)
    s = torch.empty_like(out) if write_sum else None
    ptrs = [t.data_ptr() for t in terms] + [None] * (MAX_TERMS - len(terms))
    index = x.get_device()
    _KERNEL.launch(index, *ptrs, out.data_ptr(),
                   None if s is None else s.data_ptr(), packed,
                   _device.current_stream(index))
    fuse_sum_relu.launches += 1
    N, C, H, W = x.shape
    fuse_sum_relu.shapes[(
        (N, C, H, W, out.element_size()),
        tuple((C, t.shape[2], t.shape[3], t.element_size()) for t in terms),
        bool(write_sum))] += 1
    return out, s


fuse_sum_relu.rows = 0
fuse_sum_relu.launches = 0
fuse_sum_relu.shapes = collections.Counter()
register_counters(fuse_sum_relu, "launches", "rows", "shapes")
