"""Fused ViLLayer epilogue of training: [per-head LayerNorm -> + skip * x
-> proj_down], with a CUDA backward.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/epilogue.py``: the forward is
plain PyTorch with the casts of ``epilogue_forward`` there; the backward
is the kernel ``epilogue_bw`` (``csrc/epilogue_bw.cu``), the counterpart
of the Pallas ``_bwd_kernel``.  Its plain version is autograd of the
forward.  Weights use the port's layout: ``wd`` is proj_down's (D, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["LAUNCHES", "epilogue", "epilogue_bwd", "epilogue_bwd_plain", "epilogue_forward"]

LAUNCHES = 0  # calls of epilogue_bwd that launched the kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def epilogue_forward(h, x, ln_w, ln_b, skip, wd, bd, num_heads: int, eps: float = 1e-6):
    """h, x: (B, S, H) in the compute dtype; ln_w, ln_b, skip: (H,);
    wd: (D, H); bd: (D,).  Per-head LayerNorm of h (centered variance,
    scale 1 + ln_w) in float32, cast to the compute dtype, + skip * x,
    then proj_down in the compute dtype."""
    B, S, H = h.shape
    cd = h.dtype
    acc = acc_dtype(cd)
    hf = h.to(acc).reshape(B, S, num_heads, H // num_heads)
    mean = hf.mean(-1, keepdim=True)
    var = (hf - mean).square().mean(-1, keepdim=True)
    y = ((hf - mean) * torch.rsqrt(var + eps)).reshape(B, S, H) * (1.0 + ln_w) + ln_b
    z = y.to(cd) + skip.to(cd) * x
    return F.linear(z, wd.to(cd)) + bd.to(cd)


def epilogue_bwd_plain(h, x, g, ln_w, ln_b, skip, wd, num_heads: int, eps: float = 1e-6):
    """Plain version of the backward: autograd of :func:`epilogue_forward`.
    Returns (dh, dx, dln_w, dln_b, dskip, dwd, dbd)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (h, x, ln_w, ln_b, skip, wd)]
        bd = torch.zeros(wd.shape[0], dtype=wd.dtype, device=wd.device, requires_grad=True)
        out = epilogue_forward(*leaves, bd, num_heads=num_heads, eps=eps)
        return torch.autograd.grad(out, leaves + [bd], g)


def _declare(lib):
    lib.epilogue_bw.argtypes = [P] * 14 + [I] * 7 + [CF, P]
    lib.epilogue_bw.restype = I


def tile_rows(row_floats: int) -> int:
    """R, the rows of a tile of the row kernel (csrc/epilogue_bw.cu),
    whose tile holds ``row_floats`` float32 a row: 32
    where they fit in a block's shared memory, else 16.  Raises if 16 rows
    do not fit either."""
    for rows in (32, 16):
        if 4 * rows * row_floats <= SMEM_LIMIT:
            return rows
    raise ValueError(f"a tile of 16 rows of {row_floats} floats needs more shared memory "
                     "than a block has")


def weight_grad_splits(M: int) -> int:
    """Row ranges of the float32-FMA weight-gradient pass (wgrad_kernel,
    csrc/common.cuh; the epilogue backward, and the FFN backward in
    float32): enough blocks to fill the card, about 1024 rows each, at
    most 32."""
    return min(32, max(1, M // 1024))


def epilogue_bwd(h, x, g, ln_w, ln_b, skip, wd, num_heads: int, eps: float = 1e-6):
    """Backward of :func:`epilogue_forward` for an upstream gradient g
    (B, S, D).  Returns (dh, dx) in h's dtype and (dln_w, dln_b, dskip,
    dwd, dbd) in float32.  The kernel for CUDA tensors (or this raises),
    the plain version for CPU tensors."""
    global LAUNCHES
    if h.device.type == "cpu":
        return epilogue_bwd_plain(h, x, g, ln_w, ln_b, skip, wd, num_heads, eps)
    B, S, H = h.shape
    D = wd.shape[0]
    if h.dtype not in _DTYPE_CODES or x.dtype != h.dtype or g.dtype != h.dtype:
        raise TypeError(f"h, x, g must share a dtype of {list(_DTYPE_CODES)}")
    if x.shape != h.shape or g.shape != (B, S, D) or wd.shape != (D, H) or H % num_heads:
        raise ValueError("shapes: h, x (B, S, H); g (B, S, D); wd (D, H); H % num_heads == 0")
    rows = tile_rows(3 * H + D + num_heads)
    params = [t.detach().float().contiguous() for t in (ln_w, ln_b, skip, wd)]
    cuda_build.check_kernel_inputs(h, x, g, *params)
    lib = cuda_build.load("epilogue_bw", _declare)
    M = B * S
    splits = weight_grad_splits(M)
    dev = h.device
    f32 = dict(dtype=torch.float32, device=dev)
    dh, dx = torch.empty_like(h), torch.empty_like(x)
    dvec = torch.empty(3 * H + D, **f32)  # dln_w, dln_b, dskip, dbd
    dwd = torch.empty(D, H, **f32)
    z = torch.empty(M, H, dtype=h.dtype, device=dev)
    part_vec = torch.empty(-(-M // rows), 3 * H + D, **f32)
    part_w = torch.empty(splits, D, H, **f32)
    with torch.cuda.device(dev):
        cuda_build.launch(
            lib.epilogue_bw, "epilogue_bw",
            *cuda_build.pointers(h, x, g, *params, dh, dx, dvec, dwd, z, part_vec, part_w),
            M, H, D, num_heads, splits, rows, _DTYPE_CODES[h.dtype], float(eps))
    LAUNCHES += 1
    return dh, dx, dvec[:H], dvec[H:2 * H], dvec[2 * H:3 * H], dwd, dvec[3 * H:]


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, ln_w, ln_b, skip, wd, bd, num_heads, eps):
        ctx.save_for_backward(h, x, ln_w, ln_b, skip, wd)
        ctx.num_heads, ctx.eps = num_heads, eps
        return epilogue_forward(h, x, ln_w, ln_b, skip, wd, bd, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        h, x, ln_w, ln_b, skip, wd = ctx.saved_tensors
        dh, dx, dlnw, dlnb, dskip, dwd, dbd = epilogue_bwd(
            h, x, g.contiguous(), ln_w, ln_b, skip, wd, ctx.num_heads, ctx.eps)
        return dh, dx, dlnw, dlnb, dskip, dwd, dbd, None, None


def epilogue(h, x, ln_w, ln_b, skip, wd, bd, num_heads: int, eps: float = 1e-6):
    """:func:`epilogue_forward` whose backward is :func:`epilogue_bwd`."""
    return _Epilogue.apply(h, x, ln_w, ln_b, skip, wd, bd, num_heads, eps)
