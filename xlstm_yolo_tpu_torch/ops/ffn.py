"""Fused ViLLayer FFN branch of training: [RMSNorm -> gate/z dense ->
silu(gate) * z -> proj_down], with a CUDA backward.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/ffn.py``: the forward is plain
PyTorch with the casts of ``ffn_forward`` there (norm in float32, cast to
x's dtype, dense layers in x's dtype); the backward is the kernel ``ffn_bw``
(``csrc/ffn_bw.cu``), the counterpart of the Pallas ``_bwd_kernel``: a row
pass over 64-row tiles, then the weight gradients over row ranges, the
products on the tensor cores for bfloat16 and on the CUDA cores for
float32.  Its plain version is autograd of the forward.  The Function
saves x and the up-projection gz as residuals, as the JAX VJP does.
Weights use the port's layout: ``wgz`` (2U, D), ``wd`` (D, U).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import I, P
from xlstm_yolo_tpu_torch.ops.epilogue import tc_splits, weight_grad_splits
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["LAUNCHES", "ffn", "ffn_bwd", "ffn_bwd_plain", "ffn_forward"]

LAUNCHES = 0  # calls of ffn_bwd that launched the kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (32, 192, 256, 384)  # the D the kernel takes (every detector's); U a multiple of 32


def ffn_forward(x, wn, wgz, bgz, wd, bd, eps: float = 1e-6):
    """x: (B, S, D); wn: (D,); wgz: (2U, D); bgz: (2U,); wd: (D, U); bd: (D,).
    Returns (out, gz), both in x's dtype."""
    cd = x.dtype
    xf = x.to(acc_dtype(cd))
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xn = ((xf * r) * wn).to(cd)
    gz = F.linear(xn, wgz.to(cd)) + bgz.to(cd)
    gate, z = gz.chunk(2, dim=-1)
    return F.linear(F.silu(gate) * z, wd.to(cd)) + bd.to(cd), gz


def ffn_bwd_plain(x, gz, g, wn, wgz, wd, eps: float = 1e-6):
    """Plain version of the backward: autograd of :func:`ffn_forward`, in
    two pieces joined at the saved gz (so the up-projection's bias is not
    needed).  Returns (dx, dwn, dwgz, dbgz, dwd, dbd)."""
    cd = x.dtype
    with torch.enable_grad():
        gz_, wd_ = gz.detach().requires_grad_(), wd.detach().requires_grad_()
        bd = torch.zeros(wd.shape[0], dtype=wd.dtype, device=wd.device, requires_grad=True)
        gate, z = gz_.chunk(2, dim=-1)
        out = F.linear(F.silu(gate) * z, wd_.to(cd)) + bd.to(cd)
        dgz, dwd, dbd = torch.autograd.grad(out, [gz_, wd_, bd], g)
        x_, wn_, wgz_ = (t.detach().requires_grad_() for t in (x, wn, wgz))
        bgz = torch.zeros(wgz.shape[0], dtype=wgz.dtype, device=wgz.device, requires_grad=True)
        xf = x_.to(acc_dtype(cd))
        xn = ((xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)) * wn_).to(cd)
        up = F.linear(xn, wgz_.to(cd)) + bgz.to(cd)
        dx, dwn, dwgz, dbgz = torch.autograd.grad(up, [x_, wn_, wgz_, bgz], dgz)
    return dx, dwn, dwgz, dbgz, dwd, dbd


def _declare(lib):
    lib.ffn_bw.argtypes = [P] * 15 + [I] * 6 + [CF, P]
    lib.ffn_bw.restype = I


def ffn_bwd(x, gz, g, wn, wgz, wd, eps: float = 1e-6):
    """Backward of :func:`ffn_forward` from the saved x and gz and the
    upstream gradient g (B, S, D).  Returns dx in x's dtype and (dwn, dwgz,
    dbgz, dwd, dbd) in float32.  The kernel for CUDA tensors (or this
    raises), the plain version for CPU tensors."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ffn_bwd_plain(x, gz, g, wn, wgz, wd, eps)
    B, S, D = x.shape
    U = wd.shape[1]
    if x.dtype not in _DTYPE_CODES or gz.dtype != x.dtype or g.dtype != x.dtype:
        raise TypeError(f"x, gz, g must share a dtype of {list(_DTYPE_CODES)}")
    if gz.shape != (B, S, 2 * U) or g.shape != x.shape or wgz.shape != (2 * U, D) \
            or wd.shape != (D, U) or wn.shape != (D,):
        raise ValueError("shapes: x, g (B, S, D); gz (B, S, 2U); wgz (2U, D); wd (D, U)")
    if D not in WIDTHS or U % 32:
        raise ValueError(f"FFN widths D={D}, U={U} not taken by the kernel: D in {WIDTHS}, "
                         "U a multiple of 32")
    # the products' operands in x's dtype, cast once here
    params = [wn.detach().float().contiguous()] + [
        t.detach().to(x.dtype).contiguous() for t in (wgz, wd)]
    cuda_build.check_kernel_inputs(x, gz, g, *params)
    lib = cuda_build.load("ffn_bw", _declare)
    M = B * S
    if x.dtype == torch.bfloat16:
        splits, splits_gz = tc_splits(M, D, U), tc_splits(M, 2 * U, D)
    else:
        splits = splits_gz = weight_grad_splits(M)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dvec = torch.empty(2 * D + 2 * U, **f32)  # dwn, dbd, dbgz
    dwgz = torch.empty(2 * U, D, **f32)
    dwd = torch.empty(D, U, **f32)
    xn = torch.empty(M, D, dtype=x.dtype, device=dev)
    act = torch.empty(M, U, dtype=x.dtype, device=dev)
    dgz = torch.empty(M, 2 * U, dtype=x.dtype, device=dev)
    part_vec = torch.empty(-(-M // 64), 2 * D + 2 * U, **f32)  # per 64-row tile
    part_w = torch.empty(max(splits * D * U, splits_gz * 2 * U * D), **f32)
    with torch.cuda.device(dev):
        cuda_build.launch(
            lib.ffn_bw, "ffn_bw",
            *cuda_build.pointers(x, gz, g, *params, dx, dvec, dwgz, dwd, xn, act, dgz,
                                 part_vec, part_w),
            M, D, U, splits, splits_gz, _DTYPE_CODES[x.dtype], float(eps))
    LAUNCHES += 1
    return dx, dvec[:D], dwgz, dvec[2 * D:], dwd, dvec[D:2 * D]


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wn, wgz, bgz, wd, bd, eps):
        out, gz = ffn_forward(x, wn, wgz, bgz, wd, bd, eps)
        ctx.save_for_backward(x, gz, wn, wgz, wd)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, gz, wn, wgz, wd = ctx.saved_tensors
        dx, dwn, dwgz, dbgz, dwd, dbd = ffn_bwd(x, gz, g.contiguous(), wn, wgz, wd, ctx.eps)
        return dx, dwn, dwgz, dbgz, dwd, dbd, None


def ffn(x, wn, wgz, bgz, wd, bd, eps: float = 1e-6):
    """:func:`ffn_forward`'s output, whose backward is :func:`ffn_bwd`."""
    return _FFN.apply(x, wn, wgz, bgz, wd, bd, eps)
