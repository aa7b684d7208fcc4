"""Image resize with the JAX package's numbers: ``jax.image.resize``.

The port's own copy of the formulation of ``jax.image.resize(x, shape,
method, antialias=True, precision=HIGHEST)`` for the three methods the
detectors use: ``"bicubic"`` (the pos-embed and PatchMerger query grids at
another input size), ``"bilinear"`` (the train step's multi-scale
batch) and ``"nearest"`` (that batch's segment masks).  Only the axes
whose size changes are resized; ``"nearest"`` gathers rows.  For the
other two each such axis gets an (in, out) weight matrix, built as JAX's
``compute_weight_mat`` builds it:

- the Keys cubic kernel with a = -0.5, or the triangle kernel;
- ``kernel_scale = max(in / out, 1)``: when downsampling the kernel
  widens, so the resize low-pass filters (antialiasing);
- output j samples the input at ``(j + 0.5) * in / out - 0.5``;
- each output's weights are normalised to sum to 1, and set to 0 where that
  sum is at most 1000 * eps(float32);
- weights are zeroed where the sample falls outside ``[-0.5, in - 0.5]``.

The weights are computed in float32, as JAX computes them, cast to the
input's dtype, and contracted one axis at a time with ``torch.tensordot``
(float32 products on the card need TF32 off, PyTorch's default for
``matmul``).  The matrices are cached per (in, out, method, device).
Autograd's gradient is the transposed contraction, as JAX's autodiff gives,
and it is deterministic on the card.

Why not ``F.interpolate``: its ``mode="bicubic"`` (a = -0.75) and
``"bilinear"`` with the default ``antialias=False`` sample the input without
widening the kernel when downsampling.  On 16-channel maps at grids 40->32,
40->48, 80->64, 80->96 and 10->8 the bicubic one differs from
``jax.image.resize(..., "bicubic")`` by 0.35-1.64 and the bilinear one by up
to 1.34 when downsampling.  With ``antialias=True`` both agree with JAX to
about 1.7e-6, but its backward on the card is not promised to be
deterministic, which ``resume`` relies on.  This module calls no
``F.interpolate``.
"""

from __future__ import annotations

import functools

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic,
            "bilinear": _triangle, "linear": _triangle}


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)  # a cached matrix serves predict and autograd alike
def weight_matrix(n_in: int, n_out: int, method: str, device: str = "cpu") -> torch.Tensor:
    """The (n_in, n_out) float32 matrix that resizes one axis from ``n_in``
    to ``n_out`` samples (JAX ``compute_weight_mat`` with antialiasing)."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {sorted(_KERNELS)}")
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def nearest_indices(n_in: int, n_out: int, device="cpu") -> torch.Tensor:
    """The input index of each output of JAX's ``"nearest"`` resize:
    ``floor((j + 0.5) * in / out)``, each operation in float32 as JAX's
    (``F.interpolate``'s ``"nearest"`` samples at ``floor(j * in / out)``)."""
    j = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((j + 0.5) * n_in / n_out).long()


def resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialias on): ``x`` resized to
    ``shape`` along every axis whose size differs; ``"nearest"`` gathers at
    :func:`nearest_indices` and keeps the dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one size per axis of {tuple(x.shape)}")
    if method == "nearest":
        for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
            if n_in != n_out:
                x = x.index_select(d, nearest_indices(n_in, n_out, x.device))
        return x
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, method, str(x.device)).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
