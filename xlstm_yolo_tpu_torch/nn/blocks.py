"""YAML-facing blocks of the ViL detectors, NHWC.

Counterpart of the flagship subset of ``xlstm_yolo_tpu/nn/blocks.py``:
``ConvBNAct``, ``upsample_nearest``, ``concat_channels``,
``VitPatchEmbedBlock``, ``VitPosEmbedBlock``, ``ViLBlockPairBlock``,
``SequenceToImage``, ``PatchMerger``, ``LSBlock``, ``RGBlock`` and
``ViLFusionBlock``.  Image tensors are NHWC at every boundary.

``fused=True`` (``ConvBNAct``, ``LSBlock``, ``ViLFusionBlock``'s
``in_proj``) builds the eval-only form whose convs carry the BatchNorm
folded into a bias (:mod:`xlstm_yolo_tpu_torch.utils.fuse`): the
BatchNorm is gone, and training such a module raises, as JAX asserts.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_yolo_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    LayerNorm,
    RMSNorm,
    ViLBlockPair,
    VitPatchEmbed,
    VitPosEmbed2d,
    normal_init,
    resolve_seqlens,
)
from xlstm_yolo_tpu_torch.ops.backend import V2_KERNEL
from xlstm_yolo_tpu_torch.utils.resize import resize
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu, None: lambda x: x}


class _EvalOnly(nn.Module):
    """A module built with ``fused=True`` (its ``fused`` attribute) runs in
    eval mode only."""

    def train(self, mode: bool = True):
        if mode and self.fused:
            raise ValueError(f"{type(self).__name__}(fused=True) is eval-only")
        return super().train(mode)


class ConvBNAct(_EvalOnly):
    """Conv (no bias) + BatchNorm (eps 1e-3) + activation: the YOLO ``Conv``.
    ``fused``: the conv has a bias and there is no BatchNorm."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: str | None = "silu",
                 compute_dtype: torch.dtype | None = None, fused: bool = False):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.fused = fused
        self.conv = Conv(c1, c2, k, s, p, g, d, bias=fused, compute_dtype=compute_dtype)
        self.bn = None if fused else BatchNorm(c2, eps=1e-3)
        self.act = _ACTS[act]

    def forward(self, x):
        y = self.conv(x)
        return self.act(y if self.bn is None else self.bn(y))


def upsample_nearest(x, scale: int = 2):
    """NHWC nearest-neighbour upsample."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(xs), dim=-1)


class Upsample(nn.Module):
    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_nearest(x, self.scale)


class Concat(nn.Module):
    def forward(self, xs):
        return concat_channels(xs)


class VitPatchEmbedBlock(nn.Module):
    """Patch embedding; keeps the (B, h, w, dim) grid for the pos-embed block."""

    def __init__(self, c1: int, dim: int, patch_size: Sequence[int],
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.module = VitPatchEmbed(dim, tuple(patch_size), c1, compute_dtype)

    def forward(self, x):
        return self.module(x)


class VitPosEmbedBlock(nn.Module):
    """Adds the learned positions and flattens to (B, S, dim)."""

    def __init__(self, dim: int, seqlens: Sequence[int]):
        super().__init__()
        self.dim = dim
        self.module = VitPosEmbed2d(tuple(seqlens), dim)

    def forward(self, x):
        y = self.module(x)
        return y.reshape(y.shape[0], -1, self.dim)


class ViLBlockPairBlock(nn.Module):
    def __init__(self, dim: int, seqlens: Sequence[int], chunk_size: int = 256,
                 qkv_block_size: int = 16, conv_kind: str = "2d", conv_kernel_size: int = 3,
                 proj_bias: bool = True, norm_bias: bool = True, drop_path: float = 0.0,
                 num_blocks: int = 1, chunkwise_kernel: str = V2_KERNEL,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.module = ViLBlockPair(
            dim, drop_path=drop_path, conv_kind=conv_kind,
            conv_kernel_size=conv_kernel_size, proj_bias=proj_bias, norm_bias=norm_bias,
            seqlens=tuple(seqlens), num_blocks=num_blocks, chunk_size=chunk_size,
            qkv_block_size=qkv_block_size, chunkwise_kernel=chunkwise_kernel,
            compute_dtype=compute_dtype)

    def forward(self, x):
        if x.ndim == 4:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        return self.module(x)


class SequenceToImage(nn.Module):
    """(B, S, D) -> (B, h, w, D)."""

    def __init__(self, seqlens: Sequence[int]):
        super().__init__()
        self.seqlens = tuple(seqlens)

    def forward(self, x):
        B, S, D = x.shape
        h, w = resolve_seqlens(S, self.seqlens)
        return x.reshape(B, h, w, D)


def merged_tokens(n_in: int, num_tokens_out: int, base_tokens_in: int | None) -> int:
    """The PatchMerger's output count for ``n_in`` input tokens: M at the
    base count (or without one), else ``round(M * n_in / base)``, which with
    M must be a square (JAX's assertion, raised as a ValueError)."""
    if not base_tokens_in or n_in == base_tokens_in:
        return num_tokens_out
    m_new = int(round(num_tokens_out * n_in / base_tokens_in))
    g0, g1 = int(round(math.sqrt(num_tokens_out))), int(round(math.sqrt(m_new)))
    if g0 * g0 != num_tokens_out or g1 * g1 != m_new:
        raise ValueError(f"PatchMerger multi-scale needs square query grids: "
                         f"M={num_tokens_out}, scaled M'={m_new}")
    return m_new


class PatchMerger(nn.Module):
    """Learned-query token pooling: LayerNorm -> softmax(queries x^T /
    sqrt(dim)) over tokens -> attn @ x.  Products take the input dtype's
    operands and accumulate in float32.  With ``base_tokens_in`` (the YAML
    input's token count) another input count N takes the float32 queries as
    their square grid resized bicubically to ``merged_tokens`` queries, so
    the pooling ratio, and every grid after it, scales with the input."""

    def __init__(self, dim: int, num_tokens_out: int, base_tokens_in: int | None = None):
        super().__init__()
        self.dim, self.base_tokens_in = dim, base_tokens_in
        self.norm = LayerNorm(dim, eps=1e-6)
        self.queries = nn.Parameter(torch.empty(num_tokens_out, dim))

    def init_own_parameters(self, g):
        normal_init(1.0)(self.queries, g)

    def forward(self, x):  # (B, N, D) -> (B, M', D)
        xn = self.norm(x).to(x.dtype)
        acc = acc_dtype(x.dtype)
        queries = self.queries
        m, dim = queries.shape
        m_new = merged_tokens(x.shape[1], m, self.base_tokens_in)
        if m_new != m:
            g0, g1 = math.isqrt(m), math.isqrt(m_new)
            queries = resize(queries.reshape(g0, g0, dim), (g1, g1, dim),
                             "bicubic").reshape(m_new, dim)
        q = queries.to(x.dtype).to(acc)
        xf = xn.to(acc)
        sim = torch.einsum("md,bnd->bmn", q, xf) * (self.dim ** -0.5)
        attn = torch.softmax(sim, dim=-1)
        return torch.einsum("bmn,bnd->bmd", attn.to(x.dtype).to(acc), xf).to(x.dtype)


class LSBlock(_EvalOnly):
    """Local spatial block: dw3x3 + BN -> 1x1 + GELU -> 1x1, residual.
    ``fused``: fc1's bias carries the BatchNorm, which is gone."""

    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None,
                 fused: bool = False):
        super().__init__()
        cd = compute_dtype
        self.fused = fused
        self.fc1 = Conv(dim, dim, 3, g=dim, compute_dtype=cd)
        self.norm = None if fused else BatchNorm(dim, eps=1e-3)
        self.fc2 = Conv(dim, dim, 1, compute_dtype=cd)
        self.fc3 = Conv(dim, dim, 1, compute_dtype=cd)

    def forward(self, x):
        y = self.fc1(x)
        if self.norm is not None:
            y = self.norm(y)
        return x + self.fc3(gelu(self.fc2(y)))


class RGBlock(nn.Module):
    """Gated conv MLP: 1x1 -> (a, v); gelu(dw3x3(a) + a) * v -> 1x1."""

    def __init__(self, dim: int, hidden_dim: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        cd = compute_dtype
        self.local = int(2 * hidden_dim / 3)
        self.fc1 = Conv(dim, 2 * self.local, 1, compute_dtype=cd)
        self.dwconv = Conv(self.local, self.local, 3, g=self.local, compute_dtype=cd)
        self.fc2 = Conv(self.local, dim, 1, compute_dtype=cd)

    def forward(self, x):
        a, v = self.fc1(x).split(self.local, dim=-1)
        return self.fc2(gelu(self.dwconv(a) + a) * v)


class ViLFusionBlock(_EvalOnly):
    """FPN fusion block: 1x1 in_proj + LSBlock + RMSNorm + ViLBlockPair + RGBlock.
    ``fused``: in_proj's conv and the LSBlock's fc1 carry their BatchNorms."""

    def __init__(self, c1: int, dim: int, seqlens: Sequence[int], chunk_size: int = 256,
                 qkv_block_size: int = 16, mlp_ratio: float = 4.0, n: int = 1,
                 drop_path: float = 0.0, conv_kind: str = "2d",
                 chunkwise_kernel: str = V2_KERNEL, compute_dtype: torch.dtype | None = None,
                 fused: bool = False):
        super().__init__()
        cd = compute_dtype
        self.fused = fused
        self.in_proj = None
        if c1 != dim:
            conv = Conv(c1, dim, 1, bias=fused, compute_dtype=cd)
            self.in_proj = nn.Sequential(conv) if fused else nn.Sequential(
                conv, BatchNorm(dim, eps=1e-3))
        self.lsblock = LSBlock(dim, cd, fused)
        self.norm = RMSNorm(dim, eps=1e-3)
        self.vil = nn.ModuleList(
            ViLBlockPairBlock(dim, seqlens, chunk_size, qkv_block_size, conv_kind,
                              drop_path=drop_path, chunkwise_kernel=chunkwise_kernel,
                              compute_dtype=cd)
            for _ in range(n))
        self.mlp = None
        if mlp_ratio > 0:
            self.norm2 = RMSNorm(dim, eps=1e-6)
            self.mlp = RGBlock(dim, int(dim * mlp_ratio), cd)

    def forward(self, x):
        if self.in_proj is not None:
            x = F.silu(self.in_proj(x))
        x_local = self.lsblock(x)
        B, H, W, C = x_local.shape
        seq = x_local.reshape(B, H * W, C)
        y = self.norm(seq)
        for block in self.vil:
            y = block(y)
        x = x + (seq + y).reshape(B, H, W, C)
        if self.mlp is not None:
            xn = self.norm2(x.reshape(B, H * W, C)).reshape(B, H, W, C)
            x = x + self.mlp(xn)
        return x
