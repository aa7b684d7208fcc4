"""YAML-facing blocks of the ViL detectors, NHWC.

Counterpart of the flagship subset of ``xlstm_yolo_tpu/nn/blocks.py``:
``ConvBNAct``, ``upsample_nearest``, ``concat_channels``,
``VitPatchEmbedBlock``, ``VitPosEmbedBlock``, ``ViLBlockPairBlock``,
``SequenceToImage``, ``PatchMerger``, ``LSBlock``, ``RGBlock`` and
``ViLFusionBlock``.  Image tensors are NHWC at every boundary.
"""

from __future__ import annotations

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
    grid_of,
    normal_init,
)
from xlstm_yolo_tpu_torch.ops.backend import V2_KERNEL
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu, None: lambda x: x}


class ConvBNAct(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + activation: the YOLO ``Conv``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: str | None = "silu",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.conv = Conv(c1, c2, k, s, p, g, d, bias=False, compute_dtype=compute_dtype)
        self.bn = BatchNorm(c2, eps=1e-3)
        self.act = _ACTS[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


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
        h, w = grid_of(S, self.seqlens)
        return x.reshape(B, h, w, D)


class PatchMerger(nn.Module):
    """Learned-query token pooling: LayerNorm -> softmax(queries x^T /
    sqrt(dim)) over tokens -> attn @ x.  Products take the input dtype's
    operands and accumulate in float32."""

    def __init__(self, dim: int, num_tokens_out: int):
        super().__init__()
        self.dim = dim
        self.norm = LayerNorm(dim, eps=1e-6)
        self.queries = nn.Parameter(torch.empty(num_tokens_out, dim))

    def init_own_parameters(self, g):
        normal_init(1.0)(self.queries, g)

    def forward(self, x):  # (B, N, D) -> (B, M, D)
        xn = self.norm(x).to(x.dtype)
        acc = acc_dtype(x.dtype)
        q = self.queries.to(x.dtype).to(acc)
        xf = xn.to(acc)
        sim = torch.einsum("md,bnd->bmn", q, xf) * (self.dim ** -0.5)
        attn = torch.softmax(sim, dim=-1)
        return torch.einsum("bmn,bnd->bmd", attn.to(x.dtype).to(acc), xf).to(x.dtype)


class LSBlock(nn.Module):
    """Local spatial block: dw3x3 + BN -> 1x1 + GELU -> 1x1, residual."""

    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        cd = compute_dtype
        self.fc1 = Conv(dim, dim, 3, g=dim, compute_dtype=cd)
        self.norm = BatchNorm(dim, eps=1e-3)
        self.fc2 = Conv(dim, dim, 1, compute_dtype=cd)
        self.fc3 = Conv(dim, dim, 1, compute_dtype=cd)

    def forward(self, x):
        return x + self.fc3(gelu(self.fc2(self.norm(self.fc1(x)))))


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


class ViLFusionBlock(nn.Module):
    """FPN fusion block: 1x1 in_proj + LSBlock + RMSNorm + ViLBlockPair + RGBlock."""

    def __init__(self, c1: int, dim: int, seqlens: Sequence[int], chunk_size: int = 256,
                 qkv_block_size: int = 16, mlp_ratio: float = 4.0, n: int = 1,
                 drop_path: float = 0.0, conv_kind: str = "2d",
                 chunkwise_kernel: str = V2_KERNEL, compute_dtype: torch.dtype | None = None):
        super().__init__()
        cd = compute_dtype
        self.in_proj = None
        if c1 != dim:
            self.in_proj = nn.Sequential(Conv(c1, dim, 1, bias=False, compute_dtype=cd),
                                         BatchNorm(dim, eps=1e-3))
        self.lsblock = LSBlock(dim, cd)
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
