"""The xLSTM language model in PyTorch: causal conv, sLSTM cell and block,
the LM's mLSTM layer and block, the block stack, ``xLSTMLarge`` and greedy
``generate``.

Counterpart of ``xlstm_yolo_tpu/nn/xlstm.py``, with the same defaults and
the JAX parameter tree's names, so ``utils/convert.jax_variables_to_state_dict``
carries JAX's variables over with ``load_state_dict(strict=True)``.  Two
choices differ from JAX's TPU configuration:

- ``sLSTMCell`` runs the sLSTM kernel (``ops/slstm.py``) on CUDA tensors for
  both ``backend`` names (``"scan"`` and ``"pallas"`` are a TPU compile
  choice) and its plain scan on CPU tensors.  The kernel has no backward,
  so on the card the cell runs without gradient (``torch.no_grad`` or
  ``torch.inference_mode``) or raises a ValueError; JAX's ``scan`` backend
  differentiates.
- ``mLSTMLayerLM``'s cell runs the port's v2 kernel name, the same siging
  chunkwise function as JAX's ``chunkwise--native_autograd``, which in the
  port is the plain route.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_yolo_tpu_torch.nn.layers import (
    Dense,
    FeedForward,
    MatrixLSTMCell,
    RMSNorm,
    _cast,
    lecun_normal_init,
    reset_parameters,
    small_init,
    wang_init,
)
from xlstm_yolo_tpu_torch.ops.backend import V2_KERNEL
from xlstm_yolo_tpu_torch.ops.slstm import slstm_sequence
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype, select_device

__all__ = ["CausalConv1d", "generate", "mLSTMBlock", "mLSTMLayerLM", "sLSTMBlock", "sLSTMCell",
           "xLSTMBlockStack", "xLSTMLarge"]

SLSTM_BACKENDS = ("scan", "pallas")


class CausalConv1d(nn.Module):
    """Depthwise causal conv over (B, S, D): left padding of K - 1.  The
    weight is torch's (D, 1, K); JAX's kernel is (K, 1, D)."""

    def __init__(self, dim: int, kernel_size: int = 4, bias: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(dim, 1, kernel_size))
        self.bias = nn.Parameter(torch.empty(dim)) if bias else None

    def init_own_parameters(self, g):
        lecun_normal_init(self.kernel_size)(self.weight, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        D = x.shape[-1]
        xp = F.pad(x.transpose(1, 2), (self.kernel_size - 1, 0))
        y = F.conv1d(xp, _cast(self.weight, x.dtype), groups=D).transpose(1, 2)
        return y if self.bias is None else y + _cast(self.bias, y.dtype)


class sLSTMCell(nn.Module):
    """Scalar LSTM with exponential gating and a per-head recurrence.

    ``forward(x, state=None)``: x (B, S, dim), state (h, c, n, m) each
    (B, NH, DH) float32, zeros by default.  Returns (y (B, S, dim) in x's
    dtype, the last (h, c, n, m)).  ``kernel`` is the scan
    (:func:`~xlstm_yolo_tpu_torch.ops.slstm.slstm_sequence`: the kernel on
    CUDA tensors, the plain scan on CPU tensors) for either ``backend``."""

    def __init__(self, dim: int, num_heads: int = 4, backend: str = "scan"):
        super().__init__()
        if backend not in SLSTM_BACKENDS:
            raise ValueError(f"unknown sLSTM backend {backend!r}; one of {SLSTM_BACKENDS}")
        self.dim, self.num_heads, self.backend = dim, num_heads, backend
        dh = dim // num_heads
        self.wx = Dense(dim, 4 * dim, True, small_init(dim))
        self.recurrent_kernel = nn.Parameter(torch.empty(4, num_heads, dh, dh))
        self.kernel = slstm_sequence

    def init_own_parameters(self, g):
        # flax's orthogonal: orthonormal columns of the (4 NH DH, DH) matrix
        nn.init.orthogonal_(self.recurrent_kernel.view(-1, self.recurrent_kernel.shape[-1]),
                            generator=g)

    def forward(self, x, state=None):
        B, S, D = x.shape
        NH = self.num_heads
        wx = self.wx(x).reshape(B, S, 4, NH, D // NH).to(acc_dtype(x.dtype))
        hs, last = self.kernel(wx, self.recurrent_kernel, state)
        return hs.reshape(B, S, D).to(x.dtype), last


class sLSTMBlock(nn.Module):
    """Pre-norm sLSTM block: RMSNorm -> causal conv -> silu -> sLSTM cell ->
    proj, then a pre-norm gated FFN."""

    def __init__(self, dim: int, num_heads: int = 4, conv_kernel_size: int = 4,
                 ffn_proj_factor: float = 1.3334, training: bool = False):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.conv = CausalConv1d(dim, conv_kernel_size)
        self.cell = sLSTMCell(dim, num_heads)
        self.proj = Dense(dim, dim, True, wang_init(dim, 1))
        self.ffn_norm = RMSNorm(dim)
        self.ffn = FeedForward(dim, ffn_proj_factor)
        self.train(training)

    def forward(self, x):
        y, _ = self.cell(F.silu(self.conv(self.norm(x))))
        x = x + self.proj(y)
        return x + self.ffn(self.ffn_norm(x))


class mLSTMLayerLM(nn.Module):
    """LM mLSTM layer: up-projection -> causal conv + q, k -> mLSTM cell ->
    learnable skip -> gate by silu(z) -> down-projection."""

    def __init__(self, dim: int, expansion: float = 2.0, qkv_block_size: int = 64,
                 conv_kernel_size: int = 4, chunk_size: int = 64, training: bool = False,
                 chunkwise_kernel: str = V2_KERNEL):
        super().__init__()
        inner = int(expansion * dim)
        self.inner, self.num_heads = inner, max(inner // qkv_block_size, 1)
        self.proj_up = Dense(dim, 2 * inner, True, small_init(dim))
        self.conv1d = CausalConv1d(inner, conv_kernel_size)
        self.q_proj = Dense(inner, inner, True, small_init(dim))
        self.k_proj = Dense(inner, inner, True, small_init(dim))
        self.v_proj = Dense(inner, inner, True, small_init(dim))
        self.mlstm_cell = MatrixLSTMCell(inner, self.num_heads, chunk_size=chunk_size,
                                         chunkwise_kernel=chunkwise_kernel)
        self.learnable_skip = nn.Parameter(torch.empty(inner))
        self.proj_down = Dense(inner, dim, True, wang_init(dim, 1))
        self.train(training)

    def init_own_parameters(self, g):
        nn.init.ones_(self.learnable_skip)

    def forward(self, x):
        B, S, _ = x.shape
        x_mlstm, z = self.proj_up(x).split(self.inner, dim=-1)
        x_conv = F.silu(self.conv1d(x_mlstm))
        h = self.mlstm_cell(self.q_proj(x_conv), self.k_proj(x_conv), self.v_proj(x_mlstm))
        if self.mlstm_cell.training:
            # the training cell hands back the raw h for a fused epilogue;
            # this layer has none, so it applies the outnorm itself
            h_raw, _ = h
            NH = self.num_heads
            h = self.mlstm_cell.outnorm(h_raw.reshape(B, S, NH, self.inner // NH))
            h = h.reshape(B, S, self.inner)
        h = h + _cast(self.learnable_skip, h.dtype) * x_conv
        return self.proj_down(h * F.silu(z))


class mLSTMBlock(nn.Module):
    def __init__(self, dim: int, qkv_block_size: int = 64, chunk_size: int = 64,
                 ffn_proj_factor: float = 2.6667, training: bool = False):
        super().__init__()
        self.norm_mlstm = RMSNorm(dim)
        self.mlstm_layer = mLSTMLayerLM(dim, qkv_block_size=qkv_block_size,
                                        chunk_size=chunk_size)
        self.norm_ffn = RMSNorm(dim)
        self.ffn = FeedForward(dim, ffn_proj_factor)
        self.train(training)

    def forward(self, x):
        x = x + self.mlstm_layer(self.norm_mlstm(x))
        return x + self.ffn(self.norm_ffn(x))


class xLSTMBlockStack(nn.Module):
    """A stack of mLSTM blocks with sLSTM blocks at the indices ``slstm_at``,
    then an RMSNorm.  Blocks are the submodules ``block_0``, ``block_1``, ...
    as in the JAX tree."""

    def __init__(self, dim: int, num_blocks: int = 6, slstm_at: Sequence[int] = (),
                 qkv_block_size: int = 64, chunk_size: int = 64, training: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        for bi in range(num_blocks):
            block = (sLSTMBlock(dim) if bi in set(slstm_at)
                     else mLSTMBlock(dim, qkv_block_size=qkv_block_size, chunk_size=chunk_size))
            self.add_module(f"block_{bi}", block)
        self.out_norm = RMSNorm(dim)
        self.train(training)

    def forward(self, x):
        for bi in range(self.num_blocks):
            x = getattr(self, f"block_{bi}")(x)
        return self.out_norm(x)


class xLSTMLarge(nn.Module):
    """Token LM: embedding -> xLSTMBlockStack -> lm_head (no bias).

    Built on ``device``, the GPU unless the caller passes ``device="cpu"``,
    in eval mode (train mode with ``training``), its weights drawn from
    ``generator`` (default: seed 0).  ``forward(tokens)``: (B, S) ints ->
    (B, S, vocab_size) logits.  On the GPU the sLSTM blocks run without
    gradient (see :class:`sLSTMCell`)."""

    def __init__(self, vocab_size: int, dim: int = 512, num_blocks: int = 6,
                 slstm_at: Sequence[int] = (), training: bool = False,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = select_device("cuda" if device is None else device)
        self.vocab_size, self.dim = vocab_size, dim
        self.embedding = nn.Embedding(vocab_size, dim)
        self.backbone = xLSTMBlockStack(dim, num_blocks, slstm_at)
        self.lm_head = Dense(dim, vocab_size, bias=False)
        reset_parameters(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self.to(dev).train(training)

    def init_own_parameters(self, g):
        # flax nn.Embed: variance scaling 1 over fan-in = dim, truncated normal
        lecun_normal_init(self.dim)(self.embedding.weight, g)

    def forward(self, tokens):
        return self.lm_head(self.backbone(self.embedding(tokens)))


def generate(model: xLSTMLarge, prompt, max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy decoding: each new token is the argmax of the last position's
    logits of a forward over the whole prefix (recomputed every token, as
    the JAX package does).  ``prompt`` is (S,) or (B, S) ints; returns the
    (B, S + max_new_tokens) tokens on the model's device."""
    device = next(model.parameters()).device
    tokens = torch.as_tensor(prompt, device=device).long()
    if tokens.ndim == 1:
        tokens = tokens[None]
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            nxt = model(tokens)[:, -1].argmax(-1, keepdim=True)
            tokens = torch.cat([tokens, nxt], dim=1)
    return tokens
