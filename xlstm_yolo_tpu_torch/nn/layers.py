"""Vision-LSTM core modules in PyTorch.

Counterpart of ``xlstm_yolo_tpu/nn/layers.py``.  Conventions kept from the
JAX package so the two can be held against each other:

- images are NHWC, sequences (B, S, D);
- parameter names and shapes follow the JAX tree as translated by
  :mod:`xlstm_yolo_tpu_torch.utils.convert` (dense weights (out, in),
  conv weights OIHW), so ``load_state_dict(strict=True)`` takes weights
  carried over from the JAX package;
- ``compute_dtype`` plays the role of flax's ``dtype``: matmul and conv
  operands are cast to it (parameters stay float32), norms and gates
  compute in float32 (float64 in a float64 model, the reference forward)
  and return the input dtype;
- initializers follow the JAX package's schemes and draw from an explicit
  ``torch.Generator`` (``reset_parameters(g)``).

In training (``module.train()``) the ViL layers run the training path of
the JAX package's TPU configuration at every S: the mLSTM cell through the
train forward and backward kernels of its route (the max(|.|, 1)
denominator held constant in the gradient), the fused epilogue and FFN
branches, BatchNorm on batch statistics, and activation checkpointing of
long block pairs.  ``chunkwise_kernel`` picks the cell's route (see
:class:`MatrixLSTMCell`); the parameters do not depend on it.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from xlstm_yolo_tpu_torch.ops.backend import (
    V2_KERNEL,
    get_mlstm_kernel,
    make_backend,
    mLSTMBackendConfig,
)
from xlstm_yolo_tpu_torch.ops.chunkwise_v2 import (
    mlstm_siging_chunkwise_fw,
    mlstm_siging_chunkwise_fw_ln,
    mlstm_siging_chunkwise_train,
)
from xlstm_yolo_tpu_torch.ops.epilogue import epilogue
from xlstm_yolo_tpu_torch.ops.ffn import ffn
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

FORWARD = "rowwise_from_top_left"
BACKWARD = "rowwise_from_bot_right"

Init = Callable[[torch.Tensor, torch.Generator], None]


# ---------------------------------------------------------------------------
# initializers (the JAX package's schemes, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def normal_init(std: float) -> Init:
    def init(w, g):
        nn.init.normal_(w, 0.0, std, generator=g)
    return init


def trunc_normal_init(std: float) -> Init:
    """flax ``truncated_normal(stddev)``: N(0, 1) cut at +-2, times std."""
    def init(w, g):
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        w.mul_(std)
    return init


def lecun_normal_init(fan_in: int) -> Init:
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return trunc_normal_init(std)


def small_init(dim: int) -> Init:
    """Normal(0, sqrt(2/(5*dim))) ('Transformers without Tears')."""
    return normal_init(math.sqrt(2.0 / (5.0 * dim)))


def wang_init(dim: int, num_blocks: int) -> Init:
    return normal_init(2.0 / max(num_blocks, 1) / math.sqrt(dim))


def const_init(value: float) -> Init:
    def init(w, g):
        nn.init.constant_(w, value)
    return init


zeros_init = const_init(0.0)


def xavier_uniform_flat_init(fan_in: int, fan_out: int) -> Init:
    """Xavier-uniform on the flattened (out, in*kh*kw) view of a conv."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))

    def init(w, g):
        nn.init.uniform_(w, -limit, limit, generator=g)
    return init


def ifgate_bias_init(num_heads: int) -> Init:
    """i = -10 for every head, f = linspace(3, 6) across heads."""
    def init(w, g):
        w[:num_heads] = -10.0
        w[num_heads:] = torch.linspace(3.0, 6.0, num_heads)
    return init


def reset_parameters(module: nn.Module, g: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``g``, in module order."""
    with torch.no_grad():
        for m in module.modules():
            own = getattr(m, "init_own_parameters", None)
            if own is not None:
                own(g)


# ---------------------------------------------------------------------------
# parametric primitives
# ---------------------------------------------------------------------------


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Dense(nn.Module):
    """``y = x W^T + b`` with W (out, in); operands cast to the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 kernel_init: Init | None = None, bias_init: Init = zeros_init,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.kernel_init = kernel_init or lecun_normal_init(in_features)
        self.bias_init = bias_init
        self.compute_dtype = compute_dtype

    def init_own_parameters(self, g):
        self.kernel_init(self.weight, g)
        if self.bias is not None:
            self.bias_init(self.bias, g)

    def forward(self, x):
        cd = self.compute_dtype or x.dtype
        return F.linear(_cast(x, cd), _cast(self.weight, cd), _cast(self.bias, cd))


class Conv(nn.Module):
    """2d convolution on NHWC tensors, OIHW weight, 'same'-style padding."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, bias: bool = True, bias_init: Init = zeros_init,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1 // g, k, k))
        self.bias = nn.Parameter(torch.empty(c2)) if bias else None
        self.stride, self.groups, self.dilation = s, g, d
        keff = d * (k - 1) + 1
        self.padding = keff // 2 if p is None else p
        self.kernel_init = lecun_normal_init(c1 // g * k * k)
        self.bias_init = bias_init
        self.compute_dtype = compute_dtype

    def init_own_parameters(self, g):
        self.kernel_init(self.weight, g)
        if self.bias is not None:
            self.bias_init(self.bias, g)

    def forward(self, x):  # (B, H, W, C)
        cd = self.compute_dtype or x.dtype
        y = F.conv2d(_cast(x, cd).permute(0, 3, 1, 2), _cast(self.weight, cd),
                     _cast(self.bias, cd), self.stride, self.padding, self.dilation,
                     self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, float32 math: flax
    ``nn.BatchNorm(momentum=0.97)``.

    In training it normalises with the batch mean and the *biased*
    variance in flax's fast form max(E[x^2] - E[x]^2, 0), and moves the
    running statistics toward those same values (torch's ``batch_norm``
    would move the variance toward the unbiased one).
    """

    MOMENTUM = 0.97  # flax's: running = 0.97 running + 0.03 batch statistic

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def init_own_parameters(self, g):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        xf = x.to(acc_dtype(x.dtype))
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            return ((xf - self.running_mean) * scale + self.bias).to(x.dtype)
        dims = tuple(range(x.ndim - 1))
        mean = xf.mean(dims)
        var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, use_weight: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim)) if use_weight else None

    def init_own_parameters(self, g):
        if self.weight is not None:
            nn.init.ones_(self.weight)

    def forward(self, x):
        xf = x.to(acc_dtype(x.dtype))
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y.to(x.dtype)


class MultiHeadLayerNorm(nn.Module):
    """Per-head LayerNorm over (B, S, NH, DH): centered variance over DH,
    scale (1 + w), optional bias; parameters are (NH*DH,)."""

    def __init__(self, num_heads: int, head_dim: int, eps: float = 1e-6,
                 use_weight: bool = True, use_bias: bool = True):
        super().__init__()
        self.num_heads, self.head_dim, self.eps = num_heads, head_dim, eps
        n = num_heads * head_dim
        self.weight = nn.Parameter(torch.empty(n)) if use_weight else None
        self.bias = nn.Parameter(torch.empty(n)) if use_bias else None

    def init_own_parameters(self, g):
        for p in (self.weight, self.bias):
            if p is not None:
                nn.init.zeros_(p)

    def forward(self, x):  # (B, S, NH, DH)
        xf = x.to(acc_dtype(x.dtype))
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        shape = (self.num_heads, self.head_dim)
        if self.weight is not None:
            y = y * (1.0 + self.weight).reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, variance as E[x^2] - E[x]^2."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_own_parameters(self, g):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        xf = x.to(acc_dtype(x.dtype))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class DropPath(nn.Module):
    """Per-sample stochastic depth: ``x + mask * branch / keep`` in training,
    ``x + branch`` at inference.  The mask is drawn on the CPU from
    ``self.generator``, an explicit ``torch.Generator`` that the train step
    sets (:func:`set_droppath_generator`); torch and JAX draw different
    masks from one seed."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob
        self.generator: torch.Generator | None = None

    def forward(self, x, branch):
        if not self.training or self.drop_prob == 0.0:
            return x + branch
        if self.generator is None:
            raise RuntimeError("DropPath in training needs a generator (set_droppath_generator)")
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = (torch.rand(shape, generator=self.generator) < keep).to(x.device, x.dtype)
        return x + branch * (mask / keep)


def set_droppath_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Give every DropPath of ``model`` the generator its masks come from."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator


# ---------------------------------------------------------------------------
# sequence conv / patch + pos embed
# ---------------------------------------------------------------------------


def grid_of(S: int, seqlens: Sequence[int] | None) -> tuple[int, int]:
    """(h, w) token grid of a length-S sequence (base resolution only)."""
    if seqlens is None:
        h = int(round(math.sqrt(S)))
        if h * h != S:
            raise ValueError(f"S={S} is not square; pass seqlens")
        return h, h
    h, w = int(seqlens[0]), int(seqlens[1])
    if h * w != S:
        raise ValueError(f"sequence length {S} does not match grid {h}x{w} "
                         "(multi-scale inputs are not ported yet)")
    return h, w


class SequenceConv2d(nn.Module):
    """(B, S, D) -> depthwise k x k conv on the (h, w) grid -> (B, S, D)."""

    def __init__(self, dim: int, kernel_size: int = 3, seqlens: Sequence[int] | None = None,
                 bias: bool = True, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.seqlens = seqlens
        self.weight = nn.Parameter(torch.empty(dim, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(dim)) if bias else None
        self.padding = kernel_size // 2
        self.compute_dtype = compute_dtype

    def init_own_parameters(self, g):
        lecun_normal_init(self.weight[0].numel())(self.weight, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        B, S, D = x.shape
        h, w = grid_of(S, self.seqlens)
        cd = self.compute_dtype or x.dtype
        xi = _cast(x, cd).reshape(B, h, w, D).permute(0, 3, 1, 2)
        y = F.conv2d(xi, _cast(self.weight, cd), _cast(self.bias, cd),
                     padding=self.padding, groups=D)
        return y.permute(0, 2, 3, 1).reshape(B, S, D)


class _PatchProj(nn.Module):
    """Conv-shaped (dim, C, ph, pw) weight applied as a patch matmul."""

    def __init__(self, dim: int, patch_size: tuple[int, int], in_ch: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        ph, pw = patch_size
        self.weight = nn.Parameter(torch.empty(dim, in_ch, ph, pw))
        self.bias = nn.Parameter(torch.empty(dim))
        self.compute_dtype = compute_dtype

    def init_own_parameters(self, g):
        dim, c, ph, pw = self.weight.shape
        xavier_uniform_flat_init(c * ph * pw, dim)(self.weight, g)
        nn.init.zeros_(self.bias)

    def forward(self, xp):  # (B, h, w, ph*pw*C), patch vector ordered (ph, pw, C)
        cd = self.compute_dtype or xp.dtype
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(_cast(xp, cd), _cast(w, cd), _cast(self.bias, cd))


class VitPatchEmbed(nn.Module):
    """Non-overlapping patch embedding: (B, H, W, C) -> (B, H/ph, W/pw, dim)."""

    def __init__(self, dim: int, patch_size: Sequence[int] = (8, 8), in_ch: int = 3,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = _PatchProj(dim, self.patch_size, in_ch, compute_dtype)

    def forward(self, x):
        ph, pw = self.patch_size
        B, H, W, C = x.shape
        if H % ph or W % pw:
            raise ValueError(f"input {tuple(x.shape)} not divisible by patch {self.patch_size}")
        xp = x.reshape(B, H // ph, ph, W // pw, pw, C).permute(0, 1, 3, 2, 4, 5)
        return self.proj(xp.reshape(B, H // ph, W // pw, ph * pw * C))


class VitPosEmbed2d(nn.Module):
    """Learnable 2d positional embedding (1, h, w, dim), trunc-normal 0.02."""

    def __init__(self, seqlens: Sequence[int], dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(1, *seqlens, dim))

    def init_own_parameters(self, g):
        trunc_normal_init(0.02)(self.embed, g)

    def forward(self, x):  # (B, h, w, D)
        if x.shape[1:3] != self.embed.shape[1:3]:
            raise ValueError(f"grid {tuple(x.shape[1:3])} != {tuple(self.embed.shape[1:3])} "
                             "(pos-embed resize is not ported yet)")
        return x + self.embed.to(x.dtype)


# ---------------------------------------------------------------------------
# FeedForward
# ---------------------------------------------------------------------------


def ffn_up_dim(dim: int, proj_factor: float, round_up_to: int) -> int:
    # float floor-div round-up, as the reference writes it: 512 at dim 192
    return int(((dim * proj_factor + round_up_to - 1) // round_up_to) * round_up_to)


class FeedForward(nn.Module):
    """Fused SwiGLU-style FFN: silu(gate) * z -> down."""

    def __init__(self, dim: int, proj_factor: float = 2.6667, round_up_to: int = 64,
                 bias: bool = True, num_blocks: int = 1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.up = ffn_up_dim(dim, proj_factor, round_up_to)
        self.proj_up_gate_z = Dense(dim, 2 * self.up, bias, small_init(dim),
                                    compute_dtype=compute_dtype)
        self.proj_down = Dense(self.up, dim, bias, wang_init(dim, num_blocks),
                               compute_dtype=compute_dtype)

    def forward(self, x):
        gate, z = self.proj_up_gate_z(x).split(self.up, dim=-1)
        return self.proj_down(F.silu(gate) * z)


# ---------------------------------------------------------------------------
# MatrixLSTMCell / ViLLayer / ViLBlock / ViLBlockPair
# ---------------------------------------------------------------------------


def soft_cap(x, cap: float):
    """cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


class MatrixLSTMCell(nn.Module):
    """Gate projection + chunkwise mLSTM + per-head out-norm.

    The ifgate Dense maps concat(q, k, v) to 2*NH gate pre-activations
    (float32, soft-capped), the chunkwise kernel runs the recurrence, and a
    MultiHeadLayerNorm normalises each head.  ``chunkwise_kernel`` picks
    the route:

    - the v2 name (what ``"auto"`` resolves to): the v2 kernels on the
      (B, S, H) streams at every S, ``kernel`` in inference (the inference
      kernel's wrapper) and ``train_kernel`` in training (the
      differentiable cell); ``chunk_size`` and ``mode`` do not apply;
    - any other registry name: the JAX package's registry route. Heads
      are split to (B, NH, S, DH), the gates moved to (B, NH, S), and
      :func:`make_backend` runs the kernel in ``mode`` (default
      ``train_with_padding`` in training, ``inference`` in eval) at the
      layer's ``chunk_size``, zero-padding to whole chunks for the v1
      kernels, whose chunk is part of their function.

    In training the cell returns the raw h (B, S, H) in q's dtype and the
    outnorm's (weight, bias), which the layer's fused epilogue applies (the
    JAX package's ``defer_outnorm``): on both routes, at every S, the
    port keeps the fused epilogue, the same function as the JAX v1 route's
    unfused [outnorm -> + skip * x -> proj_down].

    ``fuse_outnorm`` (off by default; no config sets it), as in JAX: in
    eval mode on the v2 name the outnorm is fused into the inference
    kernel (``mlstm_siging_chunkwise_fw_ln`` with 1 + weight and bias), so
    the LayerNorm normalises the float32 h before its rounding; with a
    ``state`` that holds at every S > 1, where the v2 kernel runs.  In
    training it changes nothing.

    With a ``state`` (C (B, NH, DH, DH), n (B, NH, DH), float32) the cell
    runs in inference mode only and returns (h, (C, n)) after the S tokens,
    as the JAX cell does.  The v2 name runs the v2 inference kernel from
    the state at every S > 1 (JAX switches to its kernel only at S >= 1024,
    a cut-over measured on a TPU, and runs ``chunkwise--native_autograd``
    below it: in float32 the same function).  S = 1 on the v2 name, and
    every S on the other routes, goes through the inference wrapper of
    :func:`make_backend`: S = 1 is one call of ``step_kernel`` (the decode
    path), and the rest goes through ``chunkwise_kernel`` and
    ``sequence_kernel``.
    """

    def __init__(self, dim: int, num_heads: int, gate_soft_cap: float = 15.0,
                 norm_bias: bool = True, eps: float = 5e-5,
                 compute_dtype: torch.dtype | None = None, chunk_size: int = 64,
                 mode: str | None = None, chunkwise_kernel: str = V2_KERNEL,
                 sequence_kernel: str = "sequence--native", step_kernel: str = "step--native",
                 fuse_outnorm: bool = False):
        super().__init__()
        self.num_heads, self.gate_soft_cap, self.eps = num_heads, gate_soft_cap, eps
        self.fuse_outnorm = fuse_outnorm
        self.compute_dtype = compute_dtype
        self.chunk_size, self.mode, self.chunkwise_kernel = chunk_size, mode, chunkwise_kernel
        self.sequence_kernel, self.step_kernel = sequence_kernel, step_kernel
        for name in (chunkwise_kernel, sequence_kernel, step_kernel):
            get_mlstm_kernel(name)  # an unknown name fails here, not in a forward
        self.ifgate = Dense(3 * dim, 2 * num_heads, True, zeros_init,
                            ifgate_bias_init(num_heads))
        self.outnorm = MultiHeadLayerNorm(num_heads, dim // num_heads, eps=1e-6,
                                          use_bias=norm_bias)
        self.kernel = mlstm_siging_chunkwise_fw
        self.train_kernel = mlstm_siging_chunkwise_train

    def forward(self, q, k, v, state=None):
        B, S, H = q.shape
        NH = self.num_heads
        gate_in = torch.cat([q, k, v], dim=-1).to(acc_dtype(q.dtype))
        if_preact = soft_cap(self.ifgate(gate_in), self.gate_soft_cap)
        i_pre, f_pre = if_preact.split(NH, dim=-1)
        cd = self.compute_dtype or q.dtype
        fused = self.fuse_outnorm and not self.training and self.chunkwise_kernel == V2_KERNEL
        if state is not None:
            if fused and S > 1:
                return self._fused(q, k, v, i_pre, f_pre, cd, state)
            h, new_state = self._stateful(q, k, v, i_pre, f_pre, cd, state)
            return self.outnorm(h.to(q.dtype)).reshape(B, S, H), new_state
        if fused:
            return self._fused(q, k, v, i_pre, f_pre, cd)
        if self.chunkwise_kernel == V2_KERNEL:
            fn = self.train_kernel if self.training else self.kernel
            # q, k, v go in as they are (the kernels take views with a row stride)
            h = fn(_cast(q, cd), _cast(k, cd), _cast(v, cd), i_pre.contiguous(),
                   f_pre.contiguous(), NH, eps=self.eps)
            h = h.reshape(B, S, NH, H // NH)
        else:
            h = self._registry_route(q, k, v, i_pre, f_pre, cd).transpose(1, 2)
        if self.training:
            return h.reshape(B, S, H).to(q.dtype), (self.outnorm.weight, self.outnorm.bias)
        return self.outnorm(h.to(q.dtype)).reshape(B, S, H)

    def _fused(self, q, k, v, i_pre, f_pre, cd, state=None):
        """The outnorm's output (B, S, H) in q's dtype from the v2
        inference kernel with the LayerNorm fused in (and, with ``state``,
        the last (C, n))."""
        c0, n0 = state if state is not None else (None, None)
        out = mlstm_siging_chunkwise_fw_ln(
            _cast(q, cd), _cast(k, cd), _cast(v, cd), i_pre.contiguous(), f_pre.contiguous(),
            self.num_heads, 1.0 + self.outnorm.weight, self.outnorm.bias, c0, n0, eps=self.eps,
            ln_eps=self.outnorm.eps, return_last_states=state is not None)
        if state is None:
            return out.to(q.dtype)
        return out[0].to(q.dtype), out[1]

    def _mode(self) -> str:
        return self.mode or ("train_with_padding" if self.training else "inference")

    def _registry_route(self, q, k, v, i_pre, f_pre, cd, state=None):
        """h (B, NH, S, DH) of the cell's registry kernel; with ``state``,
        (h, (C, n)) of the inference wrapper from it."""
        B, S, H = q.shape
        NH = self.num_heads
        ck = self.chunkwise_kernel

        def heads(x):
            return _cast(x, cd).reshape(B, S, NH, H // NH).transpose(1, 2).contiguous()

        fn = make_backend(mLSTMBackendConfig(
            chunkwise_kernel=ck, sequence_kernel=self.sequence_kernel,
            step_kernel=self.step_kernel, mode=self._mode(), chunk_size=self.chunk_size,
            eps=self.eps, return_last_states=state is not None,
            auto_divisor_chunking="pallas" not in ck))
        states = {} if state is None else dict(c_initial=state[0], n_initial=state[1])
        return fn(heads(q), heads(k), heads(v), i_pre.transpose(1, 2).contiguous(),
                  f_pre.transpose(1, 2).contiguous(), **states)

    def _stateful(self, q, k, v, i_pre, f_pre, cd, state):
        """(h (B, S, NH, DH), (C, n)) from ``state`` in inference mode."""
        B, S, H = q.shape
        NH = self.num_heads
        if self._mode() != "inference":
            raise ValueError(f"a state is threaded in inference mode only, not {self._mode()!r}")
        if self.chunkwise_kernel == V2_KERNEL and S > 1:
            h, new_state = self.kernel(
                _cast(q, cd), _cast(k, cd), _cast(v, cd), i_pre.contiguous(), f_pre.contiguous(),
                NH, state[0], state[1], eps=self.eps, return_last_states=True)
            return h.reshape(B, S, NH, H // NH), new_state
        h, new_state = self._registry_route(q, k, v, i_pre, f_pre, cd, state=state)
        return h.transpose(1, 2), new_state


class ViLLayer(nn.Module):
    """Pre-norm mLSTM branch + pre-norm FFN branch.

    norm -> proj_up -> (qk: depthwise conv + SiLU -> qk_proj -> q, k;
    v: v_proj) -> mLSTM cell -> + learnable_skip * conv_act -> proj_down
    -> + residual; ffn_norm -> FeedForward -> + residual.  The BACKWARD
    direction flips the sequence before the branch and flips the branch
    output back.  ``chunk_size`` and ``chunkwise_kernel`` go to the cell
    (see :class:`MatrixLSTMCell`).
    """

    def __init__(self, dim: int, direction: str = FORWARD, expansion: int = 2,
                 qkv_block_size: int = 4, proj_bias: bool = True, norm_bias: bool = True,
                 conv_bias: bool = True, conv_kernel_size: int = 3, conv_kind: str = "2d",
                 seqlens: Sequence[int] | None = None, num_blocks: int = 1,
                 gate_soft_cap: float = 15.0, ffn_proj_factor: float = 2.6667,
                 ffn_round_up_to: int = 64, drop_path: float = 0.0, chunk_size: int = 64,
                 chunkwise_kernel: str = V2_KERNEL, compute_dtype: torch.dtype | None = None):
        super().__init__()
        if conv_kind != "2d":
            raise NotImplementedError(f"conv_kind={conv_kind!r} is not ported yet")
        if direction not in (FORWARD, BACKWARD):
            raise ValueError(f"unknown direction {direction!r}")
        self.direction = direction
        inner = expansion * dim
        self.inner = inner
        nh = inner // qkv_block_size
        cd = compute_dtype
        self.norm = RMSNorm(dim, eps=1e-6, use_weight=norm_bias)
        self.proj_up = Dense(dim, 2 * inner, proj_bias, small_init(dim), compute_dtype=cd)
        self.conv = SequenceConv2d(inner, conv_kernel_size, seqlens, conv_bias, cd)
        self.qk_proj = Dense(inner, 2 * inner, proj_bias, small_init(dim), compute_dtype=cd)
        self.v_proj = Dense(inner, inner, proj_bias, small_init(dim), compute_dtype=cd)
        self.mlstm_cell = MatrixLSTMCell(inner, nh, gate_soft_cap, norm_bias, compute_dtype=cd,
                                         chunk_size=chunk_size,
                                         chunkwise_kernel=chunkwise_kernel)
        self.learnable_skip = nn.Parameter(torch.empty(inner))
        self.proj_down = Dense(inner, dim, proj_bias, wang_init(dim, num_blocks),
                               compute_dtype=cd)
        self.ffn_norm = RMSNorm(dim, eps=1e-6, use_weight=norm_bias)
        self.ffn = FeedForward(dim, ffn_proj_factor, ffn_round_up_to, proj_bias,
                               num_blocks, compute_dtype=cd)
        self.drop_path = DropPath(drop_path)
        self.epilogue_fn = epilogue  # fused [outnorm -> + skip * x -> proj_down] of training
        self.ffn_fn = ffn            # fused [ffn_norm -> FFN] of training

    def init_own_parameters(self, g):
        nn.init.ones_(self.learnable_skip)

    def _mlstm_branch(self, xn):
        if self.direction == BACKWARD:
            xn = xn.flip(1)
        x_qk, x_v = self.proj_up(xn).split(self.inner, dim=-1)
        x_qk_act = F.silu(self.conv(x_qk))
        q, k = self.qk_proj(x_qk_act).split(self.inner, dim=-1)
        v = self.v_proj(x_v)
        if self.training:
            h_raw, (ln_w, ln_b) = self.mlstm_cell(q, k, v)
            wd, bd = self.proj_down.weight, self.proj_down.bias
            out = self.epilogue_fn(
                h_raw.contiguous(), x_qk_act.contiguous(), ln_w,
                ln_b if ln_b is not None else torch.zeros_like(ln_w), self.learnable_skip,
                wd, bd if bd is not None else wd.new_zeros(wd.shape[0]),
                self.mlstm_cell.num_heads, 1e-6)
        else:
            h = self.mlstm_cell(q, k, v)
            h = h + self.learnable_skip.to(h.dtype) * x_qk_act
            out = self.proj_down(h)
        if self.direction == BACKWARD:
            out = out.flip(1)
        return out

    def _ffn_branch(self, x):
        if not (self.training and self.ffn_norm.weight is not None):
            return self.ffn(self.ffn_norm(x))
        up, down = self.ffn.proj_up_gate_z, self.ffn.proj_down
        bgz = up.bias if up.bias is not None else up.weight.new_zeros(up.weight.shape[0])
        bd = down.bias if down.bias is not None else down.weight.new_zeros(down.weight.shape[0])
        return self.ffn_fn(x.contiguous(), self.ffn_norm.weight, up.weight, bgz, down.weight,
                           bd, 1e-6)

    def forward(self, x):
        x = self.drop_path(x, self._mlstm_branch(self.norm(x)))
        return self.drop_path(x, self._ffn_branch(x))


class ViLBlock(nn.Module):
    def __init__(self, dim: int, direction: str, chunk_size: int = 256, **kw):
        super().__init__()
        self.layer = ViLLayer(dim, direction, chunk_size=chunk_size, **kw)

    def forward(self, x):
        return self.layer(x)


class ViLBlockPair(nn.Module):
    """Forward-traversal block, then the flipped-traversal block.

    In training, pairs at S >= ``ckpt_thresh`` (80 * 80) are rematerialised
    with ``torch.utils.checkpoint``, as the JAX package remats them: the
    backward pass recomputes the pair's forward.  The DropPath generators
    are rewound for that recompute, so it draws the same masks.
    """

    ckpt_thresh = 80 * 80

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.rowwise_from_top_left = ViLBlock(dim, FORWARD, **kw)
        self.rowwise_from_bot_right = ViLBlock(dim, BACKWARD, **kw)

    def _pair(self, x):
        return self.rowwise_from_bot_right(self.rowwise_from_top_left(x))

    def forward(self, x):
        if not (self.training and x.shape[1] >= self.ckpt_thresh and torch.is_grad_enabled()):
            return self._pair(x)
        gens = {id(m.generator): m.generator for m in self.modules()
                if isinstance(m, DropPath) and m.generator is not None}.values()
        start = [(g, g.get_state()) for g in gens]
        recompute = False

        def run(x):
            nonlocal recompute
            if not recompute:
                recompute = True
                return self._pair(x)
            now = [(g, g.get_state()) for g, _ in start]
            for g, state in start:  # draw the forward's masks again
                g.set_state(state)
            out = self._pair(x)
            for g, state in now:  # and leave the generators where the step left them
                g.set_state(state)
            return out

        return checkpoint(run, x, use_reentrant=False)
