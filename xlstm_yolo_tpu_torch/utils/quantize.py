"""Post-training weight quantization of a state dict: int8, weight-only,
per output channel, symmetric.

Counterpart of ``quantize_tree`` / ``dequantize_tree`` in
``xlstm_yolo_tpu/utils/quantize.py`` with JAX's rules, on the port's
``state_dict``:

- a parameter of fewer than 2 dimensions or 1024 elements stays float32;
- every other parameter becomes ``{"q": int8, "s": float32}``: one scale
  per output channel, amax / 127 (1 where amax is 0), the values divided
  by it, rounded half to even and clipped to +-127; ``q * s`` (float32)
  dequantizes it;
- the BatchNorm statistics (buffers) are not quantized, as JAX quantizes
  ``params`` only.

JAX's channel axis is the flax leaf's last axis.  The port stores a
``kernel`` leaf transposed (dense (in, out) as (out, in), HWIO as OIHW,
the LM's (K, 1, D) as (D, 1, K)), so there the axis is 0, save the
transposed conv's (flax HWIO as torch's (in, out, kh, kw): axis 1); every other
leaf (the learned positions, the PatchMerger queries, the embedding, the
sLSTM ``recurrent_kernel``) keeps its last axis.  The axis comes from
``utils.convert.jax_leaf_names``, never from a tensor's shape.  A scale
keeps its leaf's rank (size 1 off the channel axis), so ``q * s``
broadcasts in the port's layout.
"""

from __future__ import annotations

import torch

__all__ = ["channel_axes", "dequantize_state_dict", "is_quantized_state_dict",
           "quantize_state_dict"]

_MIN_SIZE = 1024  # smaller leaves stay float32


def _is_pair(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def channel_axes(model: torch.nn.Module) -> dict[str, int]:
    """The output-channel axis of each of ``model``'s parameters in the
    port's layout: 0 for a flax ``kernel`` leaf (1 for a transposed conv's),
    else the last axis."""
    from xlstm_yolo_tpu_torch.nn.layers import ConvTranspose
    from xlstm_yolo_tpu_torch.utils.convert import jax_leaf_names

    params = dict(model.named_parameters())
    modules = dict(model.named_modules())

    def axis(name, leaf):
        if leaf != "kernel":
            return params[name].dim() - 1
        return 1 if isinstance(modules[name.rpartition(".")[0]], ConvTranspose) else 0

    return {name: axis(name, leaf) for name, leaf in jax_leaf_names(model).items()}


def quantize_state_dict(state_dict: dict, axes: dict[str, int], bits: int = 8) -> dict:
    """``state_dict`` with each parameter named in ``axes`` (see
    :func:`channel_axes`) of at least 2 dimensions and 1024 elements as an
    int8 ``{"q", "s"}`` pair, every other parameter as float32, and the
    buffers as they are (on the CPU)."""
    if bits != 8:
        raise ValueError("only int8 is supported")
    out = {}
    for name, t in state_dict.items():
        a = t.detach().cpu()
        if name not in axes:  # a buffer: the BatchNorm statistics
            out[name] = a.clone()
            continue
        a = a.float()
        if a.dim() < 2 or a.numel() < _MIN_SIZE:
            out[name] = a.clone()
            continue
        ax = axes[name]
        others = tuple(d for d in range(a.dim()) if d != ax)
        amax = a.abs().amax(dim=others, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.round(a / scale).clamp_(-127, 127).to(torch.int8)
        out[name] = {"q": q, "s": scale}
    return out


def dequantize_state_dict(qstate: dict, dtype: torch.dtype = torch.float32) -> dict:
    """Inverse of :func:`quantize_state_dict`: each pair as ``q * s``."""
    return {name: (v["q"].float() * v["s"]).to(dtype) if _is_pair(v) else v
            for name, v in qstate.items()}


def is_quantized_state_dict(state: dict) -> bool:
    return any(_is_pair(v) for v in state.values())
