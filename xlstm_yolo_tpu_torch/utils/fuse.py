"""Conv + BatchNorm folding for deployment.

Counterpart of ``xlstm_yolo_tpu/utils/fuse.py``, on the port's state dict.
An eval-mode BatchNorm is an affine map with frozen statistics, so every
(conv -> BatchNorm) pair folds into one biased conv:

    k' = k * gamma / sqrt(var + eps)
    b' = beta + (b0 - mean) * gamma / sqrt(var + eps)

with b0 the conv's own bias (zeros without one).  The pairs are found by
the modules' names, JAX's convention in the port's names: ``bn -> conv``
(``ConvBNAct``), ``norm -> fc1`` (``LSBlock``) and ``in_proj.1 ->
in_proj.0`` (``ViLFusionBlock``, JAX's ``in_proj_bn -> in_proj_conv``).
:func:`fuse_state_dict` returns the state dict of the model built with
``fused=True`` (``nn.tasks.build_detection_model``): the folded convs carry
biases and the BatchNorms are gone.
"""

from __future__ import annotations

from typing import Mapping

import torch

BN_EPS = 1e-3  # the epsilon of every BatchNorm of the detectors

# BatchNorm module name -> its sibling conv's
_BN_TO_CONV = {"bn": "conv", "norm": "fc1", "in_proj.1": "in_proj.0"}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def fold(kernel, gamma, beta, mean, var, bias0=None, eps: float = BN_EPS):
    """(k', b') of BN(conv(x) + b0) as one conv; the kernel's output
    channels are its first axis (OIHW), float32 math as JAX's ``_fold``."""
    scale = gamma / torch.sqrt(var + eps)
    k = kernel * scale.reshape((-1,) + (1,) * (kernel.ndim - 1))
    b0 = torch.zeros_like(mean) if bias0 is None else bias0
    return k.to(kernel.dtype), (beta + (b0 - mean) * scale).to(kernel.dtype)


def _pairs(sd: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """conv module name -> BatchNorm module name, for each foldable pair."""
    out = {}
    for key in sd:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        for bn_name, conv_name in _BN_TO_CONV.items():
            if (bn == bn_name or bn.endswith("." + bn_name)) and all(
                    f"{bn}.{leaf}" in sd for leaf in _BN_LEAVES):
                conv = bn[: len(bn) - len(bn_name)] + conv_name
                if f"{conv}.weight" in sd:
                    out[conv] = bn
    return out


def fuse_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold every BatchNorm of ``sd`` into its sibling conv and drop it."""
    pairs = _pairs(sd)
    dropped = {f"{bn}.{leaf}" for bn in pairs.values() for leaf in _BN_LEAVES}
    out = {k: v for k, v in sd.items() if k not in dropped}
    for conv, bn in pairs.items():
        k, b = fold(sd[f"{conv}.weight"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                    sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], sd.get(f"{conv}.bias"))
        out[f"{conv}.weight"], out[f"{conv}.bias"] = k, b
    return out
