"""Carry weights from the JAX package into the port.

:func:`jax_variables_to_state_dict` takes the JAX package's
``{'params', 'batch_stats'}`` tree, as nested dicts of numpy arrays, and
returns the port's ``state_dict``.  The name translation and the layout
rules are those of ``xlstm_yolo_tpu/utils/torch_convert.py``:

- dense kernels (in, out) are transposed to (out, in);
- conv kernels HWIO become OIHW, and the xLSTM LM's 1-d causal conv
  kernels (K, 1, D) become torch's (D, 1, K);
- BatchNorm/LayerNorm ``scale`` becomes ``weight``; batch statistics
  ``mean``/``var`` become ``running_mean``/``running_var``;
- ``nn.Embed``'s ``embedding`` becomes the ``weight`` of ``nn.Embedding``;
  the sLSTM cell's ``recurrent_kernel`` (4, NH, DH, DH) is taken as it is.

The port names its submodules so that these are exactly its keys.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (str(key),))
        else:
            yield path + (str(key),), val


def jax_path_to_name(path: tuple[str, ...]) -> tuple[str, str]:
    """Translate a JAX variable path to (state-dict name, kind).

    kind is ``kernel`` (layout depends on rank) or ``raw``.
    """
    parts = list(path)
    col = parts.pop(0)  # 'params' or 'batch_stats'
    leaf = parts.pop()
    segs: list[str] = []
    for p in parts:
        m = re.fullmatch(r"model_(\d+)", p)
        if m:
            segs.append(f"model.{m.group(1)}")
            continue
        m = re.fullmatch(r"(cv[23])(_o2o)?_(\d+)_(.+)", p)
        if m:  # detect-head towers: cv2_o2o_0_1 -> one2one_cv2.0.1
            base = ("one2one_" if m.group(2) else "") + m.group(1)
            segs.append(f"{base}.{m.group(3)}.{m.group(4).replace('_', '.')}")
            continue
        m = re.fullmatch(r"(vil|blocks|mlp|box_mlp)_(\d+)", p)
        if m:
            segs.append(f"{m.group(1)}.{m.group(2)}")
            continue
        if p == "in_proj_conv":
            segs.append("in_proj.0")
            continue
        if p == "in_proj_bn":
            segs.append("in_proj.1")
            continue
        segs.append(p)
    # SequenceConv2d holds its weight directly, one level above JAX's nn.Conv
    prefix = ".".join(segs).replace("conv.conv", "conv")

    def join(name):
        return f"{prefix}.{name}" if prefix else name

    if col == "batch_stats":
        if leaf not in ("mean", "var"):
            raise KeyError(f"untranslatable batch stat {leaf!r} at {path}")
        return join("running_" + leaf), "raw"
    if leaf == "kernel":
        return join("weight"), "kernel"
    if leaf == "scale":
        return join("weight"), "raw"
    if leaf == "embedding":
        return join("weight"), "raw"
    if leaf in {"bias", "weight", "embed", "queries", "learnable_skip", "recurrent_kernel"}:
        return join(leaf), "raw"
    raise KeyError(f"untranslatable leaf {leaf!r} at {path}")


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables):
        name, kind = jax_path_to_name(path)
        t = np.asarray(leaf, dtype=np.float32)
        if kind == "kernel":
            if t.ndim == 2:
                t = t.T
            elif t.ndim == 3:
                t = t.transpose(2, 1, 0)
            elif t.ndim == 4:
                t = t.transpose(3, 2, 0, 1)
        if name in out:
            raise KeyError(f"two JAX leaves map to {name}")
        out[name] = torch.tensor(t)
    return out


def jax_leaf_names(model: torch.nn.Module) -> dict[str, str]:
    """The JAX leaf name of each of ``model``'s parameters, the inverse of
    :func:`jax_path_to_name` on the leaf: a ``weight`` is flax's ``kernel``
    on a dense, conv or patch projection, its ``scale`` on a BatchNorm or
    LayerNorm, its ``embedding`` on an embedding, and ``weight`` on the RMS
    and per-head norms."""
    from xlstm_yolo_tpu_torch.nn import layers, xlstm

    kernel_owners = (layers.Dense, layers.Conv, layers.SequenceConv2d, layers._PatchProj,
                     xlstm.CausalConv1d)
    scale_owners = (layers.BatchNorm, layers.LayerNorm)
    modules = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "weight" and isinstance(modules[owner], kernel_owners):
            leaf = "kernel"
        elif leaf == "weight" and isinstance(modules[owner], scale_owners):
            leaf = "scale"
        elif leaf == "weight" and isinstance(modules[owner], torch.nn.Embedding):
            leaf = "embedding"
        out[name] = leaf
    return out


def jax_train_state_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                             ema_params: Mapping[str, Any]):
    """A JAX ``TrainState``'s trees (nested dicts of numpy arrays) -> the
    port's ``(state_dict, ema)``: the model's parameters and BatchNorm
    statistics, and the EMA's copy of each parameter, by state-dict name."""
    state_dict = jax_variables_to_state_dict({"params": params, "batch_stats": batch_stats})
    ema = jax_variables_to_state_dict({"params": ema_params})
    return state_dict, ema
