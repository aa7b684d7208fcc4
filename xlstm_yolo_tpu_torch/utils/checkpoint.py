"""Checkpoints of the whole train state (counterpart of
``xlstm_yolo_tpu/utils/checkpoint.py``, whose checkpoints are orbax
directories, which the port does not read).

``save_checkpoint`` writes one ``torch.save`` file of JAX's ``_to_tree``
keys, ``{step, params, batch_stats, opt_state, ema_params, ema_updates}``
(parameters, statistics and EMA by state-dict name; the optimizer state as
its leaves, tensors and counts, in the order of its tree), plus ``rng``,
the stochastic-depth generator's state, and the JSON sidecar
``{name}.meta.json`` of ``{epoch, best_fitness, args}``.
``load_checkpoint`` restores into a state of the same structure, in place,
and returns ``(state, start_epoch, best_fitness)``.  Files are read with
``weights_only=True``.  ``strip_optimizer`` writes the EMA parameters and
the BatchNorm statistics as a model state dict, ``{stem}_stripped.pt``,
which ``YOLO("....pt")`` and ``engine.model.load_checkpoint_state`` load
strictly.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from xlstm_yolo_tpu_torch.engine.optimizers import EMAState


def _leaves(tree) -> list:
    """The tensors and numbers of a tree of tuples, lists and dicts, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(template, leaves: list):
    """``template``'s tree with its leaves taken, in order, from ``leaves``:
    a tensor is copied into the template's (in place, on its device)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        kids = [_rebuild(t, leaves) for t in template]
        if isinstance(template, list):
            return kids
        return type(template)(*kids) if hasattr(template, "_fields") else tuple(kids)
    new = leaves.pop(0)
    if isinstance(template, torch.Tensor):
        if not isinstance(new, torch.Tensor) or new.shape != template.shape:
            raise ValueError(f"checkpoint leaf {getattr(new, 'shape', new)} does not fit "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            return template.copy_(new)
    if isinstance(new, torch.Tensor):
        raise ValueError(f"checkpoint holds a tensor where the state holds {template!r}")
    return new


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _meta_path(path: Path) -> Path:
    return path.parent / f"{path.name}.meta.json"


def save_checkpoint(path, state, epoch: int, best_fitness: float, args: dict | None,
                    generator: torch.Generator | None = None) -> Path:
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {
        "step": int(state.step),
        "params": {n: _cpu(p) for n, p in state.params.items()},
        "batch_stats": {n: _cpu(b) for n, b in state.batch_stats.items()},
        "opt_state": [_cpu(x) if isinstance(x, torch.Tensor) else x
                      for x in _leaves(state.opt_state)],
        "ema_params": {n: _cpu(e) for n, e in zip(state.params, state.ema.params)},
        "ema_updates": int(state.ema.updates),
    }
    if generator is not None:
        tree["rng"] = generator.get_state()
    tmp = path.with_name(path.name + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)
    meta = {
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        "args": {k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
                 for k, v in (args or {}).items()},
    }
    _meta_path(path).write_text(json.dumps(meta))
    return path


def read_checkpoint(path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def load_checkpoint(path, state, generator: torch.Generator | None = None):
    """Restore ``path`` into ``state`` (and ``generator``) in place; returns
    (state, start_epoch, best_fitness)."""
    path = Path(path).resolve()
    tree = read_checkpoint(path)
    for key, held in (("params", state.params), ("batch_stats", state.batch_stats),
                      ("ema_params", dict(zip(state.params, state.ema.params)))):
        if set(tree[key]) != set(held):
            raise KeyError(f"checkpoint {key} differ from the state's: "
                           f"{sorted(set(tree[key]) ^ set(held))[:5]}")
        with torch.no_grad():
            for n, t in held.items():
                t.copy_(tree[key][n])
    leaves = list(tree["opt_state"])
    state.opt_state = _rebuild(state.opt_state, leaves)
    if leaves:
        raise ValueError(f"checkpoint optimizer state has {len(leaves)} leaves too many")
    state.ema = EMAState(state.ema.params, int(tree["ema_updates"]))
    state.step = int(tree["step"])
    if generator is not None and "rng" in tree:
        generator.set_state(tree["rng"])
    meta_file = _meta_path(path)
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    return state, int(meta.get("epoch", -1)) + 1, float(meta.get("best_fitness", 0.0))


def strip_optimizer(path, out=None) -> Path:
    """Keep only the EMA parameters and BatchNorm statistics, as a model
    state dict."""
    tree = read_checkpoint(path)
    path = Path(path)
    out = Path(out or path.with_name(f"{path.stem}_stripped{path.suffix}")).resolve()
    torch.save({**(tree.get("ema_params") or tree["params"]), **tree.get("batch_stats", {})}, out)
    return out
