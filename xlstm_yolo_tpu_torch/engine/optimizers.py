"""AdEMAMix with its parameter groups, learning-rate schedules, gradient
clipping and EMA, on lists of tensors.

Counterpart of ``ademamix``, ``decay_mask_fn``, ``cosine_lr``,
``linear_lr``, ``warmup_wrap``, ``bias_label_fn``, ``build_optimizer``
(for ``name="AdEMAMix"``), ``ema_init``, ``ema_decay_at`` and
``ema_update`` in ``xlstm_yolo_tpu/engine/optimizers.py``.  It is not
``torch.optim``, whose AdamW-family semantics differ.

A transform is a pair ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)`` over lists of tensors, as an optax
``GradientTransformation`` is over trees; the updates are added to the
parameters.  Unlike optax, ``update`` changes the moment tensors of its
state in place (they are the optimizer's own, so this saves a copy of
each).  Parameter groups are chosen by the JAX leaf name of each tensor
(``utils.convert.jax_leaf_names``), so a BatchNorm ``weight`` is treated as
flax's ``scale`` and a dense ``weight`` as its ``kernel``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

Schedule = Callable[[float], float]


class Transform(NamedTuple):
    init: Callable
    update: Callable


class AdEMAMixState(NamedTuple):
    count: int
    m_fast: list
    m_slow: list
    nu: list


def ademamix(learning_rate, b1: float = 0.9, b2: float = 0.999, b3: float = 0.9999,
             alpha: float = 8.0, beta3_warmup: int | None = None,
             alpha_warmup: int | None = None, eps: float = 1e-8, weight_decay: float = 0.0,
             mask: Sequence[bool] | None = None) -> Transform:
    """update = -lr * ((m_fast / bc1 + alpha_t * m_slow) / (sqrt(nu / bc2) + eps)
    + weight_decay * p), the decay on the leaves where ``mask`` is True (all
    when it is None).  beta3 warms up in half-life space and alpha linearly
    over their warmup steps."""

    def beta3_t(step):
        if beta3_warmup is None:
            return b3
        f = lambda beta: math.log(0.5) / math.log(beta + 1e-8) - 1  # noqa: E731
        a = min(step / float(beta3_warmup), 1.0)
        return 0.5 ** (1.0 / ((1 - a) * f(b1) + a * f(b3) + 1))

    def alpha_t(step):
        return alpha if alpha_warmup is None else min(step / float(alpha_warmup), 1.0) * alpha

    def init(params):
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        return AdEMAMixState(0, zeros(), zeros(), zeros())

    def update(grads, state, params):
        step = state.count + 1
        b3t, at = beta3_t(step), alpha_t(step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        mf, ms, nu = state.m_fast, state.m_slow, state.nu
        torch._foreach_mul_(mf, b1)
        torch._foreach_add_(mf, grads, alpha=1 - b1)
        torch._foreach_mul_(ms, b3t)
        torch._foreach_add_(ms, grads, alpha=1 - b3t)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mf, bc1)
        torch._foreach_add_(upd, ms, alpha=at)
        torch._foreach_div_(upd, denom)
        if weight_decay:
            decayed = [j for j in range(len(upd)) if mask is None or mask[j]]
            torch._foreach_add_([upd[j] for j in decayed], [params[j] for j in decayed],
                                alpha=weight_decay)
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        torch._foreach_mul_(upd, -lr)
        return upd, AdEMAMixState(step, mf, ms, nu)

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale the gradients by max_norm / ||g|| when ||g|| >= max_norm."""

    def update(grads, state, params=None):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return torch._foreach_mul(grads, scale), state

    return Transform(lambda params: (), update)


def multi_transform(transforms: dict[str, Transform], labels: Sequence[str]) -> Transform:
    """Each transform updates the leaves whose label is its key."""
    index = {key: [j for j, lab in enumerate(labels) if lab == key] for key in transforms}

    def init(params):
        return {key: tx.init([params[j] for j in index[key]]) for key, tx in transforms.items()}

    def update(grads, state, params):
        out, new = [None] * len(grads), {}
        for key, tx in transforms.items():
            idx = index[key]
            upd, new[key] = tx.update([grads[j] for j in idx], state[key],
                                      [params[j] for j in idx])
            for j, u in zip(idx, upd):
                out[j] = u
        return out, new

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(tx.init(params) for tx in transforms)

    def update(grads, state, params):
        new = []
        for tx, st in zip(transforms, state):
            grads, st = tx.update(grads, st, params)
            new.append(st)
        return grads, tuple(new)

    return Transform(init, update)


def decay_mask_fn(leaves: Sequence[tuple[str, int]]) -> list[bool]:
    """For (JAX leaf name, ndim) pairs: True (decay) for kernels of rank >= 2;
    False for biases, norm scales and weights, embeddings, learnable skips
    and queries."""
    def decay(name, ndim):
        if name in {"bias", "scale", "embed", "learnable_skip", "queries"}:
            return False
        if name == "weight" and ndim <= 1:
            return False
        return ndim >= 2
    return [decay(name, ndim) for name, ndim in leaves]


def bias_label_fn(leaves: Sequence[tuple[str, int]]) -> list[str]:
    """'bias' for 1-D bias leaves, else 'main'."""
    return ["bias" if name == "bias" and ndim <= 1 else "main" for name, ndim in leaves]


def cosine_lr(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
              warmup_steps: int = 0) -> Schedule:
    """Linear warmup, then cosine from lr0 to lr0 * lrf."""
    total = max(epochs * steps_per_epoch, 1)

    def sched(step):
        frac = min(max(step / total, 0.0), 1.0)
        lr = lr0 * (lrf + (1 - lrf) * (1 + math.cos(math.pi * frac)) / 2)
        return lr * min(max(step / warmup_steps, 0.0), 1.0) if warmup_steps > 0 else lr

    return sched


def linear_lr(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
              warmup_steps: int = 0) -> Schedule:
    total = max(epochs * steps_per_epoch, 1)

    def sched(step):
        frac = min(max(step / total, 0.0), 1.0)
        lr = lr0 * ((1 - frac) * (1 - lrf) + lrf)
        return lr * min(max(step / warmup_steps, 0.0), 1.0) if warmup_steps > 0 else lr

    return sched


def warmup_wrap(base_sched, warmup_steps: int, x0: float = 0.0) -> Schedule:
    """Linear interpolation from ``x0`` to the base schedule over the warmup."""
    base = base_sched if callable(base_sched) else (lambda s: float(base_sched))

    def sched(step):
        w = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        return x0 * (1.0 - w) + base(step) * w

    return sched


def build_optimizer(leaves: Sequence[tuple[str, int]], name: str = "AdEMAMix",
                    lr: float = 0.01, momentum: float = 0.937, weight_decay: float = 5e-4,
                    schedule: Schedule | None = None, iterations: int = 10000,
                    clip_norm: float = 10.0, warmup_steps: int = 0,
                    warmup_bias_lr: float = 0.1, **unsupported) -> tuple[Transform, float, str]:
    """clip by global norm -> AdEMAMix, for leaves given as (JAX leaf name,
    ndim) in parameter order.  With ``warmup_steps`` the main group (with
    weight decay on its kernels) and the bias group (no decay) warm up from
    lr 0: the Adam family forbids the 0.1 bias warmup lr."""
    if name != "AdEMAMix" or unsupported:
        raise NotImplementedError(
            f"optimizer {name!r} {sorted(unsupported)}: only AdEMAMix is ported "
            "(ROADMAP Queue 1 item 7)")
    del warmup_bias_lr  # Adam family: the bias group warms up from 0 as well
    mask = decay_mask_fn(leaves)
    lr_main = schedule if schedule is not None else lr

    def mk(lr_s, wd, group_mask):
        return ademamix(lr_s, b1=momentum, b2=0.999, b3=0.9999, alpha=8.0,
                        beta3_warmup=iterations, alpha_warmup=iterations, weight_decay=wd,
                        mask=group_mask if wd else None)

    if warmup_steps > 0:
        labels = bias_label_fn(leaves)
        main_mask = [m for m, lab in zip(mask, labels) if lab == "main"]
        warm = warmup_wrap(lr_main, warmup_steps, 0.0)
        tx = multi_transform({"main": mk(warm, weight_decay, main_mask),
                              "bias": mk(warm, 0.0, None)}, labels)
    else:
        tx = mk(lr_main, weight_decay, mask)
    return chain(clip_by_global_norm(clip_norm), tx), lr, name


class EMAState(NamedTuple):
    params: list
    updates: int


def ema_init(params) -> EMAState:
    return EMAState([p.detach().clone() for p in params], 0)


def ema_decay_at(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """d = decay * (1 - exp(-updates / tau))."""
    return decay * (1 - math.exp(-updates / tau))


def ema_update(state: EMAState, params, decay: float = 0.9999, tau: float = 2000.0) -> EMAState:
    """e <- d e + (1 - d) p, in place on the EMA's own tensors."""
    upd = state.updates + 1
    d = ema_decay_at(upd, decay, tau)
    torch._foreach_mul_(state.params, d)
    torch._foreach_add_(state.params, [p.detach() for p in params], alpha=1 - d)
    return EMAState(state.params, upd)

