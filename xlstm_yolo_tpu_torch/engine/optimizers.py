"""The optimizers with their parameter groups, learning-rate schedules,
gradient clipping and EMA, on lists of tensors.

Counterpart of ``ademamix``, ``decay_mask_fn``, ``cosine_lr``,
``linear_lr``, ``warmup_wrap``, ``bias_label_fn``, ``build_optimizer``,
``ema_init``, ``ema_decay_at`` and ``ema_update`` in
``xlstm_yolo_tpu/engine/optimizers.py``, and of the optax transforms its
``build_optimizer`` chains: ``adam``/``adamw`` (:func:`adam`), ``sgd``
with Nesterov momentum and ``rmsprop`` under ``inject_hyperparams``
(:func:`sgd`, :func:`rmsprop`: the learning rate and momentum are
schedules read at the transform's own step count, from 0, as optax's
``scale_by_learning_rate`` reads a schedule; AdEMAMix reads its schedule at
the count after the update, as JAX's does).  It is not ``torch.optim``,
whose AdamW-family semantics differ.

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


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def _masked(params, mask):
    return [j for j in range(len(params)) if mask is None or mask[j]]


def _lr_at(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, mask: Sequence[bool] | None = None) -> Transform:
    """optax ``adam`` (``weight_decay`` 0) or ``adamw``: update = -lr *
    (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p), the decay on the
    leaves where ``mask`` is True (all when it is None)."""

    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        count = state.count + 1
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nu, 1 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu, 1 - b1 ** count)
        torch._foreach_div_(upd, denom)
        if weight_decay:
            idx = _masked(params, mask)
            torch._foreach_add_([upd[j] for j in idx], [params[j] for j in idx],
                                alpha=weight_decay)
        torch._foreach_mul_(upd, -_lr_at(learning_rate, state.count))
        return upd, AdamState(count, mu, nu)

    return Transform(init, update)


class MomentumState(NamedTuple):
    count: int
    trace: list
    nu: list  # RMSProp's second moment; empty for SGD


def sgd(learning_rate, momentum, weight_decay: float = 0.0,
        mask: Sequence[bool] | None = None) -> Transform:
    """optax ``add_decayed_weights`` then ``inject_hyperparams(sgd)`` with
    Nesterov momentum: g += weight_decay * p (masked); t = g + mu t;
    update = -lr (g + mu t)."""

    def init(params):
        return MomentumState(0, [torch.zeros_like(p) for p in params], [])

    def update(grads, state, params):
        lr, mom = _lr_at(learning_rate, state.count), _lr_at(momentum, state.count)
        g = list(grads)
        if weight_decay:
            for j in _masked(params, mask):
                g[j] = g[j] + weight_decay * params[j]
        trace = state.trace
        torch._foreach_mul_(trace, mom)
        torch._foreach_add_(trace, g)
        upd = torch._foreach_mul(trace, mom)
        torch._foreach_add_(upd, g)
        torch._foreach_mul_(upd, -lr)
        return upd, MomentumState(state.count + 1, trace, [])

    return Transform(init, update)


def rmsprop(learning_rate, momentum, decay: float = 0.9, eps: float = 1e-8) -> Transform:
    """optax ``inject_hyperparams(rmsprop)`` with momentum: nu = decay nu +
    (1 - decay) g^2; u = -lr g / sqrt(nu + eps); t = u + mu t; update = t."""

    def init(params):
        return MomentumState(0, [torch.zeros_like(p) for p in params],
                             [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        lr, mom = _lr_at(learning_rate, state.count), _lr_at(momentum, state.count)
        nu, trace = state.nu, state.trace
        torch._foreach_mul_(nu, decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - decay)
        scale = torch._foreach_add(nu, eps)
        torch._foreach_rsqrt_(scale)
        upd = torch._foreach_mul(scale, grads)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_mul_(trace, mom)
        torch._foreach_add_(trace, upd)
        return [t.clone() for t in trace], MomentumState(state.count + 1, trace, nu)

    return Transform(init, update)


# Adam-family names, whose normalised updates forbid the 0.1 bias warmup lr
ADAM_FAMILY = {"Adam", "AdamW", "Adamax", "NAdam", "RAdam", "AdEMAMix"}
OPTIMIZERS = ADAM_FAMILY | {"SGD", "RMSProp", "auto"}


def build_optimizer(leaves: Sequence[tuple[str, int]], name: str = "auto",
                    lr: float = 0.01, momentum: float = 0.937, weight_decay: float = 5e-4,
                    schedule: Schedule | None = None, iterations: int = 10000, nc: int = 80,
                    clip_norm: float = 10.0, warmup_steps: int = 0,
                    warmup_momentum: float = 0.8,
                    warmup_bias_lr: float = 0.1) -> tuple[Transform, float, str]:
    """clip by global norm -> the optimizer ``name``, for leaves given as (JAX
    leaf name, ndim) in parameter order.  Returns (transform, lr, name).

    ``auto`` is AdamW at lr ``round(0.002 * 5 / (4 + nc), 6)`` and momentum
    0.9 up to 10 000 iterations, SGD at lr 0.01 and momentum 0.9 above
    (as in JAX, a given ``schedule`` is kept and the chosen lr is only
    returned).  Adam, Adamax, NAdam and RAdam are optax ``adam`` (no weight
    decay); AdamW and SGD decay the kernels of rank >= 2; RMSProp decays
    nothing.  With ``warmup_steps`` the main group warms up from lr 0 and
    the bias group from ``warmup_bias_lr`` (0 for the Adam family), and the
    SGD and RMSProp momentum from ``warmup_momentum``."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name}")
    if name == "auto":
        lr_fit = round(0.002 * 5 / (4 + nc), 6)
        name, lr, momentum = ("SGD", 0.01, 0.9) if iterations > 10000 else ("AdamW", lr_fit, 0.9)
    if name in ADAM_FAMILY:
        warmup_bias_lr = 0.0
    mask = decay_mask_fn(leaves)
    warm = warmup_steps > 0
    lr_main = schedule if schedule is not None else lr
    if warm:
        lr_main = warmup_wrap(lr_main, warmup_steps, 0.0)
        lr_bias = warmup_wrap(schedule or lr, warmup_steps, warmup_bias_lr)
        mom_s = warmup_wrap(momentum, warmup_steps, warmup_momentum)
    else:
        lr_bias, mom_s = lr_main, momentum

    def mk(lr_s, wd, group_mask):
        if name == "SGD":
            return sgd(lr_s, mom_s, weight_decay=wd, mask=group_mask)
        if name in {"Adam", "Adamax", "NAdam", "RAdam"}:
            return adam(lr_s, b1=momentum, b2=0.999)
        if name == "AdamW":
            return adam(lr_s, b1=momentum, b2=0.999, weight_decay=wd,
                        mask=group_mask if wd else None)
        if name == "RMSProp":
            return rmsprop(lr_s, mom_s)
        return ademamix(lr_s, b1=momentum, b2=0.999, b3=0.9999, alpha=8.0,
                        beta3_warmup=iterations, alpha_warmup=iterations, weight_decay=wd,
                        mask=group_mask if wd else None)

    if warm:
        labels = bias_label_fn(leaves)
        main_mask = [m for m, lab in zip(mask, labels) if lab == "main"]
        tx = multi_transform({"main": mk(lr_main, weight_decay, main_mask),
                              "bias": mk(lr_bias, 0.0, None)}, labels)
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

