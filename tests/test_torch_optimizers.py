"""Every optimizer name of the port's ``build_optimizer`` held against the
JAX package's, on identical gradients, on the CPU.

The tree is a handful of leaves named as ``vil-det-tiny``'s: dense and
conv kernels (decayed), biases (the bias group), BatchNorm and norm
scales, a learnable skip.  Each name runs six updates under a linear
schedule with a warmup of 3 steps (two steps either side of its end),
weight decay 0.05 and clipping at 10 (active: the gradients' norm is
above it), and once without a warmup (no bias group).  ``auto`` runs on
both sides of 10 000 iterations (AdamW and SGD).  Each update equals
JAX's within 1e-6 of the leaf's largest |value| (the parameter's; the
port computes the schedules in float64, JAX in float32: an update's
relative difference reaches ~1e-5, at most ~1e-8 of the leaf).
"""

import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.engine import optimizers as jax_opt
from test_torch_train_loader import one_thread  # noqa: F401
from xlstm_yolo_tpu_torch.engine import optimizers as opt

SHAPES = {"dense": {"kernel": (6, 5), "bias": (5,)}, "norm": {"scale": (5,), "bias": (5,)},
          "cell": {"learnable_skip": (4,), "weight": (4,)}, "conv": {"kernel": (3, 3, 2, 4)}}
NAMES = ["AdEMAMix", "Adam", "AdamW", "Adamax", "NAdam", "RAdam", "RMSProp", "SGD"]
STEPS = 6


def run(name: str, iterations: int, warmup_steps: int):
    rng = np.random.default_rng(sum(map(ord, name)) + iterations + warmup_steps)
    params = {m: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
              for m, d in SHAPES.items()}
    grads = [{m: {k: (rng.normal(size=s) * 5).astype(np.float32) for k, s in d.items()}
              for m, d in SHAPES.items()} for _ in range(STEPS)]
    kw = dict(name=name, lr=0.01, momentum=0.937, weight_decay=0.05, iterations=iterations,
              nc=80, clip_norm=10.0, warmup_steps=warmup_steps, warmup_momentum=0.8,
              warmup_bias_lr=0.1)
    order = [(m, k) for m in sorted(SHAPES) for k in sorted(SHAPES[m])]  # JAX's leaf order
    leaves = [(k, len(SHAPES[m][k])) for m, k in order]
    tx, lr, jname = jax_opt.build_optimizer(params, schedule=jax_opt.linear_lr(0.01, 0.1, 2, 4),
                                            **kw)
    ptx, plr, pname = opt.build_optimizer(leaves, schedule=opt.linear_lr(0.01, 0.1, 2, 4), **kw)
    assert (plr, pname) == (lr, jname)
    js, jp = tx.init(params), params
    pp = [torch.from_numpy(params[m][k].copy()) for m, k in order]
    ps = ptx.init(pp)
    for step, g in enumerate(grads):
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for d in g.values()
                           for x in d.values()))
        assert norm > 10.0  # clipping is active
        upd, js = tx.update(g, js, jp)
        jp = {m: {k: jp[m][k] + np.asarray(upd[m][k]) for k in jp[m]} for m in jp}
        pu, ps = ptx.update([torch.from_numpy(g[m][k]) for m, k in order], ps, pp)
        torch._foreach_add_(pp, pu)
        for j, (m, k) in enumerate(order):
            ref = np.asarray(upd[m][k])
            scale = np.abs(params[m][k]).max()
            np.testing.assert_allclose(pu[j].numpy(), ref, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{name} step {step} {m}/{k}")
    return jname, pp, jp, order


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_jax_across_warmup(name):
    _, pp, jp, order = run(name, 1000, 3)
    for j, (m, k) in enumerate(order):
        np.testing.assert_allclose(pp[j].numpy(), jp[m][k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["SGD", "AdamW", "RMSProp"])
def test_optimizer_matches_jax_without_warmup(name):
    run(name, 1000, 0)


@pytest.mark.parametrize("iterations,picked", [(10000, "AdamW"), (10001, "SGD")])
def test_auto_picks_as_jax(iterations, picked):
    name, _, _, _ = run("auto", iterations, 3)
    assert name == picked


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.build_optimizer([("kernel", 2)], name="Lion")
