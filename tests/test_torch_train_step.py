"""The port's training step against the JAX package's, on ``vil-det-tiny``.

Both sides start from the same state: the JAX ``TrainState``'s params,
batch statistics and EMA are carried into the port.  The gates keep their
default init (input-gate bias -10), where the JAX package's CPU cell
(autograd through the max(|.|, 1) denominator) and the port's (the
denominator held constant, at every S) have the same gradient: the test
asserts that every denominator of the port's cells clamps to 1.

Also here: the optimizer (AdEMAMix under warmup, weight decay and active
clipping, three steps from identical gradient trees; its decay mask and
bias group leaf for leaf), BatchNorm in training (flax's fast biased
variance, momentum 0.97), DropPath's generator under checkpointing, and
the guards of ``make_train_step``.  Inputs are made with numpy from a
seed, float32.  The JAX train step is jitted once, in a module-scoped
fixture.

Tolerances (float32):
- loss items of step 1: rtol = 1e-4 (a 29-layer forward summed in another
  order); of step 2: rtol = 1e-3 (it runs on parameters after one
  AdEMAMix update, whose first step is about lr * g / |g| and so amplifies
  rounding in the smallest gradients);
- the gradient as the optimizer received it (after clipping, recovered
  from the first moment m_fast = (1 - b1) g): rtol = 2e-4 and atol = 2e-4
  times each leaf's largest |g| plus 1e-6 times the largest |g| of all
  leaves (the biases just ahead of a BatchNorm have a true gradient of 0,
  so they hold only rounding, about 1e-8 of the largest |g|);
- BatchNorm running statistics: atol = rtol = 1e-4 after step 1, 1e-3
  after step 2 (as the step-2 loss);
- EMA: parameters after an Adam-family update are not compared leaf by
  leaf at a tight tolerance, since the first update is about lr g / |g|
  and a gradient near its eps of 1e-8 (the biases ahead of a BatchNorm
  hold only rounding) takes either sign.  So 99.9 % of the elements agree
  within atol = 1e-6, rtol = 1e-5 after step 1 and within atol = 1e-4
  (1.5 % of that step's lr) after step 2, and every element lies within
  the largest update two steps can make, 2 lr (1 + alpha_t);
- the optimizer on identical gradients: atol = 1e-7, rtol = 1e-5; the slow
  moment rtol = 1e-3 (1 - beta3_t is about 1e-4, so the float32 rounding of
  the JAX package's beta3_t, 6e-8, is amplified 1e4 times).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.engine import optimizers as jax_opt
from xlstm_yolo_tpu.engine import steps as jax_steps
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu_torch.engine import optimizers as opt
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.nn.layers import BatchNorm, DropPath, ViLBlockPair, reset_parameters
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import chunkwise_v2
from xlstm_yolo_tpu_torch.utils.convert import (
    jax_path_to_name,
    jax_train_state_to_torch,
    jax_variables_to_state_dict,
)

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
CFG = CFG / "vil-det-tiny.yaml"
OPT_KW = dict(name="AdEMAMix", lr=0.01, warmup_steps=3, iterations=10, clip_norm=10.0)
B, M, IMG = 2, 4, 160


def leaves_by_name(tree, col="params"):
    """{port state-dict name: numpy leaf} of a JAX tree (MaskedNode
    subtrees, which hold no leaves, are skipped); kernels in the port's
    layout."""
    flat = {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    nested = {}
    for path, leaf in flat.items():
        node = nested
        for key in path[:-1]:
            node = node.setdefault(str(key), {})
        node[str(path[-1])] = np.asarray(leaf)
    return {k: v.numpy() for k, v in jax_variables_to_state_dict({col: nested}).items()}


def port_moments(model, state, field):
    """{name: numpy} of one AdEMAMix moment across the main and bias groups."""
    names = [n for n, _ in model.named_parameters()]
    labels = opt.bias_label_fn(steps.optimizer_leaves(model))
    out = {}
    for group, st in state.opt_state[1].items():
        idx = [j for j, lab in enumerate(labels) if lab == group]
        for j, t in zip(idx, getattr(st, field)):
            out[names[j]] = t.detach().numpy().copy()
    return out


def jax_moments(opt_state, field):
    out = {}
    for inner in opt_state[1].inner_states.values():
        out.update(leaves_by_name(getattr(inner.inner_state, field)))
    return out


def make_batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(12, IMG * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    cls = rng.integers(0, 80, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    mask[0, 2] = mask[1, 3] = False
    return dict(img=img, cls=cls, bboxes=boxes, mask=mask)


@pytest.fixture(scope="module")
def runs():
    """Two JAX train steps and two port train steps from the same state."""
    jm, _ = jax_build(CFG, training=True)
    x0 = jnp.zeros((B, IMG, IMG, 3), jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x0))
    tx, _, _ = jax_opt.build_optimizer(variables["params"], **OPT_KW)
    jstate = jax_steps.TrainState.create(variables, tx)
    jstep = jax.jit(jax_steps.make_train_step(jm, tx, nc=80))
    batches = [make_batch(1), make_batch(2)]
    jax_out = []
    for batch in batches:
        jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(3))
        jax_out.append((jax.tree.map(np.asarray, jstate), jax.tree.map(float, metrics)))

    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)
    sd, ema = jax_train_state_to_torch(variables["params"], variables["batch_stats"],
                                       variables["params"])
    model.load_state_dict(sd, strict=True)
    ptx, _, _ = opt.build_optimizer(steps.optimizer_leaves(model), **OPT_KW)
    pstate = steps.TrainState.create(model, ptx)
    with torch.no_grad():
        for name, e in zip(pstate.params, pstate.ema.params):
            e.copy_(ema[name])
    pstep = steps.make_train_step(model, ptx, nc=80)
    dens = []
    fw_train = chunkwise_v2.mlstm_siging_chunkwise_fw_train

    def recording_fw_train(*a, **kw):
        out = fw_train(*a, **kw)
        dens.append(out[2][2])
        return out

    port_out = []
    chunkwise_v2.mlstm_siging_chunkwise_fw_train = recording_fw_train
    try:
        for batch in batches:
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            pstate, metrics = pstep(pstate, tb, torch.Generator().manual_seed(3))
            port_out.append((
                {n: p.detach().numpy().copy() for n, p in pstate.params.items()},
                {n: b.numpy().copy() for n, b in pstate.batch_stats.items()},
                {n: e.numpy().copy() for n, e in zip(pstate.params, pstate.ema.params)},
                {k: float(v) for k, v in metrics.items()},
                port_moments(model, pstate, "m_fast") if not port_out else None))
    finally:
        chunkwise_v2.mlstm_siging_chunkwise_fw_train = fw_train
    return dict(jax=jax_out, port=port_out, dens=dens, model=model)


def test_default_gate_init_clamps_every_denominator(runs):
    assert len(runs["dens"]) == 2 * 14  # 14 cells per step of vil-det-tiny
    assert all(bool((d == 1).all()) for d in runs["dens"])


@pytest.mark.parametrize("step", [0, 1])
def test_loss_items_match_jax(runs, step):
    ref, got = runs["jax"][step][1], runs["port"][step][3]
    assert set(got) == set(ref) == {"loss", "box_loss", "cls_loss", "dfl_loss"}
    rtol = 1e-4 if step == 0 else 1e-3
    for key in ref:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, err_msg=key)


def test_gradients_match_jax(runs):
    b1 = OPT_KW.get("momentum", 0.937)
    ref = jax_moments(runs["jax"][0][0].opt_state, "m_fast")
    got = runs["port"][0][4]
    assert set(got) == set(ref)
    g_max = max(np.abs(g).max() for g in ref.values()) / (1 - b1)
    for name in ref:
        g_ref, g = ref[name] / (1 - b1), got[name] / (1 - b1)
        atol = 2e-4 * np.abs(g_ref).max() + 1e-6 * g_max
        np.testing.assert_allclose(g, g_ref, atol=atol, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_batchnorm_statistics_match_jax(runs, step):
    ref = leaves_by_name(runs["jax"][step][0].batch_stats, col="batch_stats")
    got = runs["port"][step][1]
    assert set(got) == set(ref) and ref
    tol = 1e-4 if step == 0 else 1e-3
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_ema_matches_jax(runs, step):
    ref = leaves_by_name(runs["jax"][step][0].ema.params)
    got = runs["port"][step][2]
    assert set(got) == set(ref)
    bound = 2 * OPT_KW["lr"] * (1 + 8.0 * 2 / OPT_KW["iterations"])
    a = np.concatenate([got[n].ravel() for n in ref])
    b = np.concatenate([ref[n].ravel() for n in ref])
    atol = 1e-6 if step == 0 else 1e-4
    tight = np.abs(a - b) <= atol + 1e-5 * np.abs(b)
    assert tight.mean() >= 0.999, tight.mean()
    assert np.abs(a - b).max() <= bound
    if step == 1:  # the EMA moved on from step 1
        assert max(np.abs(got[n] - runs["port"][0][2][n]).max() for n in got) > 0


def test_decay_mask_and_bias_group_match_jax(runs):
    model = runs["model"]
    variables = {"params": runs["jax"][0][0].params}
    leaves = steps.optimizer_leaves(model)
    names = [n for n, _ in model.named_parameters()]
    got_mask = dict(zip(names, opt.decay_mask_fn(leaves)))
    got_label = dict(zip(names, opt.bias_label_fn(leaves)))
    ref_mask = jax_opt.decay_mask_fn(variables["params"])
    ref_label = jax_opt.bias_label_fn(variables["params"])
    for (path, m), lab in zip(jax.tree_util.tree_leaves_with_path(ref_mask),
                              jax.tree.leaves(ref_label)):
        name, _ = jax_path_to_name(("params",) + tuple(k.key for k in path))
        assert got_mask[name] == bool(m), name
        assert got_label[name] == lab, name
    assert len(got_mask) == len(jax.tree.leaves(ref_mask))
    assert any(got_mask.values()) and "bias" in got_label.values()


def test_optimizer_matches_jax_on_identical_gradients():
    rng = np.random.default_rng(5)
    shapes = {"dense": {"kernel": (6, 5), "bias": (5,)}, "norm": {"scale": (5,)},
              "cell": {"learnable_skip": (4,), "weight": (4,)}, "conv": {"kernel": (3, 3, 2, 4)}}
    params = {m: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    grads = [{m: {k: (rng.normal(size=s) * 5).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()} for _ in range(3)]
    tx, _, _ = jax_opt.build_optimizer(params, weight_decay=0.05, **OPT_KW)
    order = [(m, k) for m in sorted(shapes) for k in sorted(shapes[m])]  # JAX's leaf order
    leaves = [(k, len(shapes[m][k])) for m, k in order]
    ptx, _, _ = opt.build_optimizer(leaves, weight_decay=0.05, **OPT_KW)
    jp, js, jema = params, tx.init(params), jax_opt.ema_init(params)
    pp = [torch.from_numpy(params[m][k].copy()) for m, k in order]
    ps, pema = ptx.init(pp), opt.ema_init(pp)
    for g in grads:
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                           for d in g.values() for x in d.values()))
        assert norm > OPT_KW["clip_norm"]  # clipping is active
        upd, js = tx.update(g, js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        jema = jax_opt.ema_update(jema, jp)
        pu, ps = ptx.update([torch.from_numpy(g[m][k]) for m, k in order], ps, pp)
        torch._foreach_add_(pp, pu)
        pema = opt.ema_update(pema, pp)
        for j, (m, k) in enumerate(order):
            np.testing.assert_allclose(pu[j].numpy(), np.asarray(upd[m][k]), atol=1e-7, rtol=1e-5)
    for j, (m, k) in enumerate(order):
        np.testing.assert_allclose(pp[j].numpy(), np.asarray(jp[m][k]), atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(pema.params[j].numpy(), np.asarray(jema.params[m][k]),
                                   atol=1e-7, rtol=1e-5)
    for group, inner in js[1].inner_states.items():
        labels = opt.bias_label_fn(leaves)
        idx = [j for j, lab in enumerate(labels) if lab == group]
        for field in ("m_fast", "m_slow", "nu"):
            ref = [np.asarray(x) for x in jax.tree.leaves(getattr(inner.inner_state, field))]
            got = [t.numpy() for t in getattr(ps[1][group], field)]
            assert len(ref) == len(got) == len(idx)
            rtol = 1e-3 if field == "m_slow" else 1e-5
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, atol=1e-7, rtol=rtol, err_msg=field)


@pytest.mark.parametrize("kind", ["cosine", "linear", "warmup_const", "warmup_cosine"])
def test_schedules_match_jax(kind):
    """Learning-rate schedules and the EMA decay ramp at steps across the
    warmup and the run (float32 on the JAX side, a few float32 ulps: rtol =
    1e-5; the decay's 1 - exp(-n / tau) cancels in float32 at small n, so
    it is held to atol = 1e-7, about the float32 ulp of 1)."""
    def make(lib):
        if kind == "cosine":
            return lib.cosine_lr(0.01, 0.01, 3, 50, warmup_steps=20)
        if kind == "linear":
            return lib.linear_lr(0.01, 0.1, 3, 50, warmup_steps=20)
        if kind == "warmup_const":
            return lib.warmup_wrap(0.01, 20, 0.1)
        return lib.warmup_wrap(lib.cosine_lr(0.01, 0.01, 3, 50), 20, 0.0)

    ref, got = make(jax_opt), make(opt)
    for step in (0, 1, 7, 20, 33, 149, 150, 400):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5, atol=1e-12)
    for n in (1, 10, 2000, 10 ** 5):
        np.testing.assert_allclose(opt.ema_decay_at(n), float(jax_opt.ema_decay_at(jnp.asarray(n))),
                                   rtol=0, atol=1e-7)


def test_batchnorm_training_matches_flax():
    """Batch mean and flax's fast biased variance max(E[x^2] - E[x]^2, 0):
    the output and the running statistics after two updates."""
    import flax.linen as fnn

    rng = np.random.default_rng(6)
    xs = [rng.normal(3.0, 2.0, (4, 5, 5, 8)).astype(np.float32) for _ in range(2)]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    scale = rng.normal(1, 0.1, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    params, stats = {"scale": scale, "bias": bias}, variables["batch_stats"]
    port = BatchNorm(8, eps=1e-3).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.zero_()
        port.running_var.fill_(1.0)
    for x in xs:
        y_ref, mut = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              mutable=["batch_stats"])
        stats = mut["batch_stats"]
        y = port(torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)


def test_droppath_masks_repeat_under_checkpoint():
    """A rematerialised pair draws the same stochastic-depth masks in its
    recompute as in its forward, and leaves the generator where the
    forward left it."""
    pair = ViLBlockPair(16, seqlens=(4, 4), qkv_block_size=4, drop_path=0.5)
    reset_parameters(pair, torch.Generator().manual_seed(0))
    pair.train()
    x = torch.randn(4, 16, 16, generator=torch.Generator().manual_seed(1), requires_grad=True)
    grads = []
    for ckpt in (16, 10 ** 9):  # checkpointed, then not
        pair.ckpt_thresh = ckpt
        gen = torch.Generator().manual_seed(7)
        for m in pair.modules():
            if isinstance(m, DropPath):
                m.generator = gen
        out = pair(x)
        state_after_forward = gen.get_state()
        grads.append(torch.autograd.grad(out.square().sum(), x)[0])
        assert torch.equal(gen.get_state(), state_after_forward)
    torch.testing.assert_close(grads[0], grads[1])


def test_train_step_refuses_what_is_not_ported():
    model = torch.nn.Linear(2, 2)
    tx = opt.chain()
    for kw in (dict(end2end=False), dict(task="segment"), dict(kpt_shape=(17, 3)),
               dict(device_aug={"fliplr": 0.5})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            steps.make_train_step(model, tx, **kw)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.build_optimizer([("kernel", 2)], name="Lion")
