"""The port's trainer on the CPU: accumulation, checkpoints, the trainer
end to end on ``vil-det-tiny``, resume, the refusals; and, marked slow,
accumulation and the trainer held against the JAX package's.

- Accumulation (port only): a step of accumulate 2 hands the optimizer
  the sum of the two microbatches' gradients, each taken from the
  BatchNorm statistics the one before left, bit for bit; its loss is the
  sum and its items the last microbatch's.  Slow: the same step against
  JAX's ``make_train_step(accumulate=2)`` from the same converted weights,
  in ``tests/test_torch_train_step.py``'s float32 tolerances (the JAX step
  is a jit of about 80 s, and the test takes about 140 s).
- Checkpoints: ``load_checkpoint(save_checkpoint(state))`` gives back every
  tensor bit for bit, and the step, epoch, best fitness and generator.
- The trainer on ``vil-det-tiny`` (8 train and 4 val PNG files, batch 2,
  ``nbs`` 4, so accumulate 2; 2 epochs, float32): ``results.csv`` with 2
  rows, ``last``, ``best`` and their stripped state dicts, which load
  strictly into a tiny detector; a resume from the checkpoint of epoch 1
  reads the same files a step and ends bit-equal to the uninterrupted run
  (parameters, EMA, BatchNorm statistics, optimizer state).
- The refusals name their ROADMAP items.
- Slow: the port's trainer against JAX's ``DetectionTrainer`` for one epoch
  of 2 steps (16 images, batch 8) from the same weights (a ``.pt`` given to both through
  ``pretrained=``): the final parameters and EMA, read from JAX's orbax
  ``weights/last``.
"""

import copy
import random
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_loader import one_thread, write_train_set  # noqa: F401
from xlstm_yolo_tpu_torch.engine import optimizers as opt
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.engine.model import load_checkpoint_state
from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils import checkpoint

B, M, IMG = 2, 4, 160


def make_batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(12, IMG * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    cls = rng.integers(0, 80, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    mask[0, 2] = False
    return {k: torch.from_numpy(v) for k, v in dict(img=img, cls=cls, bboxes=boxes,
                                                     mask=mask).items()}


def recording_tx(seen: list) -> opt.Transform:
    """Keeps the gradients it is given and updates nothing."""
    def update(grads, state, params):
        seen.append([g.clone() for g in grads])
        return [torch.zeros_like(g) for g in grads], state
    return opt.Transform(lambda params: (), update)


def test_accumulation_sums_microbatch_gradients():
    b1, b2 = make_batch(1), make_batch(2)
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)
    twin = copy.deepcopy(model)
    acc_seen, one_seen = [], []
    tx = recording_tx(acc_seen)
    acc = steps.make_train_step(model, tx, accumulate=2)
    state, metrics = acc(steps.TrainState.create(model, tx),
                         {k: torch.stack([b1[k], b2[k]]) for k in b1})
    tx1 = recording_tx(one_seen)
    single = steps.make_train_step(twin, tx1)
    st1 = steps.TrainState.create(twin, tx1)
    st1, m1 = single(st1, b1)
    st1, m2 = single(st1, b2)
    assert state.step == 1 and st1.step == 2
    for a, g1, g2 in zip(acc_seen[0], one_seen[0], one_seen[1]):
        assert torch.equal(a, g1 + g2)
    assert torch.equal(metrics["loss"], m1["loss"] + m2["loss"])
    for key in ("box_loss", "cls_loss", "dfl_loss"):
        assert torch.equal(metrics[key], m2[key])
    for name, stat in state.batch_stats.items():
        assert torch.equal(stat, st1.batch_stats[name]), name
    assert any(not torch.equal(s, torch.zeros_like(s)) for s in state.batch_stats.values())


@pytest.fixture(scope="module")
def tiny_model():
    return build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)[0]


@pytest.mark.parametrize("name", ["AdEMAMix", "SGD"])
def test_checkpoint_round_trip_is_bit_equal(tmp_path, tiny_model, name):
    model = copy.deepcopy(tiny_model)
    leaves = steps.optimizer_leaves(model)
    tx, _, _ = opt.build_optimizer(leaves, name=name, warmup_steps=3, iterations=10)
    state = steps.TrainState.create(model, tx)
    gen = torch.Generator().manual_seed(5)
    rng = torch.Generator().manual_seed(1)
    params = list(state.params.values())
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=rng) for p in params]
        upd, state.opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(params, upd)
        state.ema = opt.ema_update(state.ema, params)
        state.step += 1
    with torch.no_grad():
        for b in state.batch_stats.values():
            b.add_(torch.rand(b.shape, generator=rng))
    torch.rand(3, generator=gen)
    path = checkpoint.save_checkpoint(tmp_path / "last.pt", state, 4, 0.25, {"epochs": 9}, gen)
    ref = {"params": {n: p.detach().clone() for n, p in state.params.items()},
           "stats": {n: b.clone() for n, b in state.batch_stats.items()},
           "ema": [e.clone() for e in state.ema.params],
           "opt": [x.clone() if torch.is_tensor(x) else x
                   for x in checkpoint._leaves(state.opt_state)],
           "gen": gen.get_state()}

    model2 = copy.deepcopy(tiny_model)
    state2 = steps.TrainState.create(model2, tx)
    gen2 = torch.Generator().manual_seed(0)
    state2, start, best = checkpoint.load_checkpoint(path, state2, gen2)
    assert (state2.step, start, best, state2.ema.updates) == (2, 5, 0.25, 2)
    assert torch.equal(gen2.get_state(), ref["gen"])
    for n, p in state2.params.items():
        assert torch.equal(p, ref["params"][n]), n
        assert p is dict(model2.named_parameters())[n]  # restored in place
    for n, b in state2.batch_stats.items():
        assert torch.equal(b, ref["stats"][n]), n
    for a, b in zip(state2.ema.params, ref["ema"]):
        assert torch.equal(a, b)
    got = checkpoint._leaves(state2.opt_state)
    assert len(got) == len(ref["opt"]) and any(torch.is_tensor(x) for x in got)
    for a, b in zip(got, ref["opt"]):
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b

    stripped = checkpoint.strip_optimizer(path)
    assert stripped.name == "last_stripped.pt"
    fresh = copy.deepcopy(tiny_model)
    fresh.load_state_dict(load_checkpoint_state(stripped, fresh), strict=True)
    for n, e in zip(state.params, ref["ema"]):
        assert torch.equal(fresh.state_dict()[n], e)


def tiny_set(root: Path) -> Path:
    data = write_train_set(root, 8, seed=1, split="train")
    write_train_set(root, 4, seed=2, split="val")
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images/train",
                                    "val": "images/val", "names": [f"c{i}" for i in range(5)]}))
    return data


TINY = dict(epochs=2, batch=2, nbs=4, workers=0, imgsz=160, amp=False, close_mosaic=1,
            optimizer="AdEMAMix", exist_ok=True)


def trainer(data, root, name, **kw):
    return DetectionTrainer(overrides={"data": str(data), "project": str(root), "name": name,
                                       **TINY, **kw},
                            model_cfg="vil-det-tiny.yaml", device="cpu")


def flat_state(state):
    return ([p.detach().clone() for p in state.params.values()]
            + [b.clone() for b in state.batch_stats.values()]
            + [e.clone() for e in state.ema.params]
            + [x.clone() if torch.is_tensor(x) else x for x in checkpoint._leaves(state.opt_state)])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinytrain")
    data = tiny_set(root)
    t = trainer(data, root, "full")
    snap = root / "snap"

    def snapshot(tr):
        if tr.epoch == 0:
            shutil.copytree(tr.wdir, snap / "weights")
            shutil.copy(tr.csv_path, snap / "results.csv")

    t.callbacks.add("on_fit_epoch_end", snapshot)
    files = []
    t.callbacks.add("on_train_batch_end", lambda tr: files.append(tr.step_files[-1]))
    metrics = t.train()
    return dict(root=root, data=data, trainer=t, metrics=metrics, files=files)


def test_tiny_trainer_writes_results_and_weights(tiny_run):
    t = tiny_run["trainer"]
    assert t.accumulate == 2 and len(tiny_run["files"]) == 4  # 2 steps an epoch
    rows = (t.save_dir / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("epoch,loss,box_loss")
    for f in ("last.pt", "best.pt", "last_stripped.pt", "best_stripped.pt"):
        assert (t.wdir / f).is_file(), f
    assert all(np.isfinite(list(t.metrics.values())))
    assert t.state.step == 4 and t.state.ema.updates == 4
    model, _ = build_detection_model("vil-det-tiny.yaml", nc=5, device="cpu")
    model.load_state_dict(load_checkpoint_state(t.wdir / "best_stripped.pt", model), strict=True)
    best = checkpoint.read_checkpoint(t.wdir / "best.pt")
    for n, e in best["ema_params"].items():
        assert torch.equal(model.state_dict()[n], e)


def test_tiny_resume_ends_bit_equal(tiny_run):
    root = tiny_run["root"]
    t2 = trainer(tiny_run["data"], root, "snap", resume=True)
    files = []
    t2.callbacks.add("on_train_batch_end", lambda tr: files.append(tr.step_files[-1]))
    metrics = t2.train()
    assert t2.start_epoch == 1 and files == tiny_run["files"][2:]
    full = flat_state(tiny_run["trainer"].state)
    resumed = flat_state(t2.state)
    assert len(full) == len(resumed)
    for a, b in zip(full, resumed):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert metrics == tiny_run["metrics"]
    assert len((root / "snap" / "results.csv").read_text().splitlines()) == 3


@pytest.mark.parametrize("kw,item", [
    (dict(task="segment"), "item 10"), (dict(pretrained="weights_dir"), "item 7"),
    ("device_aug", "item 12")])
def test_trainer_refusals_name_their_items(tiny_run, tmp_path, kw, item):
    if kw == "device_aug":
        t = trainer(tiny_run["data"], tmp_path, "r")
        t.args = SimpleNamespace(**{**vars(t.args), "device_aug": True})
    else:
        t = trainer(tiny_run["data"], tmp_path, "r", **kw)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        t.train()


# ---------------------------------------------------------------------------
# against JAX (slow)


@pytest.mark.slow
def test_accumulation_matches_jax():
    import jax
    import jax.numpy as jnp

    from test_torch_train_step import CFG, OPT_KW, jax_moments, leaves_by_name, port_moments
    from xlstm_yolo_tpu.engine import optimizers as jax_opt
    from xlstm_yolo_tpu.engine import steps as jax_steps
    from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
    from xlstm_yolo_tpu_torch.utils.convert import jax_train_state_to_torch

    b1, b2 = make_batch(1), make_batch(2)
    stacked = {k: np.stack([b1[k].numpy(), b2[k].numpy()]) for k in b1}
    jm, _ = jax_build(CFG, training=True)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((B, IMG, IMG, 3), jnp.float32)))
    tx, _, _ = jax_opt.build_optimizer(variables["params"], **OPT_KW)
    jstate = jax_steps.TrainState.create(variables, tx)
    jstep = jax.jit(jax_steps.make_train_step(jm, tx, nc=80, accumulate=2))
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in stacked.items()},
                             jax.random.PRNGKey(3))

    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)
    sd, _ = jax_train_state_to_torch(variables["params"], variables["batch_stats"],
                                     variables["params"])
    model.load_state_dict(sd, strict=True)
    ptx, _, _ = opt.build_optimizer(steps.optimizer_leaves(model), **OPT_KW)
    pstate = steps.TrainState.create(model, ptx)
    pstep = steps.make_train_step(model, ptx, nc=80, accumulate=2)
    pstate, pmetrics = pstep(pstate, {k: torch.from_numpy(v) for k, v in stacked.items()},
                             torch.Generator().manual_seed(3))
    for key in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(pmetrics[key]), float(jmetrics[key]), rtol=1e-4,
                                   err_msg=key)
    b1m = OPT_KW.get("momentum", 0.937)
    ref = jax_moments(jstate.opt_state, "m_fast")
    got = port_moments(model, pstate, "m_fast")
    g_max = max(np.abs(g).max() for g in ref.values()) / (1 - b1m)
    for name in ref:
        g_ref, g = ref[name] / (1 - b1m), got[name] / (1 - b1m)
        atol = 2e-4 * np.abs(g_ref).max() + 1e-6 * g_max
        np.testing.assert_allclose(g, g_ref, atol=atol, rtol=2e-4, err_msg=name)
    ref_bs = leaves_by_name(jstate.batch_stats, col="batch_stats")
    for name, stat in pstate.batch_stats.items():
        np.testing.assert_allclose(stat.numpy(), ref_bs[name], atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.slow
def test_trainer_matches_jax(tmp_path):
    import orbax.checkpoint as ocp

    from xlstm_yolo_tpu.cfg import get_cfg as jax_get_cfg
    from xlstm_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
    from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

    data = write_train_set(tmp_path / "set", 16, seed=1)
    model, _ = build_detection_model("vil-det-tiny.yaml", nc=5, device="cpu",
                                     generator=torch.Generator().manual_seed(3))
    pt = tmp_path / "init.pt"
    torch.save({"model": model.state_dict()}, pt)  # JAX reads "ema" or "model"
    # batch 8: the tests' JAX runs on 8 CPU devices, and its trainer rounds
    # the batch to a multiple of them
    kw = dict(data=str(data), epochs=1, batch=8, nbs=8, workers=1, imgsz=160, amp=False,
              optimizer="AdEMAMix", plots=False, exist_ok=True, close_mosaic=0)
    jargs = jax_get_cfg(overrides={**kw, "project": str(tmp_path), "name": "jax"})
    jargs.pretrained = str(pt)  # get_cfg would coerce the path to False
    jt = JaxTrainer(cfg=jargs, model_cfg=str(Path(__file__).resolve().parents[1]
                                              / "xlstm_yolo_tpu" / "cfg" / "models"
                                              / "vil-det-tiny.yaml"))
    jt.train()
    kw["pretrained"] = str(pt)
    pt_trainer = DetectionTrainer(overrides={**kw, "project": str(tmp_path), "name": "port"},
                                  model_cfg="vil-det-tiny.yaml", device="cpu")
    pt_trainer.train()
    tree = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax" / "weights" / "last"))
    ref = jax_variables_to_state_dict({"params": tree["params"]})
    ref_ema = jax_variables_to_state_dict({"params": tree["ema_params"]})
    st = pt_trainer.state
    assert st.step == int(tree["step"]) == 2
    init = model.state_dict()
    # the two warmup steps move a parameter by ~5e-5 in all, so a learning
    # rate 10% off moves nearly every one by ~5e-6, past the 99.9th
    # percentile's limit, and a bias group at the SGD warmup lr moves the
    # biases far past the largest step.  Where the true gradient is 0 (a
    # bias ahead of a norm) or near it, AdEMAMix's normalisation makes a
    # full step of rounding, of either sign, so such a parameter may part
    # by up to two of the largest steps; there are ~200 of them.
    for what, got, want in (("params", dict(st.params), ref),
                            ("ema", dict(zip(st.params, st.ema.params)), ref_ema)):
        a = np.concatenate([got[n].detach().numpy().ravel() for n in want])
        b = np.concatenate([want[n].numpy().ravel() for n in want])
        moved = np.abs(b - np.concatenate([init[n].numpy().ravel() for n in want]))
        d = np.abs(a - b)
        print(f"{what}: max |port - jax| {d.max():.3g}, 99.9th percentile "
              f"{np.quantile(d, 0.999):.3g}; JAX's update: max {moved.max():.3g}, median "
              f"{np.median(moved):.3g}")
        assert np.quantile(moved, 0.5) >= 1e-5  # the steps moved the parameters
        assert np.quantile(d, 0.999) <= 1e-6
        assert d.max() <= 2 * moved.max()
    random.seed(0)
