"""The port's train step of each task model against JAX's ``make_train_step(
task=...)``, on the tiny task configs at 64 px (their smallest input but
32, whose 1x1 top level leaves the assigner almost nothing), batch 2, two
steps from the same state, float32.

As in ``tests/test_torch_train_step.py`` (whose helpers and tolerances this
file uses), the gates keep their default init, where every mLSTM
denominator of the port's cells clamps to 1 (asserted), so the JAX CPU
cell's autograd through max(|.|, 1) and the port's agree; the gradient is
read from AdEMAMix's first moment after step 1.  Tolerances: loss items
rtol 1e-4 at step 1 and 1e-3 at step 2; gradients rtol 2e-4 and atol 2e-4
times each leaf's largest |g| plus 1e-6 times the largest |g| of all
leaves.  The batches are numpy from a seed: boxes with their masks
(rectangles at the prototypes' grid, imgsz / 4), keypoints about the
boxes' centres with visibilities 0-2 (K 17), rotated boxes (the boxes'
sides, angles in [0, pi/2)), class labels.  The JAX step of each task is
jitted once, in a module fixture; the test files ``..._pose``, ``..._obb``
and ``..._cls`` run the other tasks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import OPT_KW, jax_moments, port_moments
from xlstm_yolo_tpu.engine import optimizers as jax_opt
from xlstm_yolo_tpu.engine import steps as jax_steps
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu_torch.engine import optimizers as opt
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import chunkwise_v2
from xlstm_yolo_tpu_torch.utils.convert import jax_train_state_to_torch

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
CFGS = {"segment": "vil-det-tiny-seg.yaml", "pose": "vil-det-tiny-pose.yaml",
        "obb": "vil-det-tiny-obb.yaml", "classify": "vil-cls-tiny.yaml"}
NC = {"classify": 10}
B, M, IMG = 2, 4, 64
KPT = (17, 3)


def task_batch(task: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    if task == "classify":
        return dict(img=img, cls=rng.integers(0, NC["classify"], B).astype(np.int32))
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(10, IMG * 0.5, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    mask = np.ones((B, M), bool)
    mask[0, 2] = mask[1, 3] = False
    out = dict(img=img, cls=rng.integers(0, 80, (B, M)).astype(np.int32), bboxes=boxes,
               mask=mask)
    if task == "segment":
        masks = np.zeros((B, M, IMG // 4, IMG // 4), np.uint8)
        for b in range(B):
            for j in range(M):
                x1, y1, x2, y2 = (boxes[b, j] / 4).astype(int)
                masks[b, j, y1:y2 + 1, x1:x2 + 1] = 1
        out["masks"] = masks
    elif task == "pose":
        c = (boxes[..., None, :2] + boxes[..., None, 2:]) / 2
        out["kpts"] = np.concatenate([c + rng.normal(0, 5, (B, M, KPT[0], 2)),
                                      rng.integers(0, 3, (B, M, KPT[0], 1))],
                                     -1).astype(np.float32)
    elif task == "obb":
        out["rboxes"] = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2,
                                        boxes[..., 2:] - boxes[..., :2],
                                        rng.uniform(0, np.pi / 2, (B, M, 1))],
                                       -1).astype(np.float32)
    return out


def run_task(task: str) -> dict:
    """Two JAX train steps and two port train steps of ``task`` from the
    same state: JAX's (state, metrics) and the port's (metrics, first
    moments after step 1, the cells' denominators, terms)."""
    kpt = KPT if task == "pose" else None
    nc = NC.get(task, 80)
    jm, _ = jax_build(CFG / CFGS[task], training=True, kpt_shape=kpt)
    x0 = jnp.zeros((B, IMG, IMG, 3), jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x0))
    tx, _, _ = jax_opt.build_optimizer(variables["params"], **OPT_KW)
    jstate = jax_steps.TrainState.create(variables, tx)
    jstep = jax.jit(jax_steps.make_train_step(jm, tx, nc=nc, task=task, kpt_shape=kpt))
    batches = [task_batch(task, 1), task_batch(task, 2)]
    jax_out = []
    for batch in batches:
        jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(3))
        jax_out.append((jax.tree.map(np.asarray, jstate), jax.tree.map(float, metrics)))

    model, _ = build_detection_model(CFGS[task], device="cpu", training=True, kpt_shape=kpt)
    sd, _ = jax_train_state_to_torch(variables["params"], variables["batch_stats"],
                                     variables["params"])
    model.load_state_dict(sd, strict=True)
    ptx, _, _ = opt.build_optimizer(steps.optimizer_leaves(model), **OPT_KW)
    pstate = steps.TrainState.create(model, ptx)
    pstep = steps.make_train_step(model, ptx, nc=nc, task=task, kpt_shape=kpt)
    dens, port_out = [], []
    fw_train = chunkwise_v2.mlstm_siging_chunkwise_fw_train

    def recording_fw_train(*a, **kw):
        out = fw_train(*a, **kw)
        dens.append(out[2][2])
        return out

    chunkwise_v2.mlstm_siging_chunkwise_fw_train = recording_fw_train
    try:
        for batch in batches:
            pstate, metrics = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    torch.Generator().manual_seed(3))
            port_out.append(({k: float(v) for k, v in metrics.items()},
                             port_moments(model, pstate, "m_fast") if not port_out else None,
                             {k: float(v) for k, v in pstep.terms.items()}))
    finally:
        chunkwise_v2.mlstm_siging_chunkwise_fw_train = fw_train
    return dict(jax=jax_out, port=port_out, dens=dens, task=task)


def check_denominators(runs):
    cells = {"classify": 4}.get(runs["task"], 14)
    assert len(runs["dens"]) == 2 * cells
    assert all(bool((d == 1).all()) for d in runs["dens"])


def check_loss_items(runs, step):
    ref, (got, _, terms) = runs["jax"][step][1], runs["port"][step]
    assert set(got) == set(ref) == {"loss", "box_loss", "cls_loss", "dfl_loss"}
    rtol = 1e-4 if step == 0 else 1e-3
    for key in ref:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, err_msg=key)
    own = {"segment": ("seg",), "pose": ("pose", "kobj"), "obb": ("box",),
           "classify": ("cls",)}[runs["task"]]
    assert set(terms) == set(own) and all(np.isfinite(v) and v > 0 for v in terms.values())
    assert got["loss"] > 0


def check_gradients(runs):
    b1 = OPT_KW.get("momentum", 0.937)
    ref = jax_moments(runs["jax"][0][0].opt_state, "m_fast")
    got = runs["port"][0][1]
    assert set(got) == set(ref)
    g_max = max(np.abs(g).max() for g in ref.values()) / (1 - b1)
    for name in ref:
        g_ref, g = ref[name] / (1 - b1), got[name] / (1 - b1)
        atol = 2e-4 * np.abs(g_ref).max() + 1e-6 * g_max
        np.testing.assert_allclose(g, g_ref, atol=atol, rtol=2e-4, err_msg=name)
    head = {n: v for n, v in ref.items() if n.startswith("model.")}
    assert max(np.abs(v).max() for v in head.values()) > 0


@pytest.fixture(scope="module")
def runs():
    return run_task("segment")


def test_segment_denominators_clamp(runs):
    check_denominators(runs)


@pytest.mark.parametrize("step", [0, 1])
def test_segment_loss_items_match_jax(runs, step):
    check_loss_items(runs, step)


def test_segment_gradients_match_jax(runs):
    check_gradients(runs)


@pytest.mark.parametrize("shape", [(16, 16, 12, 12), (16, 16, 20, 20), (40, 40, 32, 32),
                                   (40, 40, 48, 48), (160, 160, 128, 128), (30, 50, 37, 19)])
def test_nearest_resize_matches_jax(shape):
    """The gt masks' resize at a multi-scale bucket: JAX's ``"nearest"``
    (``floor((j + 0.5) * in / out)``, not ``F.interpolate``'s nearest)."""
    from xlstm_yolo_tpu_torch.utils.resize import resize

    h, w, oh, ow = shape
    x = (np.random.default_rng(h * w).uniform(size=(2, 3, h, w)) < 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, oh, ow), "nearest"))
    got = resize(torch.from_numpy(x), (2, 3, oh, ow), "nearest").numpy()
    np.testing.assert_array_equal(got, ref)


def test_rescale_task_batch_scales_task_geometry_as_jax():
    b = {**task_batch("pose", 4), **{k: v for k, v in task_batch("obb", 4).items()
                                     if k == "rboxes"}}
    out = steps.rescale_task_batch({k: torch.from_numpy(v) for k, v in b.items()}, 96)
    sf = 96 / IMG
    assert out["img"].shape == (B, 96, 96, 3)
    np.testing.assert_array_equal(out["bboxes"].numpy(), b["bboxes"] * sf)
    np.testing.assert_array_equal(out["kpts"][..., :2].numpy(), b["kpts"][..., :2] * sf)
    np.testing.assert_array_equal(out["kpts"][..., 2].numpy(), b["kpts"][..., 2])
    np.testing.assert_array_equal(out["rboxes"][..., :4].numpy(), b["rboxes"][..., :4] * sf)
    np.testing.assert_array_equal(out["rboxes"][..., 4].numpy(), b["rboxes"][..., 4])
