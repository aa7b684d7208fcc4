"""The port's CIoU, task-aligned assigner and detection losses against the
JAX package's, on the same numpy inputs made from a seed, float32.

Maps are random per-level (B, h, w, nc + 64) tensors; gts are padded per
image with some slots masked.  Tolerances: values atol = 1e-6 plus rtol =
1e-5 (float32, the same operations in another order); assignments exactly
(masks, indices, labels); gradients with respect to the maps atol = 1e-5
times the largest |g| plus rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.utils import loss as jax_loss
from xlstm_yolo_tpu.utils import metrics as jax_metrics
from xlstm_yolo_tpu.utils import tal as jax_tal
from xlstm_yolo_tpu_torch.utils import loss, metrics, tal

NC, REG = 80, 16
IMG = 64
STRIDES = (8.0, 16.0, 32.0)
B, M = 2, 5


def gts(rng):
    """Padded gts: xyxy boxes inside the image, labels, validity (one
    masked slot per image, and one image with a box that holds no anchor
    centre)."""
    xy = rng.uniform(0, IMG * 0.6, (B, M, 2))
    wh = rng.uniform(6, IMG * 0.5, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    boxes[1, 0] = [1.0, 1.0, 2.5, 2.5]  # no anchor centre inside
    labels = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    mask[0, 3] = mask[1, 4] = False
    return labels, boxes, mask


def feats(rng):
    return [(rng.normal(size=(B, IMG // int(s), IMG // int(s), NC + 4 * REG)) * 2.0)
            .astype(np.float32) for s in STRIDES]


def close(a, b, atol=1e-6, rtol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol, err_msg=name)


def test_ciou_values_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    b1 = np.concatenate([rng.uniform(0, 50, (64, 2)), rng.uniform(50, 100, (64, 2))], -1)
    b2 = b1 + rng.normal(0, 8, b1.shape)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda a, b: jnp.sum(jax_metrics.bbox_iou(a, b, xywh=False, kind="ciou") ** 2),
        argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = (torch.from_numpy(b).requires_grad_() for b in (b1, b2))
    val = (metrics.bbox_iou(t1, t2, xywh=False, kind="ciou") ** 2).sum()
    got = torch.autograd.grad(val, [t1, t2])
    close(val.item(), float(ref))
    for a, b in zip(got, g_ref):
        close(a.numpy(), b, atol=1e-5, rtol=1e-4)
    for kind in ("iou", "giou", "diou"):
        close(metrics.bbox_iou(t1, t2, kind=kind).detach().numpy(),
              jax_metrics.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), kind=kind), name=kind)


@pytest.mark.parametrize("topk", [1, 3, 10])
def test_topk_select_mask_breaks_ties_like_jax(topk):
    """Metrics full of ties (mostly 0, as at init): the lowest index wins,
    as with lax.top_k; the selected set equals JAX's exactly."""
    rng = np.random.default_rng(topk)
    metric = rng.choice([0.0, 0.0, 0.0, 0.25, 0.5], size=(2, 4, 40)).astype(np.float32)
    metric[0, 0] = 0.0  # all tied
    got = tal.topk_select_mask(torch.from_numpy(metric), topk).numpy()
    ref = np.asarray(jax_tal.topk_select_mask(jnp.asarray(metric), topk))
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) == topk).all()
    np.testing.assert_array_equal(np.nonzero(got[0, 0])[0], np.arange(topk))


@pytest.mark.parametrize("topk", [1, 10])
def test_task_aligned_assign_matches_jax(topk):
    rng = np.random.default_rng(7)
    labels, boxes, mask = gts(rng)
    A = sum((IMG // int(s)) ** 2 for s in STRIDES)
    anc, st = tal.make_anchors([(IMG // int(s),) * 2 for s in STRIDES], STRIDES)
    anc_img = (anc * st).numpy()
    centre = anc_img[None] + rng.normal(0, 4, (B, A, 2))
    half = rng.uniform(2, 16, (B, A, 2))
    pd_boxes = np.concatenate([centre - half, centre + half], -1).astype(np.float32)
    pd_scores = rng.uniform(0, 1, (B, A, NC)).astype(np.float32)
    args = (pd_scores, pd_boxes, anc_img, labels, boxes, mask)
    ref = jax_tal.task_aligned_assign(*map(jnp.asarray, args), topk=topk, num_classes=NC)
    got = tal.task_aligned_assign(*map(torch.from_numpy, args), topk=topk, num_classes=NC)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    assert got.fg_mask.any()
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(ref.target_labels))
    close(got.target_bboxes.numpy(), ref.target_bboxes)
    close(got.target_scores.numpy(), ref.target_scores)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(9)
    anc = rng.uniform(0, 8, (50, 2)).astype(np.float32)
    box = np.concatenate([anc - rng.uniform(-2, 20, (50, 2)),
                          anc + rng.uniform(-2, 20, (50, 2))], -1).astype(np.float32)
    close(tal.bbox2dist(torch.from_numpy(anc), torch.from_numpy(box), REG - 1).numpy(),
          jax_tal.bbox2dist(jnp.asarray(anc), jnp.asarray(box), REG - 1))


@pytest.mark.parametrize("kind", ["v8", "e2e"])
def test_detection_loss_and_its_gradient_match_jax(kind):
    rng = np.random.default_rng(21)
    labels, boxes, mask = gts(rng)
    one2many, one2one = feats(rng), feats(rng)

    def jax_fn(m, o):
        if kind == "v8":
            return jax_loss.v8_detection_loss(m, labels, boxes, mask, STRIDES, nc=NC)
        return jax_loss.e2e_detect_loss({"one2many": m, "one2one": o}, labels, boxes, mask,
                                        STRIDES, nc=NC)

    (total_ref, items_ref), g_ref = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in one2many], [jnp.asarray(f) for f in one2one])

    tm = [torch.from_numpy(f).requires_grad_() for f in one2many]
    to = [torch.from_numpy(f).requires_grad_() for f in one2one]
    targets = (torch.from_numpy(labels), torch.from_numpy(boxes), torch.from_numpy(mask))
    if kind == "v8":
        total, items = loss.v8_detection_loss(tm, *targets, STRIDES, nc=NC)
    else:
        total, items = loss.e2e_detect_loss({"one2many": tm, "one2one": to}, *targets,
                                            STRIDES, nc=NC)
    close(total.item(), float(total_ref), name="total")
    for name, a, b in zip(("box", "cls", "dfl"), items, items_ref):
        assert float(b) > 0, name
        close(a.item(), float(b), name=name)
    got = torch.autograd.grad(total, tm + to, allow_unused=True)
    ref = list(g_ref[0]) + list(g_ref[1])
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for j, (a, b) in enumerate(zip(got, ref)):
        a = np.zeros(np.shape(b), np.float32) if a is None else a.numpy()
        close(a, b, atol=1e-5 * scale, rtol=1e-4, name=f"map {j}")
