"""The rotated assigner and the four task losses against the JAX package's,
on the same numpy inputs made from a seed, float32.

Maps are random per-level (B, h, w, nc + 64) tensors with the task's extra
outputs (mask coefficients and prototypes, keypoints, angles, class
logits); gts are padded per image with masked slots.  Tolerances (float32,
the same operations in another order): values atol = 1e-6 plus rtol =
1e-5; the assignment exactly; gradients with respect to every input
atol = 1e-5 times the largest |g| plus rtol = 1e-5.  One segmentation case
has more than ``seg_k`` (256) foreground anchors an image, so that its
static top-k selection (ties to the lower anchor, ``lax.top_k``'s order)
picks among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.utils import loss as jax_loss
from xlstm_yolo_tpu.utils import tal as jax_tal
from xlstm_yolo_tpu_torch.utils import loss, tal

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

NC, REG = 3, 16
STRIDES = (8.0, 16.0, 32.0)
B = 2


def close(a, b, atol=1e-6, rtol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol, err_msg=name)


def feats(rng, img, nc=NC):
    return [(rng.normal(size=(B, img // int(s), img // int(s), nc + 4 * REG)) * 2.0)
            .astype(np.float32) for s in STRIDES]


def anchors(img):
    return sum((img // int(s)) ** 2 for s in STRIDES)


def gts(rng, img, m, grid: bool = False):
    """Padded xyxy gts, two slots masked; ``grid``: m = n * n boxes tiling
    the image, each its cell shrunk by up to 2 px a side (every anchor
    inside one box: about A foreground anchors)."""
    if grid:
        n = int(round(m ** 0.5))
        c = img / n
        ij = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 2)
        lo = ij[None] * c + rng.uniform(0, 2, (B, m, 2))
        hi = (ij[None] + 1) * c - rng.uniform(0, 2, (B, m, 2))
        boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    else:
        xy = rng.uniform(0, img * 0.6, (B, m, 2))
        wh = rng.uniform(6, img * 0.5, (B, m, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, img)], -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, m)).astype(np.int32)
    mask = np.ones((B, m), bool)
    mask[0, m - 2] = mask[1, m - 1] = False
    return labels, boxes, mask


def rboxes(rng, img, m):
    """xywhr gts: centres inside, sides 1-40 px (some under 2 px, which the
    loss drops), angles in [0, pi/2)."""
    r = np.concatenate([rng.uniform(8, img - 8, (B, m, 2)), rng.uniform(1, 40, (B, m, 2)),
                        rng.uniform(0, np.pi / 2, (B, m, 1))], -1).astype(np.float32)
    r[0, 1, 2] = 1.5  # under 2 px wide: dropped
    return r


def grads_close(g_ref, g, name):
    scale = max(np.abs(np.asarray(x)).max() for x in jax.tree.leaves(g_ref))
    for a, b in zip(jax.tree.leaves(g_ref), g):
        close(b, a, atol=1e-5 * scale, rtol=1e-5, name=name)


# ---------------------------------------------------------------------------
# the rotated assigner


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_candidates_and_assignment_match_jax(seed):
    rng = np.random.default_rng(seed)
    img, m = 64, 6
    A = anchors(img)
    anc, st = jax_tal.make_anchors([(img // int(s),) * 2 for s in STRIDES], STRIDES)
    anc_px = np.asarray(anc * st, np.float32)
    gt = rboxes(rng, img, m)
    got = tal._candidates_in_rotated_gts(torch.from_numpy(anc_px), torch.from_numpy(gt))
    ref = jax_tal._candidates_in_rotated_gts(jnp.asarray(anc_px), jnp.asarray(gt))
    assert got.shape == (B, m, A) and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    scores = rng.uniform(0, 1, (B, A, NC)).astype(np.float32)
    pd = np.concatenate([anc_px[None].repeat(B, 0) + rng.normal(0, 3, (B, A, 2)),
                         rng.uniform(4, 40, (B, A, 2)), rng.uniform(0, np.pi / 2, (B, A, 1))],
                        -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, m)).astype(np.int32)
    mask = np.ones((B, m), bool)
    mask[1, 2] = False
    args = (scores, pd, anc_px, labels, gt, mask)
    r = jax_tal.task_aligned_assign(*map(jnp.asarray, args), topk=10, num_classes=NC,
                                    rotated=True)
    g = tal.task_aligned_assign(*map(torch.from_numpy, args), topk=10, num_classes=NC,
                                rotated=True)
    assert g.target_bboxes.shape == (B, A, 5) and bool(g.fg_mask.any())
    np.testing.assert_array_equal(g.fg_mask.numpy(), np.asarray(r.fg_mask))
    np.testing.assert_array_equal(g.target_gt_idx.numpy(), np.asarray(r.target_gt_idx))
    np.testing.assert_array_equal(g.target_labels.numpy(), np.asarray(r.target_labels))
    close(g.target_bboxes, r.target_bboxes, name="target_bboxes")
    close(g.target_scores, r.target_scores, name="target_scores")


# ---------------------------------------------------------------------------
# the losses: values and gradients


def _to_torch(xs):
    return [torch.from_numpy(x).requires_grad_(x.dtype == np.float32) for x in xs]


def test_obb_loss_matches_jax():
    rng = np.random.default_rng(2)
    img, m = 64, 6
    f = feats(rng, img)
    angle = rng.uniform(-0.3, 1.8, (B, anchors(img), 1)).astype(np.float32)
    labels, _, mask = gts(rng, img, m)
    gt = rboxes(rng, img, m)

    def jfn(f, angle):
        return jax_loss.v8_obb_loss({"one2many": f, "angle": angle}, jnp.asarray(labels),
                                    jnp.asarray(gt), jnp.asarray(mask), STRIDES, nc=NC)

    (ref, ref_items), g_ref = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in f], jnp.asarray(angle))
    tf, ta = _to_torch(f), _to_torch([angle])[0]
    got, items = loss.v8_obb_loss({"one2many": tf, "angle": ta}, torch.from_numpy(labels),
                                  torch.from_numpy(gt), torch.from_numpy(mask), STRIDES, nc=NC)
    close(got.item(), float(ref), name="total")
    for a, b in zip(items, ref_items):
        close(a.item(), float(b))
    assert items.box.item() > 0
    grads_close(g_ref, torch.autograd.grad(got, tf + [ta]), "obb grads")


def test_classification_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(8, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    (ref, _), g_ref = jax.value_and_grad(
        lambda x: jax_loss.v8_classification_loss(x, jnp.asarray(labels)), has_aux=True)(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got, got2 = loss.v8_classification_loss(t, torch.from_numpy(labels))
    assert got is got2
    close(got.item(), float(ref))
    grads_close([g_ref], torch.autograd.grad(got, [t]), "classify grads")


SEG_CASES = {"few": (64, 5, False), "over_seg_k": (192, 64, True)}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmentation_loss_matches_jax(case):
    img, m, grid = SEG_CASES[case]
    rng = np.random.default_rng(4)
    nm, Hm = 8, img // 4
    A = anchors(img)
    f = feats(rng, img)
    mc = rng.normal(size=(B, A, nm)).astype(np.float32)
    proto = rng.normal(size=(B, Hm, Hm, nm)).astype(np.float32)
    labels, boxes, mask = gts(rng, img, m, grid)
    gmask = (rng.uniform(size=(B, m, Hm, Hm)) < 0.4).astype(np.float32)

    fg = np.asarray(jax_loss.v8_detection_loss(
        [jnp.asarray(x) for x in f], jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask),
        STRIDES, nc=NC, return_aux=True)[2]["assign"].fg_mask).sum(-1)
    assert (fg.min() > 256) == (case == "over_seg_k"), fg

    def jfn(f, mc, proto):
        preds = {"one2many": f, "mask_coeffs": mc, "proto": proto}
        total, items, seg = jax_loss.v8_segmentation_loss(
            preds, jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask),
            jnp.asarray(gmask), STRIDES, img_size=img, nc=NC)
        return total, (items, seg)

    (ref, (ref_items, ref_seg)), g_ref = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)([jnp.asarray(x) for x in f], jnp.asarray(mc),
                                              jnp.asarray(proto))
    tf, tmc, tp = _to_torch(f), *_to_torch([mc, proto])
    got, items, seg = loss.v8_segmentation_loss(
        {"one2many": tf, "mask_coeffs": tmc, "proto": tp}, torch.from_numpy(labels),
        torch.from_numpy(boxes), torch.from_numpy(mask), torch.from_numpy(gmask), STRIDES,
        img_size=img, nc=NC)
    close(got.item(), float(ref), name="total")
    close(seg.item(), float(ref_seg), name="seg")
    for a, b in zip(items, ref_items):
        close(a.item(), float(b))
    assert seg.item() > 0
    grads_close(g_ref, torch.autograd.grad(got, tf + [tmc, tp]), "seg grads")


def test_top_k_stable_breaks_ties_as_lax():
    x = np.array([[0.0, 2.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0]] * 2, np.float32)
    x[1] = x[1][::-1]
    v, i = loss.top_k_stable(torch.from_numpy(x), 5)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("kpt_shape", [(17, 3), (4, 3), (5, 2)])
def test_pose_loss_matches_jax(kpt_shape):
    rng = np.random.default_rng(5)
    img, m = 64, 5
    K, nd = kpt_shape
    A = anchors(img)
    f = feats(rng, img)
    kp = (rng.normal(size=(B, A, K * nd)) * 0.5).astype(np.float32)
    labels, boxes, mask = gts(rng, img, m)
    cxy = (boxes[..., None, :2] + boxes[..., None, 2:]) / 2
    gk = np.concatenate([cxy + rng.normal(0, 6, (B, m, K, 2)),
                         rng.integers(0, 3, (B, m, K, 1))], -1).astype(np.float32)

    def jfn(f, kp):
        total, items, terms = jax_loss.v8_pose_loss(
            {"one2many": f, "kpts": kp}, jnp.asarray(labels), jnp.asarray(boxes),
            jnp.asarray(mask), jnp.asarray(gk), STRIDES, nc=NC, kpt_shape=kpt_shape)
        return total, (items, terms)

    (ref, (ref_items, ref_terms)), g_ref = jax.value_and_grad(jfn, argnums=(0, 1),
                                                              has_aux=True)(
        [jnp.asarray(x) for x in f], jnp.asarray(kp))
    tf, tk = _to_torch(f), _to_torch([kp])[0]
    got, items, terms = loss.v8_pose_loss(
        {"one2many": tf, "kpts": tk}, torch.from_numpy(labels), torch.from_numpy(boxes),
        torch.from_numpy(mask), torch.from_numpy(gk), STRIDES, nc=NC, kpt_shape=kpt_shape)
    close(got.item(), float(ref), name="total")
    for a, b in zip(terms, ref_terms):
        close(a.item(), float(b), name="terms")
    for a, b in zip(items, ref_items):
        close(a.item(), float(b))
    assert terms[0].item() > 0 and (terms[1].item() > 0) == (nd == 3)
    grads_close(g_ref, torch.autograd.grad(got, tf + [tk]), "pose grads")
