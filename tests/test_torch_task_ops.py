"""The task paths' ops held against the JAX package and OpenCV.

- rotated geometry (``dist2rbox``, ``xywhr2xyxyxyxy``), ``probiou``,
  ``rbox_iou_matrix``, ``nms_rotated`` / ``non_max_suppression_rotated``,
  ``crop_mask`` / ``process_mask``, ``mask_iou``, ``kpt_iou``,
  ``SegmentMetrics`` and ``PoseMetrics`` against JAX's on the same numpy
  inputs.  probiou's transcendentals are torch's, not XLA's: float32
  values to 2e-6 (the NMS keeps the same rows in the same order); the
  numpy functions bit for bit.
- the host counterparts of OpenCV (``utils.cv``) against OpenCV 5.0.0's
  ``cv2`` on hypothesis-drawn inputs: ``fillPoly`` (int32 points, shift 0,
  LINE_8; concave, self-touching and degenerate polygons; vertices inside
  the mask, on its far border, as a label coordinate of 1.0 gives, and far
  outside it), ``findContours`` (RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE) with ``contourArea``, and both resizes (float32
  INTER_LINEAR from sources of at least 2 x 2 pixels, uint8 INTER_NEAREST)
  byte for byte; ``minAreaRect`` bit for bit (5.0.0's float Sklansky hull,
  which normalises each difference vector, and its rotating calipers) on
  sets of random, integer and tiny points, on a rotated box's four float32
  corners and on a box resampled to 400 points, the OBB labels' input,
  whose hull is a run of nearly collinear points; the hull point for point.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xlstm_yolo_tpu.utils import metrics as jmet
from xlstm_yolo_tpu.utils import ops as jops
from xlstm_yolo_tpu.utils import tal as jtal
from xlstm_yolo_tpu_torch.utils import cv as pcv
from xlstm_yolo_tpu_torch.utils import metrics as pmet
from xlstm_yolo_tpu_torch.utils import ops as pops
from xlstm_yolo_tpu_torch.utils import tal as ptal

torch.set_num_threads(1)

HYP = settings(max_examples=150, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])


def rboxes(rng, n: int, size: float = 160.0) -> np.ndarray:
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, size / 3, (n, 2))
    r = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))
    return np.concatenate([xy, wh, r], 1).astype(np.float32)


def test_rotated_geometry_matches_jax():
    rng = np.random.default_rng(0)
    dist = rng.uniform(0, 12, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-0.8, 2.4, (2, 50, 1)).astype(np.float32)
    anc = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    want = np.asarray(jtal.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anc)[None]))
    got = ptal.dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang),
                         torch.from_numpy(anc)[None]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    rb = rboxes(rng, 30)
    np.testing.assert_allclose(ptal.xywhr2xyxyxyxy(rb),
                               np.asarray(jtal.xywhr2xyxyxyxy(jnp.asarray(rb))), atol=2e-5)


def test_probiou_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rboxes(rng, 40), rboxes(rng, 30)
    b[:5] = a[:5]  # identical boxes
    b[5:8, 2:4] = b[5:8, 3:1:-1]
    b[5:8, 4] = a[5:8, 4] + np.pi / 2
    want = np.asarray(jmet.rbox_iou_matrix(a, b))
    got = pmet.rbox_iou_matrix(a, b)
    assert got.dtype == np.float32 and got.shape == (40, 30)
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert pmet.rbox_iou_matrix(a[:0], b).shape == (0, 30)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, A, nc = 2, 120, 3
    preds = np.concatenate([
        rng.uniform(20, 140, (B, A, 2)), rng.uniform(8, 60, (B, A, 2)),
        rng.uniform(0, 1, (B, A, nc)), rng.uniform(-0.7, 2.3, (B, A, 1))], -1).astype(np.float32)
    preds[1, :, 4:4 + nc] *= 0.2  # a sparse image
    jo, jok = jops.non_max_suppression_rotated(jnp.asarray(preds), 0.25, 0.45, 50)
    po, pok = pops.non_max_suppression_rotated(torch.from_numpy(preds), 0.25, 0.45, 50)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-6)
    assert 0 < pok.sum() < 100


def test_process_mask_and_crop_match_jax():
    rng = np.random.default_rng(2)
    proto = rng.normal(size=(40, 40, 8)).astype(np.float32)
    coeffs = rng.normal(size=(6, 8)).astype(np.float32)
    xy = rng.uniform(0, 140, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (6, 2))], 1).astype(np.float32)
    want = np.asarray(jops.process_mask(proto, coeffs, boxes, (160, 160)))
    got = pops.process_mask(proto, coeffs, boxes, (160, 160))
    np.testing.assert_array_equal(got, want)
    t = pops.process_mask(torch.from_numpy(proto), torch.from_numpy(coeffs),
                          torch.from_numpy(boxes), (160, 160))
    assert t.dtype == torch.bool and torch.equal(t, torch.from_numpy(want))
    m = rng.normal(size=(6, 40, 40)).astype(np.float32)
    np.testing.assert_array_equal(pops.crop_mask(m, boxes / 4), jops.crop_mask(m, boxes / 4))


def test_mask_and_keypoint_iou_match_jax():
    rng = np.random.default_rng(3)
    m1 = (rng.random((5, 300)) < 0.4).astype(np.float32)
    m2 = (rng.random((7, 300)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(pmet.mask_iou(m1, m2), jmet.mask_iou(m1, m2))
    k1 = np.concatenate([rng.uniform(0, 100, (4, 17, 2)),
                         rng.integers(0, 3, (4, 17, 1))], -1).astype(np.float32)
    k2 = rng.uniform(0, 100, (6, 17, 3)).astype(np.float32)
    area = rng.uniform(100, 3000, 4).astype(np.float32)
    np.testing.assert_array_equal(pmet.kpt_iou(k1, k2, area, pmet.OKS_SIGMA),
                                  jmet.kpt_iou(k1, k2, area, jmet.OKS_SIGMA))
    np.testing.assert_array_equal(pmet.OKS_SIGMA, jmet.OKS_SIGMA)


@pytest.mark.parametrize("kind", ["segment", "pose"])
def test_task_metrics_match_jax(kind):
    rng = np.random.default_rng(4)
    n = 200
    tp = rng.random((n, 10)) < np.linspace(0.8, 0.3, 10)
    tp2 = rng.random((n, 10)) < np.linspace(0.7, 0.2, 10)
    conf = rng.random(n)
    pred_cls = rng.integers(0, 3, n).astype(np.float64)
    target_cls = rng.integers(0, 3, 150).astype(np.float64)
    names = {0: "a", 1: "b", 2: "c"}
    P, J = ((pmet.SegmentMetrics, jmet.SegmentMetrics) if kind == "segment"
            else (pmet.PoseMetrics, jmet.PoseMetrics))
    p, j = P(names=names), J(names=names)
    p.process(tp, tp2, conf, pred_cls, target_cls)
    j.process(tp, tp2, conf, pred_cls, target_cls)
    assert p.results_dict == j.results_dict
    assert p.mean_results() == j.mean_results() and p.fitness == j.fitness


# ---------------------------------------------------------------------------
# OpenCV counterparts


@st.composite
def polygons(draw):
    """A mask size and int32 vertices inside it, up to its far border or
    around it: random, concave stars, axis-aligned rectangles, repeated and
    collinear points."""
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    kind = draw(st.sampled_from(["random", "star", "rect", "degenerate"]))
    reach = draw(st.sampled_from(["inside", "border", "outside"]))
    lo, hi = {"inside": (0, 0), "border": (0, 1), "outside": (-20, 20)}[reach]
    xs, ys = st.integers(lo, w - 1 + hi), st.integers(lo, h - 1 + hi)
    if kind == "rect":
        x1, x2 = sorted(draw(st.lists(xs, min_size=2, max_size=2)))
        y1, y2 = sorted(draw(st.lists(ys, min_size=2, max_size=2)))
        pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    elif kind == "star":
        n = draw(st.integers(3, 9))
        cx, cy = (w - 1) / 2, (h - 1) / 2
        rs = draw(st.lists(st.floats(0.1, 1.0), min_size=2 * n, max_size=2 * n))
        pts = [(round(cx + r * cx * np.cos(np.pi * k / n)), round(cy + r * cy * np.sin(np.pi * k / n)))
               for k, r in enumerate(rs)]
    elif kind == "degenerate":
        p = draw(st.tuples(xs, ys))
        q = draw(st.tuples(xs, ys))
        pts = [p, q, p] + draw(st.lists(st.sampled_from([p, q]), max_size=3))
    else:
        pts = draw(st.lists(st.tuples(xs, ys), min_size=1, max_size=12))
    return h, w, np.asarray(pts, np.int32)


@HYP
@given(polygons())
def test_fill_poly_equals_cv2(case):
    h, w, pts = case
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, [pts], 1)
    got = pcv.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
    np.testing.assert_array_equal(got, want)


@st.composite
def binary_masks(draw):
    h = draw(st.integers(1, 40))
    w = draw(st.integers(1, 40))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    kind = draw(st.sampled_from(["noise", "blobs", "rings", "empty", "full"]))
    if kind == "noise":
        m = rng.random((h, w)) < draw(st.floats(0.05, 0.95))
    elif kind == "blobs":
        m = np.zeros((h, w), bool)
        for _ in range(draw(st.integers(1, 5))):
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[y:y + rng.integers(1, 15), x:x + rng.integers(1, 15)] = True
    elif kind == "rings":  # holes, blobs inside holes, one-pixel walls
        m = np.zeros((h, w), bool)
        t = draw(st.integers(1, 3))
        m[1:-1, 1:-1] = True
        m[1 + t:-1 - t, 1 + t:-1 - t] = False
        m[h // 2:h // 2 + 2, w // 2:w // 2 + 2] = True
    else:
        m = np.full((h, w), kind == "full")
    return (m * draw(st.sampled_from([1, 255]))).astype(np.uint8)


@HYP
@given(binary_masks())
def test_find_contours_and_area_equal_cv2(mask):
    want, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got = pcv.find_contours_external(mask)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert pcv.contour_area(a) == cv2.contourArea(b)


@HYP
@given(st.integers(2, 60), st.integers(2, 60), st.integers(1, 200), st.integers(1, 200),
       st.integers(0, 2 ** 31 - 1), st.sampled_from(["normal", "binary", "cropped"]))
def test_resize_linear_float32_equals_cv2(h, w, H, W, seed, kind):
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 4, (h, w)).astype(np.float32)
    if kind != "normal":
        m = (1 / (1 + np.exp(-m))).astype(np.float32)
    if kind == "cropped":  # a sigmoid mask zeroed outside a box, as the predictor's
        m[: h // 3] = 0
        m[:, w // 2:] = 0
    np.testing.assert_array_equal(pcv.resize_linear_f32(m, W, H),
                                  cv2.resize(m, (W, H), interpolation=cv2.INTER_LINEAR))


def test_resize_linear_float32_at_the_predictor_sizes():
    rng = np.random.default_rng(5)
    m = rng.random((320, 320)).astype(np.float32)
    for W, H in ((640, 480), (1280, 720), (640, 640), (500, 375), (160, 160)):
        np.testing.assert_array_equal(pcv.resize_linear_f32(m, W, H),
                                      cv2.resize(m, (W, H), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(ValueError, match="2 x 2"):
        pcv.resize_linear_f32(np.zeros((1, 5), np.float32), 8, 8)


@HYP
@given(st.integers(1, 120), st.integers(1, 120), st.integers(1, 300), st.integers(1, 300),
       st.integers(0, 2 ** 31 - 1))
def test_resize_nearest_equals_cv2(h, w, H, W, seed):
    m = (np.random.default_rng(seed).random((h, w)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(pcv.resize_nearest(m, W, H),
                                  cv2.resize(m, (W, H), interpolation=cv2.INTER_NEAREST))


@st.composite
def point_sets(draw):
    kind = draw(st.sampled_from(["random", "integer", "tiny"]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    n = draw(st.integers(1, 14))
    scale = draw(st.sampled_from([1.0, 10.0, 160.0, 640.0]))
    if kind == "tiny":
        pts = rng.integers(0, 3, (n, 2))
    else:
        pts = rng.uniform(0, scale, (n, 2))
        if kind == "integer":
            pts = np.round(pts)
    return pts.astype(np.float32)


@HYP
@given(point_sets())
def test_min_area_rect_matches_cv2(pts):
    got = pcv.min_area_rect(pts)
    assert got == cv2.minAreaRect(pts), (got, cv2.minAreaRect(pts))
    assert -90 <= got[2] < 0


@pytest.mark.parametrize("scale", [10.0, 160.0, 640.0])
@pytest.mark.parametrize("resampled", [False, True])
def test_min_area_rect_of_boxes(scale, resampled):
    """A rotated box's four corners, or its corners resampled to 400 points
    (the OBB labels' path): the hull and the rectangle equal OpenCV's."""
    from xlstm_yolo_tpu_torch.data.augment import resample_segments

    rng = np.random.default_rng(int(scale))
    for _ in range(200):
        x, y = rng.uniform(0, scale, 2)
        bw, bh = rng.uniform(1, scale / 2, 2)
        a = rng.uniform(0, np.pi)
        c, s = np.cos(a), np.sin(a)
        corners = np.array([[x, y], [x + bw * c, y + bw * s],
                            [x + bw * c - bh * s, y + bw * s + bh * c], [x - bh * s, y + bh * c]])
        pts = corners.astype(np.float32)
        if resampled:
            pts = resample_segments([pts])[0]
        np.testing.assert_array_equal(pcv._hull(pts), cv2.convexHull(pts).reshape(-1, 2))
        assert pcv.min_area_rect(pts) == cv2.minAreaRect(pts)


def test_min_area_rect_convention():
    """5.0.0's: an axis-aligned 10 x 5 rectangle is ((5, 2.5), (5, 10), -90)."""
    pts = np.array([[0, 0], [10, 0], [10, 5], [0, 5]], np.float32)
    assert pcv.min_area_rect(pts) == ((5.0, 2.5), (5.0, 10.0), -90.0) == cv2.minAreaRect(pts)
    np.testing.assert_array_equal(pcv._hull(pts), cv2.convexHull(pts).reshape(-1, 2))
