"""The port's host-side detection metrics equal the JAX package's bit for
bit (``assert_array_equal``, no tolerance): TP matching with near-tied and
exactly tied IoUs (the reference's no-re-sort rule), AP per class with
tied confidences, absent classes and empty inputs, ``DetMetrics`` and the
confusion matrix, on seeded random inputs made with numpy."""

import numpy as np
import pytest

from xlstm_yolo_tpu.engine import validator as jax_val
from xlstm_yolo_tpu.utils import metrics as jax_metrics
from xlstm_yolo_tpu_torch.engine import validator
from xlstm_yolo_tpu_torch.utils import metrics

SEEDS = [0, 1, 2, 3]


def boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def near_tied_iou(rng, n_gt, n_pred):
    """IoUs on a coarse grid (exact ties), some nudged by 1 ulp-scale steps."""
    iou = rng.choice([0.0, 0.5, 0.55, 0.7, 0.75, 0.9, 0.95], (n_gt, n_pred))
    nudge = rng.random((n_gt, n_pred)) < 0.3
    return np.where(nudge, iou + rng.choice([-1e-12, 1e-12, 1e-9], (n_gt, n_pred)), iou)


def assert_equal_tree(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_match_predictions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    assert np.array_equal(validator.IOUV, jax_val.IOUV)
    for n_gt, n_pred in ((6, 9), (1, 5), (7, 1), (0, 4), (3, 0), (12, 30)):
        pred_cls = rng.integers(0, 3, n_pred).astype(np.float32)
        true_cls = rng.integers(0, 3, n_gt)
        iou = near_tied_iou(rng, n_gt, n_pred)
        got = validator.match_predictions(pred_cls, true_cls, iou)
        ref = jax_val.match_predictions(pred_cls, true_cls, iou)
        assert got.shape == (n_pred, 10)
        np.testing.assert_array_equal(got, ref)


def stats(rng, n_pred, n_gt, nc=5):
    tp = rng.random((n_pred, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.choice(np.linspace(0.05, 0.95, 12), n_pred)  # tied confidences
    pred_cls = rng.choice([0, 1, 2, 4], n_pred).astype(np.float32)  # class 3 never predicted
    target_cls = rng.choice([0, 1, 3, 4], n_gt).astype(np.float32)  # class 2 never labelled
    return tp, conf, pred_cls, target_cls


@pytest.mark.parametrize("seed", SEEDS)
def test_ap_per_class_and_det_metrics_equal_jax(seed):
    rng = np.random.default_rng(10 + seed)
    names = {i: str(i) for i in range(5)}
    for n_pred, n_gt in ((200, 60), (7, 3), (1, 1), (40, 0), (0, 10)):
        args = stats(rng, n_pred, n_gt)
        if n_pred and n_gt:
            assert_equal_tree(metrics.ap_per_class(*args), jax_metrics.ap_per_class(*args))
        got, ref = metrics.DetMetrics(names=names), jax_metrics.DetMetrics(names=names)
        if n_pred and n_gt:  # the validator's guard
            got.process(*args)
            ref.process(*args)
        assert got.results_dict.keys() == ref.results_dict.keys()
        for k, v in ref.results_dict.items():
            assert got.results_dict[k] == v, k
        for attr in ("p", "r", "f1", "all_ap", "ap_class_index", "nt_per_class", "ap50", "ap",
                     "map75"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr))
        assert got.mean_results() == ref.mean_results()
        assert_equal_tree(got.curves_results or (), ref.curves_results or ())


def test_ap_helpers_equal_jax():
    rng = np.random.default_rng(5)
    for n in (1, 2, 17, 300):
        recall = np.sort(rng.random(n))
        precision = rng.random(n)
        assert_equal_tree(metrics.compute_ap(recall, precision),
                          jax_metrics.compute_ap(recall, precision))
        y = rng.random(n * 3 + 1)
        np.testing.assert_array_equal(metrics.smooth(y, 0.1), jax_metrics.smooth(y, 0.1))
    a, b = boxes(rng, 9), boxes(rng, 13)
    np.testing.assert_array_equal(metrics.box_iou_matrix(a, b), jax_metrics.box_iou_matrix(a, b))


@pytest.mark.parametrize("seed", SEEDS)
def test_confusion_matrix_equal_jax(seed):
    rng = np.random.default_rng(20 + seed)
    nc = 4
    got, ref = metrics.ConfusionMatrix(nc), jax_metrics.ConfusionMatrix(nc)
    for n_det, n_gt in ((12, 8), (0, 5), (6, 0), (0, 0), (30, 30), (1, 1)):
        gt = boxes(rng, n_gt)
        gt_cls = rng.integers(0, nc, n_gt)
        # detections: jittered copies of some gts (overlaps near the 0.45 cut) and strays
        src = gt[rng.integers(0, max(n_gt, 1), n_det)] if n_gt else boxes(rng, n_det)
        det_boxes = src + rng.normal(0, 3, src.shape).astype(np.float32)
        det = np.concatenate([det_boxes, rng.choice([0.1, 0.25, 0.3, 0.9], (n_det, 1)),
                              rng.integers(0, nc, (n_det, 1))], 1).astype(np.float32)
        got.process_batch(det, gt, gt_cls)
        ref.process_batch(det, gt, gt_cls)
    np.testing.assert_array_equal(got.matrix, ref.matrix)
    assert got.matrix.sum() > 0
