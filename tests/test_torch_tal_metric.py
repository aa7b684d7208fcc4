"""The port's fused TAL metric stage (``ops/tal_metric.py``; its plain
version on the CPU) against the JAX package's Pallas kernel
(``ops/pallas/tal_metric.py``), interpreted on the CPU, and the port's
assigner entries (``task_aligned_assign_pallas_metric``, and
``task_aligned_assign`` with a per-sample ``topk_arr``) against JAX's.

Inputs are made with numpy from a seed, as ``tests/test_tal_kernel.py``
makes them: A = 200 anchors (not a multiple of 128, so JAX pads and the
port masks), M = 9 padded gts, nc = 11 classes; the degenerate case has an
image with no valid gt and an image of zero-area gts; the tie case has
small gts far from the predictions, so most rows have fewer than k anchors
of non-zero metric and the lowest-index order among zeros decides.

Tolerances: masks, labels and gt indices equal; align and overlaps, and
the target boxes and scores, rtol 2e-5 and 1e-6 as the JAX test holds its
two paths (the same float32 expression; XLA may contract or vectorise a
step differently from PyTorch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas.tal_metric import tal_metric_pallas
from xlstm_yolo_tpu.utils import tal as jtal
from xlstm_yolo_tpu_torch.ops import tal_metric as tm
from xlstm_yolo_tpu_torch.utils import tal

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

K_ARR = np.asarray([10, 1, 10, 1], np.int32)  # the E2E loss's top-10 and top-1 halves


def make(B=3, A=200, M=9, nc=11, seed=0, degenerate=False, ties=False):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    anc = rng.uniform(0, 320, (A, 2)).astype(np.float32)
    pxy = rng.uniform(0, 280, (B, A, 2)).astype(np.float32)
    pwh = rng.uniform(5, 120, (B, A, 2)).astype(np.float32)
    pboxes = np.concatenate([pxy, pxy + pwh], -1)
    gxy = rng.uniform(0, 250, (B, M, 2)).astype(np.float32)
    gwh = rng.uniform(30, 160, (B, M, 2)).astype(np.float32)
    if ties:
        # gts of 20-60 px, predictions of 2-6 px: few anchors in a gt, and
        # most of those with a CIoU <= 0, so align is 0 there
        gwh = rng.uniform(20, 60, (B, M, 2)).astype(np.float32)
        pwh = rng.uniform(2, 6, (B, A, 2)).astype(np.float32)
        pboxes = np.concatenate([pxy, pxy + pwh], -1)
    gboxes = np.concatenate([gxy, gxy + gwh], -1)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask = rng.uniform(0, 1, (B, M)) > 0.3
    if degenerate:
        mask[0] = False
        gboxes[1] = 0.0
    return scores, pboxes, anc, labels, gboxes, mask


def to_jax(args):
    return [jnp.asarray(a) for a in args]


def to_torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def assert_same_assignment(got, ref):
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(ref.target_labels))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(ref.target_gt_idx))
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(ref.target_bboxes),
                               rtol=1e-6)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["random", "degenerate", "ties", "k_arr"])
def test_metric_stage_matches_jax_pallas(case):
    """``tal_metric`` on CPU tensors (the plain version, no launch) against
    the interpreted ``tal_metric_pallas``: align, overlaps and mask_pos."""
    B = 4 if case == "k_arr" else 3
    args = make(B=B, seed=11, degenerate=case == "degenerate", ties=case == "ties")
    k_arr = K_ARR if case == "k_arr" else None
    nc = args[0].shape[-1]
    ref = tal_metric_pallas(*to_jax(args), topk=10, num_classes=nc,
                            topk_arr=None if k_arr is None else jnp.asarray(k_arr))
    before = tm.LAUNCHES
    got = tm.tal_metric(*to_torch(args), topk=10, num_classes=nc,
                        topk_arr=None if k_arr is None else torch.from_numpy(k_arr))
    assert tm.LAUNCHES == before
    assert got[2].dtype == torch.bool and got[0].shape == (B, 9, 200)
    for name, a, b in zip(("align", "overlaps"), got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if case == "ties":
        # the case does what it says: most valid rows have fewer than 10
        # anchors of non-zero metric, and zero-metric anchors were chosen
        valid_rows = got[1].new_tensor(args[5]).bool()
        positive = (got[0] > 0).sum(-1)
        assert (positive[valid_rows] < 10).float().mean() > 0.5
        assert (got[2] & (got[0] == 0)).any()


@pytest.mark.parametrize("case", ["random", "degenerate", "ties"])
def test_pallas_metric_assigner_matches_jax(case):
    """``task_aligned_assign_pallas_metric`` against JAX's, and against the
    port's own ``task_aligned_assign``."""
    args = make(seed=0, degenerate=case == "degenerate", ties=case == "ties")
    nc = args[0].shape[-1]
    ref = jtal.task_aligned_assign_pallas_metric(*to_jax(args), topk=10, num_classes=nc)
    got = tal.task_aligned_assign_pallas_metric(*to_torch(args), topk=10, num_classes=nc)
    assert_same_assignment(got, ref)
    assert_same_assignment(
        got, tal.task_aligned_assign(*to_torch(args), topk=10, num_classes=nc))


def test_per_sample_k_matches_jax():
    """``topk_arr`` mixing 10 and 1 through both assigner entries, against
    JAX's; and ``topk_select_mask`` with ``k_arr`` against JAX's."""
    args = make(B=4, seed=3)
    nc = args[0].shape[-1]
    jk, tk = jnp.asarray(K_ARR), torch.from_numpy(K_ARR)
    for name in ("task_aligned_assign", "task_aligned_assign_pallas_metric"):
        ref = getattr(jtal, name)(*to_jax(args), topk=10, num_classes=nc, topk_arr=jk)
        got = getattr(tal, name)(*to_torch(args), topk=10, num_classes=nc, topk_arr=tk)
        assert_same_assignment(got, ref)
    metric = np.random.default_rng(5).uniform(0, 1, (4, 9, 200)).astype(np.float32)
    metric[:, :, 50:] = 0.0  # zero ties beyond the first 50 anchors
    metric[:, 3, :] = 0.0
    ref = jtal.topk_select_mask(jnp.asarray(metric), 10, jk)
    got = tal.topk_select_mask(torch.from_numpy(metric), 10, tk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum().item() == 9 * (10 + 1 + 10 + 1)


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused: the wrapper
    never falls back."""
    args = [a.to("meta") for a in to_torch(make(B=1, A=16, M=2))]
    with pytest.raises(ValueError, match="unsupported device"):
        tm.tal_metric(*args)
