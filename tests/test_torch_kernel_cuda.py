"""The port's CUDA chunkwise mLSTM kernel against its plain PyTorch version,
on the card.  This file imports neither JAX nor the JAX package, so it runs
on the GPU machine:

    python -m pytest -m cuda tests/test_torch_kernel_cuda.py -q

Without a CUDA device its tests skip.  Inputs are made with numpy from a
seed.  Tolerances: float32, atol = rtol = 1e-4 (sums in another order);
bfloat16 inputs (both sides see the same rounded values, the kernel rounds
h once), atol = rtol = 2e-2.
"""

import numpy as np
import pytest
import torch

from xlstm_yolo_tpu_torch.ops import chunkwise_v2

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
EPS = 5e-5  # the model's cell eps
CASES = [  # (S, NH, DH, gates, initial states)
    (25, 4, 16, "open", False),     # single ragged chunk (vil-det-tiny's S)
    (64, 2, 32, "open", True),      # exactly one chunk, with initial states
    (100, 3, 16, "closed", False),  # ragged second chunk, closed forget gates
    (200, 4, 32, "open", True),     # several chunks, ragged tail
    (1000, 12, 32, "open", True),   # flagship heads, ragged S
]


def make_inputs(seed, B, S, NH, DH, gates, states):
    """(B, S, H) streams, (B, S, NH) gates far from inert (i ~ U(-6, 4);
    open f ~ U(-2, 8), closed f ~ U(-60, -20)), optional states."""
    rng = np.random.default_rng(seed)
    H = NH * DH
    q, k, v = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(3))
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(*((-2, 8) if gates == "open" else (-60, -20)), (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    return q, k, v, i, f, c0, n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else BF16_TOL
    for S, NH, DH, gates, states in CASES:
        q, k, v, i, f, c0, n0 = make_inputs(S, 2, S, NH, DH, gates, states)
        cu = lambda a, d=torch.float32: None if a is None else torch.from_numpy(a).to("cuda", d)
        args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
        before = chunkwise_v2.LAUNCHES
        h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
        torch.cuda.synchronize()
        assert chunkwise_v2.LAUNCHES == before + 1
        hp, (cp, np_) = chunkwise_v2.mlstm_siging_chunkwise_fw_plain(
            *args, eps=EPS, return_last_states=True)
        assert torch.isfinite(h.float()).all()
        torch.testing.assert_close(h.float(), hp.float(), **tol)
        torch.testing.assert_close(c, cp, **TOL)
        torch.testing.assert_close(n, np_, **TOL)
