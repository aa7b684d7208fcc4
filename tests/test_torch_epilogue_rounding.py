"""The epilogue backward's plain version that rounds where its kernels
round (``epilogue_bwd_rounded_plain``: dz = R(g) R(Wd) and dWd = R(g)^T
R(z) kept in float32, R rounding to the compute type) against the JAX
package's ``_epilogue_bwd_pallas`` (the Pallas ``_bwd_kernel``) run in
interpret mode.  The CUDA kernel is held against this plain version on the
card in test_torch_kernel_cuda.py.

Inputs are made with numpy from a seed, at vil-det-tiny's widths and at
vil-det-192's and vil-det-384's, with rows of mean 0 and of mean 50 (|mean|
>> std: the centred variance).  Tolerances: float32, the largest
|difference| of each output over its largest |value| (max_rel) 2e-5 (the
same float32 math summed in another order; 9.1e-6 read on dln_w of the
large-mean rows).  bfloat16 h, x, g on both sides: max_rel at most 2^-7 (a
float32 sum in another order can flip an output's rounding by one
bfloat16 step) and the mean |difference| over the mean |value| (mean_rel)
at most 1e-5 (7.7e-7 read) for dh, dx, dln_w, dln_b, dskip and dbd.
dWd: max_rel 5e-3 (1.2e-3 to 2.2e-3 read): the interpreted kernel's
compiled program does not reproduce the bfloat16 rounding of z that its
own operations give when run eagerly (those match this plain version's z
bit for bit, and their dWd this one's), so dWd carries the difference.
Without the rounding (the same inputs in float32, dh and dx rounded at the
end), and with the autograd plain version (which rounds dz to bfloat16),
mean_rel reads 1.1e-3 or more on those six outputs, so the test also checks
that both exceed 1e-4: a version that skips the kernel's rounding fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas.epilogue import _epilogue_bwd_pallas
from xlstm_yolo_tpu_torch.ops import epilogue

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

BF16_MAX, BF16_MEAN = 2.0 ** -7, 1e-5
NAMES = ("dh", "dx", "dln_w", "dln_b", "dskip", "dwd", "dbd")


def make_inputs(seed, B, S, H, D, offset):
    rng = np.random.default_rng(seed)
    h = rng.normal(offset, 1.0, (B, S, H)).astype(np.float32)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    ln_w, ln_b = (rng.normal(0, 0.1, H).astype(np.float32) for _ in range(2))
    skip = rng.normal(1, 0.1, H).astype(np.float32)
    wd = rng.normal(0, H ** -0.5, (D, H)).astype(np.float32)  # the port's layout (D, H)
    return (h, x, g), (ln_w, ln_b, skip, wd)


def rel(got, ref, mean=False):
    """Per output: the largest |difference| over the largest |ref| (``mean``:
    mean over mean)."""
    out = {}
    for name, a, b in zip(NAMES, got, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        d, b = np.abs(a - b), np.abs(b)
        out[name] = d.mean() / max(b.mean(), 1e-30) if mean else d.max() / max(b.max(), 1e-30)
    return out


CASES = [  # (B, S, H, D, NH, mean offset)
    (2, 64, 64, 32, 4, 0.0),     # vil-det-tiny's widths
    (2, 64, 64, 32, 4, 50.0),
    (1, 40, 384, 192, 12, 0.0),  # vil-det-192's
    (1, 40, 768, 384, 6, 50.0),  # vil-det-384's
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,NH,offset", CASES)
def test_rounded_plain_matches_jax_epilogue_bwd(B, S, H, D, NH, offset, dtype):
    streams, params = make_inputs(S + H, B, S, H, D, offset)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ts = [torch.from_numpy(a).to(tdt) for a in streams]
    tp = [torch.from_numpy(a) for a in params]
    ref = _epilogue_bwd_pallas(*[jnp.asarray(a.float().numpy()).astype(jdt) for a in ts],
                               *map(jnp.asarray, params[:3]), jnp.asarray(params[3].T.copy()),
                               num_heads=NH, eps=1e-6)
    ref = [np.asarray(a, np.float32) for a in ref]
    ref = [ref[0], ref[1], *(a.reshape(-1) for a in ref[2:5]), ref[5].T, ref[6].reshape(-1)]
    got = [a.float().numpy() for a in epilogue.epilogue_bwd_rounded_plain(*ts, *tp, NH)]
    if dtype == "float32":
        assert max(rel(got, ref).values()) <= 2e-5
        return
    worst = rel(got, ref)
    assert worst.pop("dwd") <= 5e-3
    assert max(worst.values()) <= BF16_MAX
    means = rel(got, ref, mean=True)
    del means["dwd"]
    assert max(means.values()) <= BF16_MEAN
    unrounded = epilogue.epilogue_bwd_rounded_plain(*(a.float() for a in ts), *tp, NH)
    unrounded = [a.to(tdt).float().numpy() if j < 2 else a.numpy()
                 for j, a in enumerate(unrounded)]
    autograd = [a.float().numpy() for a in epilogue.epilogue_bwd_plain(*ts, *tp, NH)]
    for other in (unrounded, autograd):
        means = rel(other, ref, mean=True)
        del means["dwd"]
        assert max(means.values()) > 10 * BF16_MEAN


def test_epilogue_wrapper_on_the_cpu_and_its_widths():
    """CPU tensors go to the autograd plain version (as before the kernel's
    redesign), with no launch counted; a width the kernel does not take is
    refused before any launch."""
    streams, params = make_inputs(0, 1, 30, 64, 32, 0.0)
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in streams]
    tp = [torch.from_numpy(a) for a in params]
    before = epilogue.LAUNCHES
    got = epilogue.epilogue_bwd(*ts, *tp, 4)
    ref = epilogue.epilogue_bwd_plain(*ts, *tp, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert epilogue.LAUNCHES == before
    meta = [a.to("meta") for a in ts] + [a.to("meta") for a in tp]
    with pytest.raises(ValueError, match="not taken by the kernel"):
        epilogue.epilogue_bwd(*meta, 8)  # H 64, DH 8
