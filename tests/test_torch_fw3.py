"""The port's sub-chunked chunkwise forward (``ops/chunkwise_fw3.py``, the
plain version that the wrapper runs on CPU tensors) held against the JAX
package's ``fw3`` run in interpret mode, against the port's v2 forward,
and in its drop-in contract with the port's v2 backward.  The kernel itself
is held against this plain version on the card in
test_torch_kernel_cuda.py.

Inputs are made with numpy from a seed.  Tolerances, relative to each
output's largest |value| (at least 1), as tests/test_fw3.py holds ``fw3``
against the v2 forward: products in float32, h 2e-5 and the states and
denominators 2e-4 (float32 sums in another order); products in bfloat16,
6e-4, under a third of the distance between bfloat16 and float32 products
on the same case (2e-3 to 3.7e-3), so a version that skipped the rounding
fails, and the test checks that it would.  Against the port's v2 forward
and backward (another chunk length, so other sums): 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas.chunkwise_fw3 import _pack_gates_sub
from xlstm_yolo_tpu.ops.pallas.chunkwise_fw3 import fw3 as jax_fw3
from xlstm_yolo_tpu_torch.ops import chunkwise_fw3, chunkwise_v2

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

B, NH = 2, 2
EPS = 5e-5  # the model's cell eps
OUTPUTS = ("h", "n_out", "cstates", "c_last", "n_last")
ROUNDED = OUTPUTS[:4]  # the outputs that the products' rounding moves (n_last sums k e^a)
BF16_TOL = 6e-4  # plain vs JAX with bfloat16 products: 2.7x the worst reading (cstates 2.2e-4)
CASES = [  # (S, L, Lb, DHQK, DHHV, initial states, compute type)
    (640, 640, 128, 32, 32, False, "float32"),  # the flagship's L: five sub-chunks
    (900, 256, 128, 16, 16, False, "float32"),  # ragged S
    (512, 512, 256, 32, 32, False, "float32"),  # two sub-chunks of 256
    (100, 100, 128, 16, 8, False, "float32"),   # degenerate: Lb = L; DHHV != DHQK
    (200, 64, 32, 32, 32, True, "float32"),     # initial states, ragged
    (200, 64, 32, 16, 16, True, "bfloat16"),    # products in bfloat16
]
IDS = [f"S{c[0]}-L{c[1]}-Lb{c[2]}-dh{c[3]}-{c[6]}" for c in CASES]


def make_inputs(seed, S, DHQK, DHHV, states, gates="open"):
    """(B, S, NH*DH) streams, (B, S, NH) gates far from inert (i ~ U(-6, 4),
    open f ~ U(-2, 8)), optional states; numpy float32."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, S, NH * DHQK)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, S, NH * DHHV)).astype(np.float32)
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(*((-2, 8) if gates == "open" else (-60, -20)), (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DHQK, DHHV)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DHQK)).astype(np.float32) if states else None
    return q, k, v, i, f, c0, n0


def torch_args(inputs):
    return [None if a is None else torch.from_numpy(a) for a in inputs]


def case_kw(case):
    S, L, Lb, *_, compute = case
    return dict(chunk_size=L, sub_chunk=Lb, eps=EPS), compute


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX ``fw3`` train variant (interpret mode) on every case: one
    call a case."""
    out = {}
    for case in CASES:
        S, L, Lb, DHQK, DHHV, states, compute = case
        q, k, v, i, f, c0, n0 = make_inputs(S, S, DHQK, DHHV, states)
        res = jax_fw3(*(jnp.asarray(a) for a in (q, k, v, i, f)), num_heads=NH,
                      c_initial=None if c0 is None else jnp.asarray(c0),
                      n_initial=None if n0 is None else jnp.asarray(n0), chunk_size=L,
                      sub_chunk=Lb, eps=EPS, compute_dtype=getattr(jnp, compute))
        out[case] = [np.asarray(a, np.float64) for a in res]
    return out


def scaled_err(got, ref):
    """The largest |got - ref| over the largest |ref| (at least 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def mean_err(got, ref):
    """Mean |got - ref| over mean |ref|: a systematic gap, which a few
    operands rounded one bfloat16 step the other way barely move."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).mean() / np.abs(ref).mean()


def assert_scaled_close(got, ref, tol, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.isfinite(got).all(), name
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=tol, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_fw3(case, jax_outputs):
    S, L, Lb, DHQK, DHHV, states, compute = case
    args = torch_args(make_inputs(S, S, DHQK, DHHV, states))
    kw, _ = case_kw(case)
    got = chunkwise_fw3.fw3_plain(*args[:5], NH, *args[5:], **kw,
                                  compute_dtype=getattr(torch, compute))
    for name, a, ref in zip(OUTPUTS, got, jax_outputs[case]):
        tol = BF16_TOL if compute == "bfloat16" else 2e-5 if name == "h" else 2e-4
        assert_scaled_close(a.numpy(), ref, tol, name)
    if compute == "bfloat16":  # unrounded operands would miss the tolerance
        f32 = chunkwise_fw3.fw3_plain(*args[:5], NH, *args[5:], **kw,
                                      compute_dtype=torch.float32)
        for name, a, ref in zip(OUTPUTS, f32, jax_outputs[case]):
            if name in ROUNDED:
                assert scaled_err(a.numpy(), ref) > 3 * BF16_TOL, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_products_differ_from_float32_products(case):
    """With bfloat16 products every output that a product feeds moves
    from the float32-products one by a systematic gap (mean error 4.6e-4
    to 3.4e-3 on these cases), where operands rounded one bfloat16 step the
    other way (another float32 sum before the rounding) move the mean by
    under 5e-5."""
    S, L, Lb, DHQK, DHHV, states, _ = case
    args = torch_args(make_inputs(S, S, DHQK, DHHV, states))
    kw, _ = case_kw(case)
    bf = chunkwise_fw3.fw3_plain(*args[:5], NH, *args[5:], **kw, compute_dtype=torch.bfloat16)
    f32 = chunkwise_fw3.fw3_plain(*args[:5], NH, *args[5:], **kw, compute_dtype=torch.float32)
    for name, a, b in zip(OUTPUTS, bf, f32):
        if name == "cstates" and S <= L:  # one chunk: the initial state, no product's
            assert torch.equal(a, b)
        elif name in ROUNDED:
            assert mean_err(a.numpy(), b.numpy()) > 2e-4, name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_inference_variant_gives_the_train_variants_h_and_last_states(case):
    S, L, Lb, DHQK, DHHV, states, compute = case
    args = torch_args(make_inputs(S, S, DHQK, DHHV, states))
    kw, _ = case_kw(case)
    kw["compute_dtype"] = getattr(torch, compute)
    train = chunkwise_fw3.fw3(*args[:5], NH, *args[5:], **kw)
    infer = chunkwise_fw3.fw3(*args[:5], NH, *args[5:], save_states=False, **kw)
    assert infer[1] is None and infer[2] is None
    for a, b in zip(train[::3] + train[4:], infer[::3] + infer[4:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] == "float32" and c[3] == c[4]],
                         ids=[i for c, i in zip(CASES, IDS) if c[6] == "float32" and c[3] == c[4]])
def test_plain_matches_the_ports_v2_forward(case):
    """Another chunking of the same function: the v2 forward's L = 64."""
    S, L, Lb, DHQK, DHHV, states, _ = case
    args = torch_args(make_inputs(S, S, DHQK, DHHV, states))
    kw, _ = case_kw(case)
    h, _, _, c_last, n_last = chunkwise_fw3.fw3_plain(
        *args[:5], NH, *args[5:], **kw, compute_dtype=torch.float32, save_states=False)
    h2, (c2, n2) = chunkwise_v2.mlstm_siging_chunkwise_fw_plain(
        *args[:5], NH, *args[5:], eps=EPS, return_last_states=True)
    for name, a, b in (("h", h, h2), ("c_last", c_last, c2), ("n_last", n_last, n2)):
        assert_scaled_close(a.numpy(), b.numpy(), 1e-4, name)


@pytest.mark.parametrize("S,L,Lb", [(640, 640, 128), (900, 256, 128), (100, 100, 128),
                                    (200, 64, 32)])
def test_pack_gates_sub_matches_jax(S, L, Lb):
    _, _, _, i, f, _, _ = make_inputs(1, S, 16, 16, False)
    NC = -(-S // L)
    Lb = L if L % Lb else Lb
    got = chunkwise_fw3.pack_gates_sub(torch.from_numpy(i), torch.from_numpy(f), NC, L, Lb)
    ref = _pack_gates_sub(jnp.asarray(i), jnp.asarray(f), NC, L, Lb)
    for name, a, b in zip(("b_rel", "a_rel", "logi", "gsub"), got, ref):
        assert_scaled_close(a.numpy(), np.asarray(b), 1e-5, name)


@pytest.mark.parametrize("sub_chunk", [32, 64])
@pytest.mark.parametrize("gates", ["open", "closed"])
def test_drop_in_contract_with_the_v2_backward(sub_chunk, gates):
    """At the port's v2 chunk (L = 64): fw3's saved states are the v2 train
    forward's (c_states, den), and the v2 backward fed fw3's states gives
    the v2 path's dq, dk, dv and dC0."""
    S, DH = 200, 16
    q, k, v, i, f, c0, n0 = torch_args(make_inputs(7, S, DH, DH, True, gates))
    L = chunkwise_v2.CHUNK_SIZE
    h3, n_out, cstates, c3, n3 = chunkwise_fw3.fw3(
        q, k, v, i, f, NH, c0, n0, chunk_size=L, sub_chunk=sub_chunk, eps=EPS,
        compute_dtype=torch.float32)
    h2, (c2, n2), (c_states, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(
        q, k, v, i, f, NH, c0, n0, eps=EPS)
    for name, a, b in (("h", h3, h2), ("cstates", cstates, c_states), ("n_out", n_out, den),
                       ("c_last", c3, c2), ("n_last", n3, n2)):
        assert_scaled_close(a.numpy(), b.numpy(), 1e-4, name)
    dh = torch.from_numpy(np.random.default_rng(8).normal(size=q.shape).astype(np.float32))
    dcl = torch.from_numpy(np.random.default_rng(9).normal(size=c0.shape).astype(np.float32))
    got = chunkwise_v2.mlstm_siging_chunkwise_bw(q, k, v, i, f, NH, cstates, n_out, dh, dcl,
                                                 eps=EPS)
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw(q, k, v, i, f, NH, c_states, den, dh, dcl,
                                                 eps=EPS)
    for name, a, b in zip(("dq", "dk", "dv", "dc0"), got, ref):
        assert_scaled_close(a.numpy(), b.numpy(), 1e-4, name)


def refusal_cases():
    """(inputs on the meta device, keyword arguments, error, message): what
    the kernel does not take; the last, inputs it does take, on a device
    that is not CUDA."""
    def inputs(DH=16, DHHV=16, dtype=torch.float32, gate_dtype=torch.float32):
        t = lambda *s, d=dtype: torch.empty(*s, dtype=d, device="meta")  # noqa: E731
        return (t(1, 30, NH * DH), t(1, 30, NH * DH), t(1, 30, NH * DHHV),
                t(1, 30, NH, d=gate_dtype), t(1, 30, NH, d=gate_dtype))

    return [
        (inputs(DH=48, DHHV=48), {}, ValueError, "head dims 48"),
        (inputs(DHHV=32), {}, ValueError, "head dims 16 .q, k. and 32"),
        (inputs(dtype=torch.float16), {}, TypeError, "q/k/v dtype"),
        (inputs(), {"compute_dtype": torch.float16}, TypeError, "compute_dtype"),
        (inputs(), {"compute_dtype": torch.float64}, TypeError, "compute_dtype"),
        (inputs(gate_dtype=torch.bfloat16), {}, ValueError, "i must be"),
        (inputs(), {}, ValueError, "unsupported device"),
    ]


@pytest.mark.parametrize("inputs,kw,error,match", refusal_cases())
def test_the_wrapper_refuses_what_the_kernel_does_not_take(inputs, kw, error, match):
    before = chunkwise_fw3.LAUNCHES_FW3_TRAIN
    with pytest.raises(error, match=match):
        chunkwise_fw3.fw3(*inputs, NH, **kw)
    assert chunkwise_fw3.LAUNCHES_FW3_TRAIN == before

