"""The port's kernel registry, backend modes and sequence-length wrappers
(``ops/backend.py``, ``ops/wrappers.py``) against the JAX package's.

The chunk choice and the segment plan decide which chunk lengths a kernel
sees, and the v1 kernels round per chunk, so both must be the JAX
package's exactly: they are compared over a grid of (S, target) that holds
every (S, chunk) of ``vil-det-192.yaml`` and ``vil-det-tiny.yaml``.  The
wrappers themselves are compared on numpy inputs from a seed, float32:
with the native kernels on both sides (atol = rtol = 1e-4, float32 sums in
another order), and the pad-zeros wrapper with the v1 kernels on both sides
(compute bfloat16: 2e-2 of the largest |h|).  On the exp route the
inference wrapper threads the stabilizer m between its segments; JAX's
drops it at the recurrent tail, and the port mirrors that (the tail-fault
test pins it).
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from xlstm_yolo_tpu.ops import backend as jax_backend
from xlstm_yolo_tpu.ops import wrappers as jax_wrappers
from xlstm_yolo_tpu_torch.nn.tasks import resolve_chunkwise_kernel
from xlstm_yolo_tpu_torch.ops import (
    backend,
    chunkwise,
    chunkwise_exp,
    chunkwise_v2,
    parallel,
    step,
    wrappers,
)
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import (
    mlstm_chunkwise_stabilized,
    mlstm_siging_chunkwise,
)
from xlstm_yolo_tpu_torch.ops.mlstm_parallel import (
    mlstm_parallel_stabilized,
    mlstm_siging_parallel,
)
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import (
    mlstm_recurrent_sequence_stabilized,
    mlstm_siging_recurrent_sequence,
    mlstm_siging_step,
    mlstm_step_stabilized,
)

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
EPS = 5e-5


def yaml_pairs():
    """Every (S, chunk_size) of the shipped ViL detectors."""
    pairs = set()
    for name in ("vil-det-192.yaml", "vil-det-tiny.yaml"):
        d = yaml.safe_load((CFG / name).read_text())
        for _, _, module, args in d["backbone"] + d["head"]:
            if module in ("ViLBlockPairBlock", "ViLFusionBlock"):
                h, w = args[-1]["seqlens"]
                pairs.add((h * w, args[-1]["chunk_size"]))
    return sorted(pairs)


GRID = sorted(set(yaml_pairs()) | {(S, t) for S in (1, 7, 25, 33, 100, 129, 400, 1000, 1600, 6400)
                                   for t in (16, 64, 256, 512, 1024)})


def test_the_grid_holds_every_yaml_pair():
    assert {(6400, 512), (1600, 512), (400, 256), (100, 64), (400, 64), (25, 16)} <= set(
        yaml_pairs()) <= set(GRID)


def test_pick_chunk_size_matches_jax():
    for S, target in GRID:
        for strict in (False, True):
            assert wrappers.pick_chunk_size(S, target, strict) == jax_wrappers.pick_chunk_size(
                S, target, strict), (S, target, strict)


def jax_plan(S, chunk_size):
    """The segments JAX's inference wrapper gives its kernels, recorded."""
    calls = []

    def chunkwise_kernel(q, k, v, i, f, chunk_size, c_initial, n_initial, **kw):
        calls.append((q.shape[2], chunk_size))
        return jnp.zeros(q.shape), (c_initial, n_initial)

    def sequence_kernel(q, k, v, i, f, c_initial, n_initial, **kw):
        calls.append((q.shape[2], None))
        return jnp.zeros(q.shape), (c_initial, n_initial)

    x, g = jnp.zeros((1, 1, S, 1)), jnp.zeros((1, 1, S))
    jax_wrappers.wrap_chunkwise_arbitrary_sequence_length(
        chunkwise_kernel, sequence_kernel, None, x, x, x, g, g, chunk_size=chunk_size)
    return calls


def test_segment_plan_matches_jax():
    for S, target in GRID:
        if S == 1:
            continue  # one step of the step kernel on both sides
        plan, tail = wrappers.chunk_plan(S, target)
        ours = [(seg, cs) for _, seg, cs in plan] + ([(tail, None)] if tail else [])
        assert ours == jax_plan(S, target), (S, target)
        assert sum(seg for _, seg, _ in plan) + tail == S


def make_inputs(seed, S, B=2, NH=2, DH=16, states=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(3))
    i = rng.normal(0, 1, (B, NH, S)).astype(np.float32)
    f = rng.normal(2, 1, (B, NH, S)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    return [q, k, v, i, f], c0, n0


def pt(a):
    return None if a is None else torch.from_numpy(a)


def jx(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("S,chunk,states", [(25, 16, False), (100, 64, True), (400, 256, False),
                                            (1, 64, True)])
def test_arbitrary_length_wrapper_matches_jax(S, chunk, states):
    """The inference wrapper with the native kernels (chunkwise, recurrent
    sequence and step) on both sides: h and the last states."""
    args, c0, n0 = make_inputs(S, S, states=states)
    names = ("chunkwise--native_autograd", "sequence--native", "step--native")
    ref = jax_wrappers.wrap_chunkwise_arbitrary_sequence_length(
        *(jax_backend.get_mlstm_kernel(n) for n in names), *map(jx, args), c_initial=jx(c0),
        n_initial=jx(n0), chunk_size=chunk, eps=EPS)
    got = wrappers.wrap_chunkwise_arbitrary_sequence_length(
        *(backend.get_mlstm_kernel(n) for n in names), *map(pt, args), c_initial=pt(c0),
        n_initial=pt(n0), chunk_size=chunk, eps=EPS)
    for a, b in zip((got[0], *got[1]), (ref[0], *ref[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(100, 64), (25, 16)])
def test_pad_zeros_wrapper_matches_jax_on_the_v1_kernels(S, chunk):
    """train_with_padding with the v1 kernels: S is zero-padded to whole
    chunks of the configured length (no divisor search), as in JAX."""
    args, _, _ = make_inputs(S + 1, S)
    cfg = dict(chunkwise_kernel=backend.V1_KERNEL, mode="train_with_padding", chunk_size=chunk,
               eps=EPS, auto_divisor_chunking=False)
    ref = np.asarray(jax_backend.make_backend(jax_backend.mLSTMBackendConfig(**cfg))(
        *map(jx, args)))
    got = backend.make_backend(backend.mLSTMBackendConfig(**cfg))(*map(pt, args)).numpy()
    assert got.shape == ref.shape == (2, 2, S, 16)
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max(), rtol=2e-2)


def test_pad_zeros_wrapper_picks_a_divisor_chunk_for_the_native_kernel():
    seen = []

    def kernel(q, k, v, i, f, chunk_size, **kw):
        seen.append((q.shape[2], chunk_size))
        return q
    wrappers.wrap_chunkwise_pad_zeros(kernel, *map(pt, make_inputs(0, 100)[0]), chunk_size=64)
    wrappers.wrap_chunkwise_pad_zeros(kernel, *map(pt, make_inputs(0, 100)[0]), chunk_size=64,
                                      auto_divisor=False)
    assert seen == [(100, 50), (128, 64)]
    with pytest.raises(ValueError, match="must not return states"):
        wrappers.wrap_chunkwise_pad_zeros(kernel, *map(pt, make_inputs(0, 100)[0]),
                                          chunk_size=64, return_last_states=True)


REGISTERED = {
    "chunkwise--native_autograd": mlstm_siging_chunkwise,
    "chunkwise--native_stablef": mlstm_chunkwise_stabilized,
    "chunkwise--pallas_xl_chunk": chunkwise_exp.mlstm_chunkwise_exp,
    "chunkwise--pallas_xl_chunk_siging": chunkwise.mlstm_siging_chunkwise_v1,
    "chunkwise--pallas_xl_chunk_siging_v2": chunkwise_v2.mlstm_siging_chunkwise_v2_heads,
    "parallel--native_siging": mlstm_siging_parallel,
    "parallel--native_stablef": mlstm_parallel_stabilized,
    "parallel--pallas_limit_headdim": parallel.mlstm_siging_parallel_kernel,
    "sequence--native": mlstm_siging_recurrent_sequence,
    "sequence--native_stablef": mlstm_recurrent_sequence_stabilized,
    "step--native": mlstm_siging_step,
    "step--native_stablef": mlstm_step_stabilized,
    "step--pallas": step.mlstm_siging_step_kernel,
}


@pytest.mark.parametrize("name", sorted(REGISTERED))
def test_registry_resolves_every_registered_name(name):
    assert backend.get_mlstm_kernel(name) is REGISTERED[name]
    jax_backend.get_mlstm_kernel(name)  # a name the JAX package has too


@pytest.mark.parametrize("name,match", [
    ("sequence--pallas", "unknown"),
    ("chunkwise--pallas_xl_chunk_stablef", "unknown"),
    ("chunkwise--no_such_kernel", "unknown"),
    ("nothing--native", "unknown kernel module"),
])
def test_registry_refuses_the_rest(name, match):
    with pytest.raises(ValueError, match=match):
        backend.get_mlstm_kernel(name)


def test_v2_registry_entry_equals_the_v2_cell():
    """The v2 name on (B, NH, S, DH) operands is the v2 kernels' function
    on the (B, S, H) streams, at any S (it masks its own ragged tail)."""
    args, c0, n0 = make_inputs(3, 100, states=True)
    q, k, v, i, f = map(pt, args)
    B, NH, S, DH = q.shape
    h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_v2_heads(
        q, k, v, i, f, c_initial=pt(c0), n_initial=pt(n0), return_last_states=True, eps=EPS)
    bsh = lambda x: x.transpose(1, 2).reshape(B, S, NH * DH)  # noqa: E731
    ref, (cr, nr) = chunkwise_v2.mlstm_siging_chunkwise_fw(
        bsh(q), bsh(k), bsh(v), i.transpose(1, 2).contiguous(), f.transpose(1, 2).contiguous(),
        NH, pt(c0), pt(n0), eps=EPS, return_last_states=True)
    torch.testing.assert_close(bsh(h), ref)
    torch.testing.assert_close((c, n), (cr, nr))
    assert chunkwise_v2.mlstm_siging_chunkwise_v2_heads.handles_ragged


def test_make_backend_modes():
    args, _, _ = make_inputs(4, 64)
    t = list(map(pt, args))
    cfg = dict(chunkwise_kernel=backend.V1_KERNEL, chunk_size=32, eps=EPS)
    h = backend.make_backend(backend.mLSTMBackendConfig(mode="train", **cfg))(*t)
    h_inf, (c, n) = backend.make_backend(backend.mLSTMBackendConfig(mode="inference", **cfg))(
        *t, return_last_states=True)
    torch.testing.assert_close(h, h_inf, atol=0, rtol=0)  # one segment of 64 at chunk 32
    assert c.shape == (2, 2, 16, 16) and n.shape == (2, 2, 16)
    with pytest.raises(ValueError, match="unknown mode"):
        backend.make_backend(backend.mLSTMBackendConfig(mode="decode", **cfg))


@pytest.mark.parametrize("cuda", [False, True])
def test_auto_is_the_v2_kernels_on_every_device(cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    assert resolve_chunkwise_kernel("auto") == backend.V2_KERNEL
    assert resolve_chunkwise_kernel(backend.V1_KERNEL) == backend.V1_KERNEL
    assert resolve_chunkwise_kernel(backend.EXP_KERNEL) == backend.EXP_KERNEL
    assert resolve_chunkwise_kernel(backend.PARALLEL_KERNEL) == backend.PARALLEL_KERNEL


def test_yaml_chunk_sizes_reach_every_cell():
    """``_vil_config`` keeps each stage's ``chunk_size`` (the port used to
    drop it): every cell of vil-det-tiny carries its block's chunk and the
    model's route."""
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, ViLBlockPair
    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model

    model, d = build_detection_model("vil-det-tiny.yaml", device="cpu",
                                     chunkwise_kernel=backend.V1_KERNEL)
    want = sorted((h * w, c) for h, w, c in (
        (*args[-1]["seqlens"], args[-1]["chunk_size"]) for _, _, m, args in
        d["backbone"] + d["head"] if m in ("ViLBlockPairBlock", "ViLFusionBlock")))
    got = sorted((m.rowwise_from_top_left.layer.conv.seqlens[0]
                  * m.rowwise_from_top_left.layer.conv.seqlens[1],
                  m.rowwise_from_top_left.layer.mlstm_cell.chunk_size)
                 for m in model.modules() if isinstance(m, ViLBlockPair))
    assert got == want and {c for _, c in got} == {16, 64}
    cells = [m for m in model.modules() if isinstance(m, MatrixLSTMCell)]
    assert len(cells) == 14 and all(c.chunkwise_kernel == backend.V1_KERNEL for c in cells)


def test_cell_mode_overrides_the_default():
    """``mode`` replaces the cell's default (inference in eval): with S a
    multiple of the chunk, ``train`` (one call, no states) gives what the
    inference wrapper's single segment gives."""
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, reset_parameters

    outs = []
    for mode in (None, "train"):
        cell = MatrixLSTMCell(32, 2, chunk_size=32, mode=mode,
                              chunkwise_kernel=backend.V1_KERNEL).eval()
        reset_parameters(cell, torch.Generator().manual_seed(0))
        with torch.no_grad():
            cell.ifgate.bias[:2] = 1.0  # open input gates
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(2, 64, 32, generator=g) for _ in range(3))
        with torch.no_grad():
            outs.append(cell(q, k, v))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown mode"):
        MatrixLSTMCell(32, 2, mode="decode", chunkwise_kernel=backend.V1_KERNEL)(q, k, v)


EXP_NAMES = ("chunkwise--pallas_xl_chunk", "sequence--native", "step--native")


@pytest.mark.parametrize("S,chunk,states", [(25, 16, False), (100, 64, True), (400, 256, False),
                                            (72, 32, True)])
def test_arbitrary_length_wrapper_matches_jax_on_the_exp_route(S, chunk, states):
    """The inference wrapper with the exp kernels (bfloat16 products, the
    entry's default), the recurrent sequence and step on both sides, at the
    YAML (S, chunk) pairs and at (72, 32): the segments thread (C, n, m),
    and every plan but (400, 256) leaves a recurrent tail.  h and the last
    (C, n), 2e-2 of each one's largest |value|."""
    args, c0, n0 = make_inputs(S + 2, S, states=states)
    ref = jax_wrappers.wrap_chunkwise_arbitrary_sequence_length(
        *(jax_backend.get_mlstm_kernel(n) for n in EXP_NAMES), *map(jx, args), c_initial=jx(c0),
        n_initial=jx(n0), chunk_size=chunk, eps=EPS)
    got = wrappers.wrap_chunkwise_arbitrary_sequence_length(
        *(backend.get_mlstm_kernel(n) for n in EXP_NAMES), *map(pt, args), c_initial=pt(c0),
        n_initial=pt(n0), chunk_size=chunk, eps=EPS)
    assert len(got[1]) == 2
    for a, b in zip((got[0], *got[1]), (ref[0], *ref[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-2 * np.abs(b).max(), rtol=2e-2)


@pytest.mark.parametrize("gates", ["init", "open"])
@pytest.mark.parametrize("name", ["chunkwise--native_stablef", "chunkwise--pallas_xl_chunk"])
def test_exp_route_tail_drops_m_as_the_jax_wrapper_does(name, gates, monkeypatch):
    """The JAX inference wrapper hands the stabilizer m to the recurrent
    tail only if the sequence function takes it (``ops/wrappers.py:149-153``);
    with ``sequence--native`` (the cell's choice) the siging recurrence
    continues from C and n stored relative to the dropped m.  B 2, NH 3,
    S 72, DH 16, chunk 32: a 64-token prefix in two segments, then an
    8-token tail, against ``mlstm_recurrent_sequence_stabilized`` over all
    72 tokens, at init-like input gates (i ~ -10 + N(0, 0.1)) and open ones
    (i ~ N(0, 1)).  Both wrappers agree with each other, and with it on the
    prefix, and both differ from it on the tail; with
    ``sequence--native_stablef`` both agree with it everywhere.  The exp
    kernel entry runs with float32 products in both registries here (its
    bfloat16 ones alone move h by a few percent of its largest |value| over
    64 open-gate tokens); tolerance 1e-4 of the largest |h|."""
    rng = np.random.default_rng(11)
    B, NH, S, DH, chunk, prefix = 2, 3, 72, 16, 32, 64
    q, k, v = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(3))
    i = (rng.normal(-10, 0.1, (B, NH, S)) if gates == "init"
         else rng.normal(0, 1, (B, NH, S))).astype(np.float32)
    f = rng.normal(3, 1, (B, NH, S)).astype(np.float32)
    args = (q, k, v, i, f)
    if name == backend.EXP_KERNEL:
        jax_backend.get_mlstm_kernel(name)  # registers the Pallas kernels first
        monkeypatch.setitem(jax_backend._CHUNKWISE_REGISTRY, "pallas_xl_chunk", functools.partial(
            jax_backend.get_mlstm_kernel(name), compute_dtype=jnp.float32))
        monkeypatch.setitem(backend._REGISTRY["chunkwise"], "pallas_xl_chunk", functools.partial(
            chunkwise_exp.mlstm_chunkwise_exp, compute_dtype=torch.float32))
    rel = 1e-4
    ref = mlstm_recurrent_sequence_stabilized(*map(pt, args), eps=EPS).numpy()
    scale = np.abs(ref).max()
    out = {}
    for seq in ("sequence--native", "sequence--native_stablef"):
        names = (name, seq, "step--native")
        h_jax = np.asarray(jax_wrappers.wrap_chunkwise_arbitrary_sequence_length(
            *(jax_backend.get_mlstm_kernel(n) for n in names), *map(jx, args), chunk_size=chunk,
            eps=EPS, return_last_states=False))
        h_port = wrappers.wrap_chunkwise_arbitrary_sequence_length(
            *(backend.get_mlstm_kernel(n) for n in names), *map(pt, args), chunk_size=chunk,
            eps=EPS, return_last_states=False).numpy()
        np.testing.assert_allclose(h_port, h_jax, atol=rel * scale, rtol=rel)
        out[seq] = (h_jax, h_port)
    sizes = {}
    for side, h in zip(("jax", "port"), out["sequence--native"]):
        err_prefix = np.abs(h[:, :, :prefix] - ref[:, :, :prefix]).max()
        err_tail = np.abs(h[:, :, prefix:] - ref[:, :, prefix:]).max()
        sizes[side] = dict(prefix_err=err_prefix, tail_err=err_tail,
                           max_tail_h=np.abs(ref[:, :, prefix:]).max(), max_h=scale)
        assert err_prefix <= rel * scale, sizes
        assert err_tail > 0.1 * np.abs(ref[:, :, prefix:]).max(), sizes
    for side, h in zip(("jax", "port"), out["sequence--native_stablef"]):
        err = np.abs(h - ref).max()
        assert err <= rel * scale, (side, err, scale, sizes)
    print(f"{name} {gates}: {sizes}")
