"""Each module of the port's slice held against its JAX counterpart.

For every case: build the JAX module on CPU, initialise it, replace every
parameter with random values drawn from a seeded numpy generator (so
zero-initialised weights such as the ifgate kernel and the out-norm take
part, and the mLSTM cells are far from inert), carry the variables across
with ``jax_variables_to_state_dict``, load them with ``strict=True`` and
compare the two forwards in float32.

Tolerance: atol = rtol = 2e-4 (float32; sums in another order through a
few stacked layers).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.nn import blocks as jb
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu_torch.nn import blocks as tb
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

TOL = dict(atol=2e-4, rtol=2e-4)


def randomize(variables, rng, scale=0.2):
    """Every param ~ scale * N(0, 1); BN means ~ 0.1 N(0, 1), variances ~ U(0.5, 1.5)."""
    def walk(tree, stats):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, stats)
            elif stats and key == "var":
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif stats:
                out[key] = (0.1 * rng.normal(size=val.shape)).astype(np.float32)
            else:
                out[key] = (scale * rng.normal(size=val.shape)).astype(np.float32)
        return out
    return {col: walk(tree, col == "batch_stats") for col, tree in variables.items()}


def seq(rng, B, S, D, mean=0.0):
    return (mean + rng.normal(size=(B, S, D))).astype(np.float32)


def img(rng, B, H, W, C):
    return rng.normal(size=(B, H, W, C)).astype(np.float32)


VIL = dict(seqlens=(5, 5), qkv_block_size=16)  # inner 64 -> 4 heads of 16

# name -> (JAX module, port module, input maker)
CASES = {
    "RMSNorm": (lambda: jl.RMSNorm(24), lambda: tl.RMSNorm(24),
                lambda r: seq(r, 2, 7, 24)),
    "MultiHeadLayerNorm": (  # |mean| >> std: the centered-variance trap
        lambda: jl.MultiHeadLayerNorm(num_heads=3, head_dim=8, data_format="BSND"),
        lambda: tl.MultiHeadLayerNorm(3, 8),
        lambda r: (300.0 + 0.01 * r.normal(size=(2, 5, 3, 8))).astype(np.float32)),
    "SequenceConv2d": (lambda: jl.SequenceConv2d(dim=16, seqlens=(4, 5)),
                       lambda: tl.SequenceConv2d(16, 3, (4, 5)),
                       lambda r: seq(r, 2, 20, 16)),
    "FeedForward": (lambda: jl.FeedForward(dim=32), lambda: tl.FeedForward(32),
                    lambda r: seq(r, 2, 9, 32)),
    "MatrixLSTMCell": (
        lambda: jl.MatrixLSTMCell(dim=64, num_heads=4, mode="inference"),
        lambda: tl.MatrixLSTMCell(64, 4),
        lambda r: [seq(r, 2, 70, 64) for _ in range(3)]),
    "ViLLayer-forward": (lambda: jl.ViLLayer(dim=32, direction=jl.FORWARD, **VIL),
                         lambda: tl.ViLLayer(32, tl.FORWARD, **VIL),
                         lambda r: seq(r, 2, 25, 32)),
    "ViLLayer-backward": (lambda: jl.ViLLayer(dim=32, direction=jl.BACKWARD, **VIL),
                          lambda: tl.ViLLayer(32, tl.BACKWARD, **VIL),
                          lambda r: seq(r, 2, 25, 32)),
    "ViLBlockPair": (lambda: jl.ViLBlockPair(dim=32, **VIL), lambda: tl.ViLBlockPair(32, **VIL),
                     lambda r: seq(r, 2, 25, 32)),
    "PatchMerger": (lambda: jb.PatchMerger(dim=32, num_tokens_out=9),
                    lambda: tb.PatchMerger(32, 9),
                    lambda r: seq(r, 2, 36, 32, mean=0.5)),
    "ConvBNAct": (lambda: jb.ConvBNAct(c2=24, k=3, s=2), lambda: tb.ConvBNAct(16, 24, 3, 2),
                  lambda r: img(r, 2, 8, 10, 16)),
    "LSBlock": (lambda: jb.LSBlock(dim=16), lambda: tb.LSBlock(16),
                lambda r: img(r, 2, 6, 6, 16)),
    "RGBlock": (lambda: jb.RGBlock(dim=16, hidden_dim=48), lambda: tb.RGBlock(16, 48),
                lambda r: img(r, 2, 6, 6, 16)),
    "ViLFusionBlock": (
        lambda: jb.ViLFusionBlock(c1=48, dim=32, seqlens=(4, 4), qkv_block_size=16),
        lambda: tb.ViLFusionBlock(48, 32, (4, 4), qkv_block_size=16),
        lambda r: img(r, 2, 4, 4, 48)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_module_matches_jax(name):
    make_jax, make_port, make_input = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = make_input(rng)
    xs = x if isinstance(x, list) else [x]
    jm = make_jax()
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 *(jnp.asarray(a) for a in xs)))
    variables = randomize(variables, rng)
    y_ref = np.asarray(jm.apply(variables, *(jnp.asarray(a) for a in xs)))

    pm = make_port()
    if name == "SequenceConv2d":
        # in a ViLLayer the JAX path is .../conv/conv/kernel, the port's .../conv.weight
        nested = {col: {"conv": tree} for col, tree in variables.items()}
        torch.nn.ModuleDict({"conv": pm}).load_state_dict(
            jax_variables_to_state_dict(nested), strict=True)
    else:
        pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    pm.eval()
    with torch.no_grad():
        y = pm(*(torch.from_numpy(a) for a in xs)).numpy()
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y, y_ref, **TOL)


def test_port_init_schemes():
    """The port's own init: ifgate biases i = -10 and f = linspace(3, 6),
    zero ifgate kernel and out-norm, unit skip, draws repeatable per seed."""
    def build(seed):
        m = tl.ViLLayer(32, tl.FORWARD, **VIL)
        tl.reset_parameters(m, torch.Generator().manual_seed(seed))
        return m

    m = build(0)
    b = m.mlstm_cell.ifgate.bias
    torch.testing.assert_close(b[:4], torch.full((4,), -10.0))
    torch.testing.assert_close(b[4:], torch.linspace(3.0, 6.0, 4))
    assert not m.mlstm_cell.ifgate.weight.any()
    assert not m.mlstm_cell.outnorm.weight.any()
    assert (m.learnable_skip == 1).all()
    std = m.proj_up.weight.std().item()
    assert abs(std - (2 / (5 * 32)) ** 0.5) < 0.02  # small_init(dim)
    m2 = build(0)
    for (k, a), (_, c) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, c), k
    assert not torch.equal(build(1).proj_up.weight, m.proj_up.weight)
