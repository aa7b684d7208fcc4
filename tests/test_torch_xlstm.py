"""The port's xLSTM language model (``nn/xlstm.py``) and its sLSTM scan
(``ops/slstm.py``; the plain scan on the CPU) against the JAX package's
``nn/xlstm.py``, whose Pallas sLSTM kernel runs interpreted on the CPU.

Every port module takes JAX's own initial variables through
``utils/convert.jax_variables_to_state_dict`` with a strict load, so the
recurrent kernel is JAX's orthogonal (and not symmetric) R: a transposed R
in the port would show.  The mLSTM cells' input-gate weights and biases are
perturbed (kernel 0.1 N(0, 1), biases U(-3, 1)) so that no cell is inert.
Inputs are made with numpy from a seed.

Tolerances: float32 on both sides.  The sLSTM cell and the causal conv
atol 1e-5 (as the JAX package holds its Pallas scan to its ``lax.scan``);
the block stack and the LM's logits 1e-4 of the output's largest |value|
(float32 sums in another order through a few blocks); ``generate`` gives
JAX's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.nn import xlstm as jx
from xlstm_yolo_tpu_torch.nn import xlstm as tx
from xlstm_yolo_tpu_torch.ops import slstm as sl
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

B, S, D, NH = 2, 24, 32, 4


def numpy_tree(variables):
    return jax.tree.map(lambda a: np.array(a, np.float32), variables)


def perturb_ifgates(tree, rng):
    """Every mLSTM cell's ifgate: kernel 0.1 N(0, 1), biases U(-3, 1)."""
    for key, val in tree.items():
        if key == "ifgate":
            val["kernel"] = (0.1 * rng.normal(size=val["kernel"].shape)).astype(np.float32)
            val["bias"] = rng.uniform(-3, 1, val["bias"].shape).astype(np.float32)
        elif isinstance(val, dict):
            perturb_ifgates(val, rng)
    return tree


def carry(module, variables):
    """``module`` with JAX's ``variables`` loaded strictly, in float32 on
    the CPU."""
    module.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return module


def jax_init(module, x, seed=0):
    variables = numpy_tree(module.init(jax.random.PRNGKey(seed), x))
    return {"params": perturb_ifgates(variables["params"], np.random.default_rng(seed))}


def given_state(seed):
    rng = np.random.default_rng(seed)
    h, c = (rng.normal(size=(B, NH, D // NH)).astype(np.float32) for _ in range(2))
    n = rng.uniform(0.5, 2.0, (B, NH, D // NH)).astype(np.float32)
    m = rng.uniform(-2, 4, (B, NH, D // NH)).astype(np.float32)
    return h, c, n, m


def assert_rel(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_cell_matches_jax(backend, from_state):
    """The port's cell (plain scan on the CPU, no launch) against JAX's
    ``scan`` and interpreted ``pallas`` backends, from zeros and from a
    given (h, c, n, m): y and the last state within 1e-5."""
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    jcell = jx.sLSTMCell(dim=D, num_heads=NH, backend=backend)
    variables = numpy_tree(jx.sLSTMCell(dim=D, num_heads=NH).init(jax.random.PRNGKey(0), x))
    state = given_state(2) if from_state else None
    y_ref, st_ref = jcell.apply(variables, jnp.asarray(x),
                                None if state is None else tuple(map(jnp.asarray, state)))
    cell = carry(tx.sLSTMCell(D, NH, backend=backend), variables)
    before = sl.LAUNCHES
    with torch.no_grad():
        y, st = cell(torch.from_numpy(x),
                     None if state is None else tuple(map(torch.from_numpy, state)))
    assert sl.LAUNCHES == before and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    for name, a, b in zip("hcnm", st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_slstm_cell_split_sequence_is_one_sequence():
    """Two calls threading the state give the one-call result (the JAX
    package's ``test_slstm_cell_shapes_and_state``), and R is used as
    (d, e): its transpose gives another output."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(B, 10, D)).astype(np.float32))
    variables = numpy_tree(jx.sLSTMCell(dim=D, num_heads=NH).init(jax.random.PRNGKey(0), x.numpy()))
    cell = carry(tx.sLSTMCell(D, NH), variables)
    with torch.no_grad():
        y, state = cell(x)
        y1, s1 = cell(x[:, :5])
        y2, _ = cell(x[:, 5:], s1)
        assert y.shape == (B, 10, D) and state[0].shape == (B, NH, D // NH)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), atol=1e-5,
                                   rtol=1e-4)
        R = cell.recurrent_kernel
        assert (R - R.transpose(-1, -2)).abs().max() > 0.1
        wx = cell.wx(x).reshape(B, 10, 4, NH, D // NH)
        y_t, _ = sl.slstm_sequence_plain(wx, R.transpose(-1, -2).contiguous())
        assert (y_t.reshape(y.shape) - y).abs().max() > 1e-3


def test_causal_conv_matches_jax():
    x = np.random.default_rng(3).normal(size=(B, 11, 16)).astype(np.float32)
    jconv = jx.CausalConv1d(dim=16, kernel_size=4)
    variables = numpy_tree(jconv.init(jax.random.PRNGKey(1), x))
    conv = carry(tx.CausalConv1d(16, 4), variables)
    assert conv.weight.shape == (16, 1, 4)
    with torch.no_grad():
        y = conv(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jconv.apply(variables, x)), atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
def test_block_stack_matches_jax(training):
    """A mixed stack (dim 32, 3 blocks, sLSTM at 1, chunk 8, qkv blocks of
    16: 4 heads of 16 in the mLSTM cells) in eval and in training mode."""
    x = np.random.default_rng(4).normal(size=(B, 16, D)).astype(np.float32)
    kw = dict(num_blocks=3, slstm_at=(1,), chunk_size=8, qkv_block_size=16)
    jstack = jx.xLSTMBlockStack(dim=D, training=training, **kw)
    variables = jax_init(jx.xLSTMBlockStack(dim=D, **kw), x)
    ref = np.asarray(jstack.apply(variables, jnp.asarray(x)))
    stack = carry(tx.xLSTMBlockStack(D, training=training, **kw), variables)
    assert stack.training == training and stack.block_0.mlstm_layer.mlstm_cell.training == training
    with torch.no_grad():
        y = stack(torch.from_numpy(x))
    assert_rel(y.numpy(), ref, 1e-4)


@pytest.fixture(scope="module")
def tiny_lm():
    """JAX's xLSTMLarge(vocab 50, dim 32, 2 blocks, sLSTM at 1) and the port's
    on the CPU with the same variables, and a (2, 5) prompt."""
    prompt = np.random.default_rng(6).integers(0, 50, (2, 5)).astype(np.int32)
    jlm = jx.xLSTMLarge(vocab_size=50, dim=32, num_blocks=2, slstm_at=(1,))
    variables = jax_init(jlm, jnp.asarray(prompt))
    lm = carry(tx.xLSTMLarge(50, dim=32, num_blocks=2, slstm_at=(1,), device="cpu"), variables)
    return jlm, variables, lm, prompt


def test_lm_logits_match_jax(tiny_lm):
    jlm, variables, lm, prompt = tiny_lm
    ref = np.asarray(jlm.apply(variables, jnp.asarray(prompt)))
    with torch.no_grad():
        logits = lm(torch.from_numpy(prompt).long())
    assert logits.shape == (2, 5, 50)
    assert_rel(logits.numpy(), ref, 1e-4)


def test_generate_matches_jax(tiny_lm):
    jlm, variables, lm, prompt = tiny_lm
    ref = np.asarray(jx.generate(jlm, variables, jnp.asarray(prompt), max_new_tokens=6))
    out = tx.generate(lm, torch.from_numpy(prompt), max_new_tokens=6)
    assert out.shape == (2, 11)
    np.testing.assert_array_equal(out.numpy(), ref)
    one = tx.generate(lm, torch.from_numpy(prompt[0]), max_new_tokens=2)
    np.testing.assert_array_equal(one.numpy(), ref[:1, :7])


def test_lm_state_dict_is_jax_tree(monkeypatch):
    """The port's LM at the default widths (dim 512, 6 blocks, sLSTM at 1,
    vocabulary 50 304) has exactly JAX's variables: names and shapes from
    ``jax.eval_shape`` of its init, loaded strictly.  Neither model is
    computed: the port's is built on the meta device (its initialisation
    skipped) and takes the numpy values by assignment."""
    tokens = jax.ShapeDtypeStruct((1, 8), jnp.int32)
    jlm = jx.xLSTMLarge(vocab_size=50304, slstm_at=(1,))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), tokens)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = jax_variables_to_state_dict(variables)
    monkeypatch.setattr(tx, "select_device", lambda device: torch.device("meta"))
    monkeypatch.setattr(tx, "reset_parameters", lambda module, g: None)
    with torch.device("meta"):
        model = tx.xLSTMLarge(50304, slstm_at=(1,))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True, assign=True)
    block = model.backbone.block_1
    assert isinstance(block, tx.sLSTMBlock) and block.cell.recurrent_kernel.shape == (4, 4, 128, 128)
    assert block.ffn.up == 704 and model.backbone.block_0.ffn.up == 1408
    assert model.backbone.block_0.mlstm_layer.mlstm_cell.num_heads == 16
    np.testing.assert_array_equal(
        block.conv.weight.detach().numpy(),
        variables["params"]["backbone"]["block_1"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(model.embedding.weight.detach().numpy(),
                                  variables["params"]["embedding"]["embedding"])


def test_scan_refuses_other_devices_and_backends():
    """The scan wrapper never falls back: a tensor on neither the CPU nor a
    CUDA device is refused; so is a backend name JAX does not have."""
    wx = torch.zeros(1, 3, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sl.slstm_sequence(wx, torch.zeros(4, 2, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="unknown sLSTM backend"):
        tx.sLSTMCell(32, 4, backend="cuda")
