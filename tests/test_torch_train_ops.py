"""The port's fused training epilogue and FFN (forward, and the backward's
plain version) against the JAX package's ``epilogue_fused`` and
``ffn_fused`` under ``jax.grad``, with their Pallas backward kernels
interpreted on the CPU.

Inputs are made with numpy from a seed and given to both sides; weights go
from the JAX layout to the port's (transposed).  Tolerances, relative to
the largest |value| of each output: float32 2e-5 (the same float32 math,
summed in another order); bfloat16 3e-2 (the JAX kernel keeps dz and the
gate gradients in float32 where the port's autograd rounds them to
bfloat16, a few bfloat16 ulps).  Each is run at a small width and at the widths of
vil-det-256 (H 512, D 256, U 704, NH 8) and vil-det-384 (H 768, D 384,
U 1024, NH 6), where the CUDA kernels tile 16 rows.  The large-mean case uses the centred
variance on both sides and must stay finite; in float32 its h - mean keeps
about 5 bits fewer (the float32 ulp at 300 is 3e-5), so it is held to
2e-4, as the JAX package's own large-mean test is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas.epilogue import epilogue_fused
from xlstm_yolo_tpu.ops.pallas.ffn import ffn_fused
from xlstm_yolo_tpu_torch.ops import epilogue, ffn

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, S, NH = 2, 64, 4
H, D, U = 64, 32, 96
SMALL = (B, S, NH, H, D, U)
WIDE = {  # (B, S, NH, H, D, U) of the larger detectors' layers, fewer rows
    "vil-det-256": (1, 40, 8, 512, 256, 704),
    "vil-det-384": (1, 40, 6, 768, 384, 1024),
}


def close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=rel, err_msg=name)


def as_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def as_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("offset,widths", [
    pytest.param(0.0, SMALL, id="centred"), pytest.param(300.0, SMALL, id="large_mean"),
    pytest.param(0.0, WIDE["vil-det-256"], id="centred-vil-det-256"),
    pytest.param(300.0, WIDE["vil-det-384"], id="large_mean-vil-det-384")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_gradients_match_jax(dtype, offset, widths):
    B, S, NH, H, D, _ = widths
    rng = np.random.default_rng(11)
    h = rng.normal(offset, 1.0, (B, S, H)).astype(np.float32)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    ln_w, ln_b = (rng.normal(0, 0.1, H).astype(np.float32) for _ in range(2))
    skip = rng.normal(1, 0.1, H).astype(np.float32)
    wd = rng.normal(0, 0.05, (H, D)).astype(np.float32)  # the JAX layout (H, D)
    bd = rng.normal(0, 0.1, D).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)

    def scal(h, x, ln_w, ln_b, skip, wd, bd):
        out = epilogue_fused(h, x, ln_w, ln_b, skip, wd, bd, NH, 1e-6)
        return jnp.sum(out.astype(jnp.float32) * as_jax(g, dtype).astype(jnp.float32)), out

    jargs = (as_jax(h, dtype), as_jax(x, dtype), *map(jnp.asarray, (ln_w, ln_b, skip, wd, bd)))
    (_, out_ref), g_ref = jax.value_and_grad(scal, argnums=tuple(range(7)), has_aux=True)(*jargs)

    th, tx = as_torch(h, dtype), as_torch(x, dtype)
    params = [torch.from_numpy(a).requires_grad_() for a in (ln_w, ln_b, skip, wd.T.copy(), bd)]
    th.requires_grad_(), tx.requires_grad_()
    out = epilogue.epilogue(th, tx, *params, NH, 1e-6)
    got = torch.autograd.grad(out, [th, tx, *params], as_torch(g, dtype))
    rel = TOL[dtype] if offset == 0.0 or dtype == "bfloat16" else 2e-4
    close(out.float().detach(), np.asarray(out_ref, np.float32), rel, "out")
    names = ("dh", "dx", "dln_w", "dln_b", "dskip", "dwd", "dbd")
    for name, a, b in zip(names, got, g_ref):
        a = a.float().numpy()
        close(a.T if name == "dwd" else a, np.asarray(b, np.float32), rel, name)


@pytest.mark.parametrize("offset,widths", [
    pytest.param(0.0, SMALL, id="centred"), pytest.param(30.0, SMALL, id="large_mean"),
    pytest.param(0.0, WIDE["vil-det-256"], id="centred-vil-det-256"),
    pytest.param(30.0, WIDE["vil-det-384"], id="large_mean-vil-det-384")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_gradients_match_jax(dtype, offset, widths):
    B, S, _, _, D, U = widths
    rng = np.random.default_rng(12)
    x = rng.normal(offset, 1.0, (B, S, D)).astype(np.float32)
    wn = rng.normal(1, 0.1, D).astype(np.float32)
    wgz = rng.normal(0, D ** -0.5, (D, 2 * U)).astype(np.float32)  # the JAX layout
    bgz = rng.normal(0, 0.1, 2 * U).astype(np.float32)
    wd = rng.normal(0, U ** -0.5, (U, D)).astype(np.float32)
    bd = rng.normal(0, 0.1, D).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)

    def scal(x, wn, wgz, bgz, wd, bd):
        out = ffn_fused(x, wn, wgz, bgz, wd, bd, 1e-6)
        return jnp.sum(out.astype(jnp.float32) * as_jax(g, dtype).astype(jnp.float32)), out

    jargs = (as_jax(x, dtype), *map(jnp.asarray, (wn, wgz, bgz, wd, bd)))
    (_, out_ref), g_ref = jax.value_and_grad(scal, argnums=tuple(range(6)), has_aux=True)(*jargs)

    tx = as_torch(x, dtype).requires_grad_()
    params = [torch.from_numpy(a).requires_grad_()
              for a in (wn, wgz.T.copy(), bgz, wd.T.copy(), bd)]
    out = ffn.ffn(tx, *params, 1e-6)
    got = torch.autograd.grad(out, [tx, *params], as_torch(g, dtype))
    rel = TOL[dtype]
    close(out.float().detach(), np.asarray(out_ref, np.float32), rel, "out")
    names = ("dx", "dwn", "dwgz", "dbgz", "dwd", "dbd")
    for name, a, b in zip(names, got, g_ref):
        a = a.float().numpy()
        close(a.T if name in ("dwgz", "dwd") else a, np.asarray(b, np.float32), rel, name)


def test_ffn_plain_backward_equals_autograd_of_the_forward():
    """The plain backward joins its two pieces at the saved gz: it equals
    autograd straight through :func:`ffn_forward`, up-projection bias
    included."""
    rng = np.random.default_rng(13)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x, wn, wgz, bgz, wd, bd, g = t(B, 9, D), t(D), t(2 * U, D), t(2 * U), t(D, U), t(D), t(B, 9, D)
    leaves = [a.clone().requires_grad_() for a in (x, wn, wgz, bgz, wd, bd)]
    out, gz = ffn.ffn_forward(*leaves)
    ref = torch.autograd.grad(out, leaves, g)
    got = ffn.ffn_bwd_plain(x, gz.detach(), g, wn, wgz, wd)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
