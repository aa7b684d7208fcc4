"""The port's export, quantization, model info and benchmarks, held against
the JAX package on the CPU (``vil-det-tiny`` at 160 px).

1. int8: the port's ``quantize_state_dict``, dequantized, is bit-equal to
   JAX's ``dequantize_tree(quantize_tree(params))`` carried across by
   ``jax_variables_to_state_dict`` (weights from a numpy seed, with zero
   output channels); the same leaves are quantized, batch statistics are
   not; JAX's per-column error bound (``tests/test_export.py``).
2. Export round trips: ``torch`` reloaded by ``AutoBackend(fuse=False)``
   gives the model's own detections exactly, with its sidecar and
   ``metadata.json``; ``torch_int8`` passes JAX's structural checks; the
   export callbacks run; a JAX format is refused before anything is
   written.
3. ``info["params"]`` equals JAX's count, ``get_flops`` is within 2% of
   JAX's XLA cost analysis; ``profile_ops`` and ``init_seeds``.
4. ``benchmark``: the rows on the CPU, a JAX format's refusal as a row,
   any other error raised; the kernel sweep's grid is JAX's, and a small
   sweep with the backward runs.
"""

import json
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.utils import model_utils as jax_model_utils
from xlstm_yolo_tpu.utils.quantize import dequantize_tree, is_quantized_tree, quantize_tree
from xlstm_yolo_tpu.utils.torch_convert import convert_torch_state_dict
from xlstm_yolo_tpu_torch.engine.exporter import Exporter, export_formats
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.nn.autobackend import AutoBackend
from xlstm_yolo_tpu_torch.nn.tasks import CFG_MODELS, build_detection_model
from xlstm_yolo_tpu_torch.utils import benchmarks
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict
from xlstm_yolo_tpu_torch.utils.model_utils import (
    get_flops,
    init_seeds,
    model_info,
    n_params,
    profile_ops,
)
from xlstm_yolo_tpu_torch.utils.quantize import (
    channel_axes,
    dequantize_state_dict,
    is_quantized_state_dict,
    quantize_state_dict,
)

torch.set_num_threads(1)

TINY = CFG_MODELS / "vil-det-tiny.yaml"
IMGSZ = 160


@pytest.fixture(scope="module")
def carried():
    """The tiny detector with weights from a numpy seed (some output
    channels zero, so their scale is 1), and JAX's variables of the same
    values (shapes from ``jax.eval_shape``)."""
    model, _ = build_detection_model(TINY, device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    axes = channel_axes(model)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
                continue
            t.copy_(torch.from_numpy(rng.normal(0, 0.05, t.shape)))
            if t.dim() >= 2 and t.numel() >= 1024 and rng.random() < 0.3:
                t.select(axes[name], 0).zero_()  # a whole output channel
    jm, _ = jax_build(TINY, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)))
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    variables = jax.tree.map(np.asarray, convert_torch_state_dict(shapes, sd, strict=True))
    return SimpleNamespace(model=model, jm=jm, shapes=shapes, variables=variables, axes=axes)


def test_int8_dequantized_bit_equal_to_jax(carried):
    qjax = quantize_tree(carried.variables["params"])
    want = jax_variables_to_state_dict(
        {"params": dequantize_tree(qjax), "batch_stats": carried.variables["batch_stats"]})
    sd = carried.model.state_dict()
    q = quantize_state_dict(sd, carried.axes)
    got = dequantize_state_dict(q)
    assert set(got) == set(want) == set(sd)
    for name in sd:
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], want[name]), name
    n_jax = sum(isinstance(v, dict) and set(v) == {"q", "s"}
                for v in jax.tree.leaves(qjax, is_leaf=lambda x: isinstance(x, dict)
                                         and set(x) == {"q", "s"}))
    pairs = [k for k, v in q.items() if isinstance(v, dict)]
    assert is_quantized_tree(qjax) and is_quantized_state_dict(q)
    assert len(pairs) == n_jax > 100
    assert not any(k.endswith(("running_mean", "running_var")) for k in pairs)
    assert all(q[k]["q"].dtype == torch.int8 and q[k]["s"].dtype == torch.float32
               for k in pairs)
    zero = [k for k in pairs if (q[k]["s"] == 1).any()]
    assert zero, "no zero output channel was exercised"


def test_int8_dequant_error_bound():
    r = np.random.default_rng(0)
    kernel = r.normal(size=(64, 32)).astype(np.float32)  # flax (in, out)
    bias = r.normal(size=(32,)).astype(np.float32)
    sd = {"dense.weight": torch.from_numpy(kernel.T.copy()), "dense.bias": torch.from_numpy(bias)}
    deq = dequantize_state_dict(quantize_state_dict(sd, {"dense.weight": 0, "dense.bias": 0}))
    dk = deq["dense.weight"].numpy().T
    # per-channel symmetric int8: max error <= scale/2 = max|w|/127/2 per column
    bound = np.abs(kernel).max(axis=0) / 127.0
    assert (np.abs(kernel - dk) <= bound[None, :] + 1e-7).all()
    np.testing.assert_allclose(deq["dense.bias"].numpy(), bias, atol=np.abs(bias).max() / 126)


@pytest.fixture(scope="module")
def yolo():
    return YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def img():
    return torch.from_numpy(np.random.default_rng(1).integers(0, 255, (1, IMGSZ, IMGSZ, 3),
                                                              dtype=np.uint8))


def test_export_formats_table():
    assert {r["format"] for r in export_formats()} == {"torch", "torch_int8"}


def test_torch_export_round_trip(yolo, img, tmp_path):
    events = []
    yolo.add_callback("on_export_start", lambda e: events.append(("start", e.args.format)))
    yolo.add_callback("on_export_end", lambda e: events.append(("end", e.file.name)))
    try:
        path = yolo.export("torch", out_dir=tmp_path)
    finally:
        yolo.callbacks.clear()
    assert events == [("start", "torch"), ("end", "model.pt")]
    meta = json.loads((tmp_path / "model.pt.meta.json").read_text())
    assert meta["args"] == {"model": yolo.model_cfg, "imgsz": IMGSZ, "task": "detect",
                            "data": None}
    assert json.loads((tmp_path / "metadata.json").read_text())["format"] == "torch"
    ab = AutoBackend(path, fuse=False, device="cpu", compute_dtype=torch.float32)
    assert ab.format == "torch" and ab.imgsz == IMGSZ
    with torch.no_grad():
        want = yolo.model(img.float() / 255.0)[0]
    assert torch.equal(ab(img), want)


def test_torch_int8_export_reloads(yolo, img, tmp_path):
    path = yolo.export("torch_int8", out_dir=tmp_path)
    assert path.endswith("model_int8.pt")
    stored = torch.load(path, weights_only=True)
    assert any(isinstance(v, dict) and v["q"].dtype == torch.int8 for v in stored.values())
    meta = json.loads((tmp_path / "model_int8.pt.meta.json").read_text())
    assert meta["quantization"] == "int8 weight-only, per-output-channel symmetric"
    ab = AutoBackend(path, fuse=False, device="cpu", compute_dtype=torch.float32)
    assert ab.format == "torch_int8"
    got = ab(img).numpy()
    with torch.no_grad():
        want = yolo.model(img.float() / 255.0)[0].numpy()
    # JAX's structural checks: a random model's boxes are chaotic under the
    # weights' rounding, so finite outputs, valid classes and confidences
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert ((got[..., 5] >= 0) & (got[..., 5] < 80)).all()
    assert ((got[..., 4] >= 0) & (got[..., 4] <= 1)).all()


@pytest.mark.parametrize("fmt", ["stablehlo", "orbax", "orbax_int8", "savedmodel", "tflite",
                                 "onnx"])
def test_other_formats_refused_before_writing(yolo, tmp_path, fmt):
    out = tmp_path / "out"
    args = SimpleNamespace(format=fmt, imgsz=IMGSZ, batch=1, model=yolo.model_cfg)
    with pytest.raises(ValueError, match="JAX package's" if fmt != "onnx" else "unknown") as e:
        Exporter(args)(yolo.model, out_dir=out)
    assert "torch_int8" in str(e.value) and not out.exists()


def test_params_and_flops_match_jax(yolo, carried):
    assert yolo.info == {"params": jax_model_utils.n_params(carried.shapes["params"]),
                         "cfg": yolo.model_cfg}
    assert n_params(yolo.model) == 1_030_624
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), carried.shapes)
    want = jax_model_utils.get_flops(lambda v, x: jax.tree.leaves(carried.jm.apply(v, x))[0],
                                     zeros, jnp.zeros((1, IMGSZ, IMGSZ, 3)))
    got = get_flops(yolo.model, IMGSZ)
    assert abs(got / want - 1) < 0.02, (got, want)
    bf16, _ = build_detection_model(TINY, device="cpu")  # the count does not depend on types
    assert get_flops(bf16, IMGSZ) == got
    info = model_info(yolo.model, IMGSZ, verbose=False)
    assert info["params"] == 1_030_624 and info["GFLOPs@160px"] == round(got, 1)


def test_profile_ops_and_seeds():
    a = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 96)).astype(np.float32))
    rows = profile_ops([("mm", torch.mm, (a, a.T)), ("relu", torch.relu, (a,))], n=3, warmup=1)
    assert [r["op"] for r in rows] == ["mm", "relu"] and all(r["ms"] >= 0 for r in rows)
    assert [r["gflops"] for r in rows] == [round(2 * 64 * 96 * 64 / 1e9, 2), 0.0]
    g = init_seeds(3)
    assert g.initial_seed() == 3 and torch.initial_seed() == 3
    first = random.random(), np.random.random()
    init_seeds(3)
    assert (random.random(), np.random.random()) == first


def test_benchmark_rows(yolo, tmp_path):
    rows = yolo.benchmark(imgsz=IMGSZ, batch=2, formats=("eager", "torch", "orbax", "torch_int8"),
                          verbose=False, out_dir=tmp_path)
    assert [r["format"] for r in rows] == ["eager", "torch", "orbax", "torch_int8"]
    for r in rows[:2] + rows[3:]:
        assert r["status"] == "ok" and r["ms/img"] > 0 and r["img/s"] > 0
        assert r["mAP50-95"] is None
    assert rows[2]["status"].startswith("ValueError") and "JAX package's" in rows[2]["status"]


def test_benchmark_raises_other_errors(yolo, tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr("xlstm_yolo_tpu_torch.nn.autobackend.AutoBackend.forward", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        yolo.benchmark(imgsz=IMGSZ, batch=1, formats=("torch",), verbose=False,
                       out_dir=tmp_path)


def test_kernel_sweep_grid_and_rows():
    from xlstm_yolo_tpu.utils.benchmarks import KernelBenchConfig as JaxConfig

    assert vars(benchmarks.KernelBenchConfig()) == vars(JaxConfig())
    cfg = benchmarks.KernelBenchConfig(B=[1], NH=[2], S=[96, 128], DH=[16], chunk_size=[64],
                                       with_backward=True)
    rows = benchmarks.run_kernel_benchmark(cfg, device="cpu", iters=2, warmup=1)
    assert [(r["kernel"], r["S"]) for r in rows] == [
        ("chunkwise--native_autograd", 128), ("chunkwise--pallas_xl_chunk_siging", 128)]
    assert all(r["ms"] > 0 and r["ms_fwd_bwd"] > 0 for r in rows)
