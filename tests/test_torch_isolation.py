"""The port stands alone: it imports neither JAX nor the JAX package, its
model YAMLs are the JAX package's byte for byte, and its entry points run
on the GPU unless the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[blocked] = None  # any import of these raises ImportError
import xlstm_yolo_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "xlstm_yolo_tpu" or m.startswith("xlstm_yolo_tpu."))
print(len(names), "modules")
assert not leaked, leaked
"""


def test_port_imports_without_jax_or_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


@pytest.mark.parametrize("name", ["vil-det-192.yaml", "vil-det-tiny.yaml"])
def test_model_yamls_are_copies(name):
    port = ROOT / "xlstm_yolo_tpu_torch" / "cfg" / "models" / name
    ref = ROOT / "xlstm_yolo_tpu" / "cfg" / "models" / name
    assert port.read_bytes() == ref.read_bytes()


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    from xlstm_yolo_tpu_torch.engine.model import YOLO
    from xlstm_yolo_tpu_torch.engine.steps import detect_trainer
    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
    from xlstm_yolo_tpu_torch.nn.xlstm import generate, xLSTMLarge
    from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: YOLO("vil-det-tiny.yaml"),
                 lambda: build_detection_model("vil-det-tiny.yaml"),
                 lambda: build_detection_model("vil-det-tiny.yaml", training=True),
                 lambda: detect_trainer("vil-det-tiny.yaml"),
                 lambda: xLSTMLarge(50, dim=32, num_blocks=2, slstm_at=(1,)),
                 lambda: select_device()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    yolo = YOLO("vil-det-tiny.yaml", device="cpu")
    assert yolo.device == torch.device("cpu")
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu")
    assert next(model.parameters()).device == torch.device("cpu") and not model.training
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)
    assert next(model.parameters()).device == torch.device("cpu") and model.training
    model, state, step = detect_trainer("vil-det-tiny.yaml", device="cpu")
    assert model.training and state.step == 0 and callable(step)
    assert all(p.device == torch.device("cpu") for p in state.params.values())
    lm = xLSTMLarge(50, dim=32, num_blocks=2, slstm_at=(1,), device="cpu")
    assert next(lm.parameters()).device == torch.device("cpu") and not lm.training
    assert generate(lm, torch.tensor([1, 2, 3]), max_new_tokens=2).device == torch.device("cpu")
