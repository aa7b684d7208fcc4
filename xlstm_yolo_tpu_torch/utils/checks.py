"""Environment and argument checks (counterparts of
``xlstm_yolo_tpu/utils/checks.py``): version parsing, image-size rounding,
file presence, the CUDA backend and a bfloat16 numerics check.  Nothing
here installs or downloads."""

from __future__ import annotations

import re
from pathlib import Path

import torch


def parse_version(v: str) -> tuple:
    return tuple(int(x) for x in re.findall(r"\d+", v)[:3] or [0])


def check_version(current: str, required: str = "", name: str = "version") -> bool:
    """``required`` like '>=0.4.20', '==1.2' or '1.2' (meaning >=)."""
    if not required:
        return True
    m = re.match(r"([<>=!]*)\s*([\d.]+)", required)
    op, ver = (m.group(1) or ">="), m.group(2)
    c, r = parse_version(current), parse_version(ver)
    ok = {
        ">=": c >= r, ">": c > r, "<=": c <= r, "<": c < r,
        "==": c == r, "!=": c != r,
    }[op if op in {">=", ">", "<=", "<", "==", "!="} else ">="]
    return ok


def check_imgsz(imgsz, stride: int = 32, min_dim: int = 1) -> int | list:
    """Round an image size (or each of a list) up to a multiple of ``stride``."""
    def fix(v):
        return max(stride, -(-int(v) // stride) * stride)

    if isinstance(imgsz, (list, tuple)):
        return [fix(v) for v in imgsz]
    return fix(imgsz)


def check_cuda_backend(expect_accelerator: bool = False) -> str:
    """``"cuda"`` when a CUDA device is present, else ``"cpu"``; raises when
    ``expect_accelerator`` and there is none."""
    if torch.cuda.is_available():
        return "cuda"
    if expect_accelerator:
        raise RuntimeError("expected a CUDA device but torch sees only the CPU")
    return "cpu"


def check_file(path: str | Path, hard: bool = True) -> str | None:
    p = Path(path)
    if p.exists():
        return str(p)
    if hard:
        raise FileNotFoundError(f"'{path}' does not exist")
    return None


def check_amp(device: str | torch.device = "cuda") -> bool:
    """A bfloat16 matmul on ``device`` stays finite and within 5% (of the
    largest value) of the float32 one: a numerics check, no GradScaler."""
    a = torch.linspace(-2, 2, 64 * 64, device=device).reshape(64, 64)
    f32 = a @ a
    bf16 = (a.bfloat16() @ a.bfloat16()).float()
    err = (bf16 - f32).abs().max() / (f32.abs().max() + 1e-9)
    return bool(torch.isfinite(bf16).all() and err < 0.05)
