"""File helpers (counterparts of ``xlstm_yolo_tpu/utils/files.py``)."""

from __future__ import annotations

import contextlib
import glob
import os
import time
from datetime import datetime
from pathlib import Path


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... (JAX's semantics)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def file_age(path: str | Path) -> int:
    """Days since last modification."""
    dt = datetime.now() - datetime.fromtimestamp(Path(path).stat().st_mtime)
    return dt.days


def file_size(path: str | Path) -> float:
    """Size in MB (files or directory trees)."""
    p = Path(path)
    mb = 1 << 20
    if p.is_file():
        return p.stat().st_size / mb
    if p.is_dir():
        return sum(f.stat().st_size for f in p.glob("**/*") if f.is_file()) / mb
    return 0.0


def get_latest_run(search_dir: str = ".") -> str:
    """Most recent 'last' checkpoint under runs/ (resume helper)."""
    paths = glob.glob(f"{search_dir}/**/last*", recursive=True)
    return max(paths, key=os.path.getctime) if paths else ""


@contextlib.contextmanager
def working_directory(new_dir: str | Path):
    cwd = Path.cwd()
    os.chdir(new_dir)
    try:
        yield
    finally:
        os.chdir(cwd)


@contextlib.contextmanager
def spaces_in_path(path: str | Path):
    """Temp-copy a path containing spaces (a workaround for tools that split on them)."""
    path = Path(path)
    if " " not in str(path):
        yield path
        return
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        dst = Path(tmp) / str(path.name).replace(" ", "_")
        if path.is_file():
            shutil.copy2(path, dst)
        else:
            shutil.copytree(path, dst)
        try:
            yield dst
        finally:
            if dst.is_file() and path.exists():
                shutil.copy2(dst, path)
