"""The port's logger and persistent settings (counterparts of ``LOGGER``,
``colorstr`` and ``SettingsManager`` in ``xlstm_yolo_tpu/utils/logger.py``).

``SettingsManager`` keeps a JSON dict at
``~/.config/xlstm_yolo_tpu_torch/settings.json`` (the JAX package keeps its
own file), written atomically; the defaults are JAX's.  No telemetry.  The
logger's level is INFO (JAX's reads an environment variable; the port
reads none): set it with ``LOGGER.setLevel``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

LOGGER = logging.getLogger("xlstm_yolo_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel("INFO")


def colorstr(*args) -> str:
    """ANSI-coloured text: ``colorstr("red", "bold", text)``; one argument is
    blue and bold."""
    *fmt, string = args if len(args) > 1 else ("blue", "bold", args[0])
    codes = {
        "black": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
        "magenta": 35, "cyan": 36, "white": 37, "bold": 1, "underline": 4,
    }
    prefix = "".join(f"\033[{codes[c]}m" for c in fmt if c in codes)
    return f"{prefix}{string}\033[0m"


class SettingsManager(dict):
    """User settings with versioned defaults; a stored file of another
    ``settings_version`` is ignored."""

    def __init__(self, path: str | Path | None = None, version: str = "0.1.0"):
        self.path = Path(
            path or Path.home() / ".config" / "xlstm_yolo_tpu_torch" / "settings.json"
        )
        self.version = version
        defaults = {
            "settings_version": version,
            "datasets_dir": str(Path.home() / "datasets"),
            "weights_dir": "weights",
            "runs_dir": "runs",
            "sync": False,  # no telemetry, ever
        }
        super().__init__(defaults)
        try:
            if self.path.exists():
                stored = json.loads(self.path.read_text())
                if stored.get("settings_version") == version:
                    self.update(stored)
        except (OSError, ValueError):  # an unreadable file leaves the defaults
            pass

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(dict(self), indent=2))
        tmp.replace(self.path)

    def reset(self):
        # remove the stored file first: __init__ re-reads it on a version
        # match, which would undo the reset
        self.path.unlink(missing_ok=True)
        self.clear()
        self.__init__(self.path, self.version)
        self.save()


SETTINGS = SettingsManager()
