"""Write the JPEG fixtures of ``tests/fixtures/jpeg`` and their manifest.

Each fixture is encoded here with OpenCV or PIL (both needed, so run it
where they are installed) from a seeded synthetic image, and the manifest
records the sha256 and shape of the bytes ``cv2.imread`` returns for it,
or the error the port raises for a file it refuses.  The port's decoder is
held against the manifest on machines without OpenCV (``chip_smoke.py``
phase ``serve``) and against ``cv2.imread`` itself in
``tests/test_torch_jpeg.py``.

    python scripts/make_jpeg_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "jpeg"


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth BGR scene with texture: gradients, waves and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 23 + seed), 128 + 90 * np.cos(y / 17),
                     128 + 60 * np.sin((x + 2 * y) / 41)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, fmt: str = "JPEG", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(buf, fmt, **kw)
    return buf.getvalue()


def cv2_jpeg(img: np.ndarray, *flags) -> bytes:
    ok, enc = cv2.imencode(".jpg", img, list(flags))
    assert ok
    return enc.tobytes()


def fixtures() -> dict[str, bytes]:
    small = scene(97, 211, 1)
    exif = Image.Exif()
    exif[0x0112] = 6
    baseline = pil_jpeg(small, quality=85)
    progressive = pil_jpeg(small, quality=90, progressive=True)
    arith = bytearray(baseline)  # SOF0 -> SOF9: an arithmetic-coded frame header
    arith[bytes(arith).index(b"\xff\xc0") + 1] = 0xC9
    return {
        "q90_420_640x480.jpg": cv2_jpeg(scene(480, 640, 0), cv2.IMWRITE_JPEG_QUALITY, 90),
        "progressive_q75_97x211.jpg": pil_jpeg(small, quality=75, progressive=True),
        "restart_440_97x211.jpg": cv2_jpeg(
            small, cv2.IMWRITE_JPEG_RST_INTERVAL, 3, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "optimized_422_q95_97x211.jpg": pil_jpeg(small, quality=95, optimize=True, subsampling=1),
        "q100_444_7x13.jpg": pil_jpeg(scene(7, 13, 2), quality=100, subsampling=0),
        "gray_q50_17x33.jpg": pil_jpeg(scene(17, 33, 3)[..., 1], quality=50),
        "exif6_97x211.jpg": pil_jpeg(small, quality=80, exif=exif.tobytes()),
        "truncated_97x211.jpg": baseline[: len(baseline) * 3 // 5],
        "truncated_progressive_97x211.jpg": progressive[: len(progressive) // 3],
        "two_frames_97x211.mpo": pil_jpeg(small, "MPO", save_all=True,
                                          append_images=[Image.fromarray(scene(97, 211, 4))]),
        "cmyk_97x211.jpg": _cmyk(small),
        "arithmetic_97x211.jpg": bytes(arith),
    }


def _cmyk(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, data in fixtures().items():
        path = OUT / name
        path.write_bytes(data)
        if name.startswith("cmyk"):
            manifest[name] = {"raises": "4-component"}
            continue
        if name.startswith("arithmetic"):
            manifest[name] = {"raises": "arithmetic"}
            continue
        img = cv2.imread(str(path))
        manifest[name] = {"shape": list(img.shape),
                          "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(manifest)} fixtures, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
