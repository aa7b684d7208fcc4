"""PNG reading and writing with the standard library and numpy.

The port's counterpart of ``cv2.imread(path)`` (``IMREAD_COLOR``) and
``cv2.imwrite`` for PNG files, for machines without OpenCV or PIL.
:func:`imread` returns what ``cv2.imread`` returns for the same file: a
uint8 (H, W, 3) BGR array.  It reads every non-interlaced PNG: colour
types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) at
their allowed bit depths (1/2/4/8/16 for grey, 1/2/4/8 for palette, 8/16
for the others), with all five row filters.  OpenCV's conversions:

- grey is repeated into three channels; alpha (and ``tRNS``) is dropped;
- 1/2/4-bit grey is scaled to 8 bits (``v * 255 / (2**bits - 1)``);
- palette indices are expanded through ``PLTE`` at any depth;
- 16-bit samples keep their high byte (libpng's ``png_set_strip_16``).

Anything else raises a ``ValueError`` naming the file: an Adam7-interlaced
PNG, a JPEG, WebP, TIFF, BMP or GIF file, a truncated or corrupt PNG.  A
missing file raises ``FileNotFoundError``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"RIFF", "WebP"), (b"II*\x00", "TIFF"),
          (b"MM\x00*", "TIFF"), (b"BM", "BMP"), (b"GIF8", "GIF"))


def image_format(head: bytes) -> str:
    """The format a file's first bytes announce ("PNG", "JPEG", ...)."""
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return "unknown"


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8 scanlines."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    if not rows[:, 0].any():  # every row unfiltered
        return rows[:, 1:].copy()
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum over each byte's pixel lane
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        elif ftype == 4:  # Paeth
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                if i >= bpp:
                    pred = _paeth(cur[i - bpp], up[i], up[i - bpp])
                else:
                    pred = up[i]
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(lines: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Scanlines -> (H, W, channels) samples: uint8 (bit depths up to 8,
    unscaled) or the high byte of each 16-bit sample."""
    h = lines.shape[0]
    if depth == 16:
        return lines[:, : width * channels * 2].reshape(h, width, channels, 2)[..., 0]
    if depth == 8:
        return lines[:, : width * channels].reshape(h, width, channels)
    bits = np.unpackbits(lines, axis=1).reshape(h, -1, depth)[:, :width]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) BGR, as ``cv2.imread`` returns them."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: unsupported image format {image_format(data[:16])}; "
                         "only PNG is read")
    header = palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not valid")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    if interlace == 1:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if interlace != 0:
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    if width == 0 or height == 0:
        raise ValueError(f"{path}: PNG of size {width}x{height}")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt PNG image data ({exc})") from None
    s = _samples(_unfilter(raw, height, stride, bpp, path), width, channels, depth)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = s[..., 0]
        if int(idx.max()) >= len(palette):
            raise ValueError(f"{path}: palette index past the end of PLTE")
        return np.ascontiguousarray(palette[idx][..., ::-1])
    if ctype in (0, 4):
        grey = s[..., 0]
        if depth < 8:
            grey = (grey.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(s[..., 2::-1])  # RGB(A) -> BGR


def imread(path) -> np.ndarray:
    """``cv2.imread(path)`` for PNG files: uint8 (H, W, 3) BGR."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"image not found {path}")
    return decode_png(p.read_bytes(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W, 3) BGR or (H, W) grey -> PNG bytes (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected a uint8 (H, W) or (H, W, 3) image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = img if img.ndim == 2 else img[..., ::-1].reshape(h, w * 3)  # BGR -> RGB
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def imwrite_png(path, img: np.ndarray, level: int = 6) -> None:
    """``cv2.imwrite(path, img)`` for PNG: uint8 BGR or grey, filter 0."""
    Path(path).write_bytes(encode_png(img, level))
