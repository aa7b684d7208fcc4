"""Image reading and PNG writing without OpenCV or PIL.

The port's counterpart of ``cv2.imread(path)`` (``IMREAD_COLOR``) and
``cv2.imwrite`` for PNG files, for machines without OpenCV or PIL.
:func:`imread` returns what ``cv2.imread`` returns for the same file: a
uint8 (H, W, 3) BGR array, turned as its EXIF orientation says (the
``eXIf`` chunk of a PNG, the first APP1 segment of a JPEG), as OpenCV
does by default.

JPEG files are decoded by ``csrc/jpeg_decode.cpp`` (host C++, built by
``ops/host_build`` at first use and called through ``ctypes``, which
releases the GIL): baseline, extended and progressive Huffman files at 8
bits, grey or three components, truncated ones as libjpeg reads them
(progressive ones block-smoothed), byte-equal to OpenCV's libjpeg-turbo.

PNG is decoded with ``zlib`` and numpy.  It reads every non-interlaced PNG:
colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA)
at their allowed bit depths (1/2/4/8/16 for grey, 1/2/4/8 for palette, 8/16
for the others), with all five row filters.  OpenCV's conversions:

- grey is repeated into three channels; alpha (and ``tRNS``) is dropped;
- 1/2/4-bit grey is scaled to 8 bits (``v * 255 / (2**bits - 1)``);
- palette indices are expanded through ``PLTE`` at any depth;
- 16-bit samples keep their high byte (libpng's ``png_set_strip_16``).

Errors name the file.  Data that ``cv2.imread`` returns None for raises
:class:`CorruptImageError` (a ValueError): a truncated or corrupt PNG, a
JPEG that libjpeg stops on, a file of no known format.  A file that
OpenCV reads but the port cannot decode raises a plain ValueError naming
what it lacks: an Adam7-interlaced PNG; WebP, TIFF, BMP or GIF; a JPEG
with 12-bit samples, arithmetic coding, lossless coding or four
components.  A missing file raises ``FileNotFoundError``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from xlstm_yolo_tpu_torch.ops import host_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"RIFF", "WebP"), (b"II*\x00", "TIFF"),
          (b"MM\x00*", "TIFF"), (b"BM", "BMP"), (b"GIF8", "GIF"))


class CorruptImageError(ValueError):
    """Image data that ``cv2.imread`` returns None for."""


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
            raise CorruptImageError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise CorruptImageError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise CorruptImageError(f"{path}: PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8 scanlines."""
    if len(raw) < height * (stride + 1):
        raise CorruptImageError(f"{path}: PNG image data is too short")
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
            raise CorruptImageError(f"{path}: unknown PNG row filter {ftype} in row {y}")
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
    img, exif = _decode_png(data, path)
    # libpng keeps the first eXIf chunk that starts "II" or "MM"
    if exif is not None and len(exif) >= 2 and exif[0] == exif[1] and exif[:1] in (b"I", b"M"):
        img = orient(img, _jpeg_lib().jpeg_exif_orientation(exif, len(exif)))
    return img


def _decode_png(data: bytes, path) -> tuple[np.ndarray, bytes | None]:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: unsupported image format {image_format(data[:16])}; "
                         "only PNG is read")
    header = palette = exif = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None:
            exif = body
    if header is None or not idat:
        raise CorruptImageError(f"{path}: PNG without IHDR or IDAT")
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
        raise CorruptImageError(f"{path}: corrupt PNG image data ({exc})") from None
    s = _samples(_unfilter(raw, height, stride, bpp, path), width, channels, depth)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = s[..., 0]
        if int(idx.max()) >= len(palette):
            raise CorruptImageError(f"{path}: palette index past the end of PLTE")
        return np.ascontiguousarray(palette[idx][..., ::-1]), exif
    if ctype in (0, 4):
        grey = s[..., 0]
        if depth < 8:
            grey = (grey.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2), exif
    return np.ascontiguousarray(s[..., 2::-1]), exif  # RGB(A) -> BGR


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned as EXIF orientation 1-8 says (OpenCV's
    ``ExifTransform``); any other value leaves it as it is."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.transpose(1, 0, 2)
    elif orientation == 6:
        img = img.transpose(1, 0, 2)[:, ::-1]
    elif orientation == 7:
        img = img[::-1, ::-1].transpose(1, 0, 2)
    elif orientation == 8:
        img = img.transpose(1, 0, 2)[::-1]
    else:
        return img
    return np.ascontiguousarray(img)


def _declare(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_void_p)] + [ctypes.POINTER(ctypes.c_int)] * 3 \
        + [ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.restype = None
    lib.jpeg_exif_orientation.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.jpeg_exif_orientation.restype = ctypes.c_int


def _jpeg_lib() -> ctypes.CDLL:
    return host_build.load("jpeg_decode", _declare)


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) BGR, as ``cv2.imread`` returns them."""
    lib = _jpeg_lib()
    out, h, w, o = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    rc = lib.jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(o), msg, len(msg))
    if rc == 1:
        raise CorruptImageError(f"{path}: corrupt JPEG: {msg.value.decode()}")
    if rc != 0:
        raise ValueError(f"{path}: {msg.value.decode()} is not decoded by the port")
    try:
        buf = (ctypes.c_uint8 * (h.value * w.value * 3)).from_address(out.value)
        img = np.frombuffer(buf, np.uint8).reshape(h.value, w.value, 3).copy()
    finally:
        lib.jpeg_free(out)
    return orient(img, o.value)


def decode(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG or JPEG bytes -> uint8 (H, W, 3) BGR, as ``cv2.imread`` returns them."""
    fmt = image_format(data[:16])
    if fmt == "PNG":
        return decode_png(data, path)
    if fmt == "JPEG":
        return decode_jpeg(data, path)
    if fmt == "unknown":
        raise CorruptImageError(f"{path}: not an image file of a known format")
    raise ValueError(f"{path}: {fmt} images are not decoded by the port yet (PNG and JPEG are)")


def imread(path) -> np.ndarray:
    """``cv2.imread(path)`` for PNG and JPEG files: uint8 (H, W, 3) BGR."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"image not found {path}")
    return decode(p.read_bytes(), path)


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
