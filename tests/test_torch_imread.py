"""The port's PNG reader equals ``cv2.imread`` byte for byte.

Every colour type at every bit depth PNG allows, each of the five row
filters, odd widths, a 1x1 image and sub-byte rows that end mid-byte:
files written by a general encoder below and by ``cv2.imwrite``, read by
``cv2.imread`` (IMREAD_COLOR) and by the port.  Interlaced PNGs and other
formats raise a ValueError naming the file."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from xlstm_yolo_tpu_torch.data.imread import encode_png, imread, imwrite_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [(3, d) for d in (1, 2, 4, 8)] \
    + [(4, 8), (4, 16), (6, 8), (6, 16)]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(ftype, cur, prev, bpp):
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def encode(samples, depth, ctype, filters, palette=None, interlace=0, trns=None):
    """(H, W, C) integer samples -> PNG bytes, row y filtered with
    ``filters[y % len(filters)]``."""
    h, w, c = samples.shape
    if depth == 16:
        lines = samples.astype(">u2").reshape(h, w * c).view(np.uint8).reshape(h, -1)
    elif depth == 8:
        lines = samples.astype(np.uint8).reshape(h, w * c)
    else:
        bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
        lines = np.packbits(bits.reshape(h, w * depth), axis=1)
    bpp = max(1, c * depth // 8)
    raw, prev = b"", bytes(lines.shape[1])
    for y in range(h):
        cur = lines[y].tobytes()
        f = filters[y % len(filters)]
        raw += bytes([f]) + _filter_row(f, cur, prev, bpp)
        prev = cur
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                           interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def random_samples(rng, h, w, ctype, depth):
    top = 16 if ctype == 3 and depth == 8 else (1 << depth)
    return rng.integers(0, top, (h, w, CHANNELS[ctype]), dtype=np.int64)


def assert_reads_like_cv2(path):
    ref = cv2.imread(str(path))
    assert ref is not None
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ctype,depth", CASES, ids=[f"type{c}-{d}bit" for c, d in CASES])
def test_colour_types_and_depths(tmp_path, ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    palette = rng.integers(0, 256, (1 << min(depth, 4), 3)) if ctype == 3 else None
    for k, (h, w) in enumerate(((7, 13), (5, 1), (1, 1), (4, 33))):
        path = tmp_path / f"{k}.png"
        path.write_bytes(encode(random_samples(rng, h, w, ctype, depth), depth, ctype,
                                filters=(0, 1, 2, 3, 4), palette=palette))
        assert_reads_like_cv2(path)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_each_row_filter(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    for ctype, depth in ((2, 8), (6, 16), (0, 2), (4, 8)):
        path = tmp_path / f"{ctype}-{depth}.png"
        path.write_bytes(encode(random_samples(rng, 9, 17, ctype, depth), depth, ctype, (ftype,)))
        assert_reads_like_cv2(path)


def test_transparency_chunk_is_dropped(tmp_path):
    rng = np.random.default_rng(3)
    palette = rng.integers(0, 256, (16, 3))
    for name, ctype, trns in (("pal", 3, bytes(range(0, 160, 10))), ("grey", 0, b"\x00\x07"),
                              ("rgb", 2, b"\x00\x01\x00\x02\x00\x03")):
        depth = 4 if ctype == 3 else 8
        path = tmp_path / f"{name}.png"
        samples = random_samples(rng, 6, 11, ctype, depth)
        path.write_bytes(encode(samples, depth, ctype, (0, 4), palette if ctype == 3 else None,
                                trns=trns))
        assert_reads_like_cv2(path)


def test_files_written_by_cv2_and_by_imwrite_png(tmp_path):
    """cv2's encoder picks its own filters (smooth images make it use all of
    them); the port's writer uses filter 0.  Both read back as cv2 reads."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:61, 0:97]
    smooth = np.stack([(xx * 2 + yy) % 256, (yy * 3) % 256, (xx * yy) % 256], -1).astype(np.uint8)
    images = {"smooth": smooth, "noise": rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
              "odd": rng.integers(0, 256, (3, 5, 3), dtype=np.uint8),
              "one": rng.integers(0, 256, (1, 1, 3), dtype=np.uint8)}
    for name, im in images.items():
        cv2.imwrite(str(tmp_path / f"cv2_{name}.png"), im)
        cv2.imwrite(str(tmp_path / f"cv2_{name}_grey.png"), im[..., 0])
        cv2.imwrite(str(tmp_path / f"cv2_{name}_16.png"), im.astype(np.uint16) * 257 + 3)
        cv2.imwrite(str(tmp_path / f"cv2_{name}_bgra.png"), np.dstack([im, im[..., :1]]))
        imwrite_png(tmp_path / f"port_{name}.png", im)
        imwrite_png(tmp_path / f"port_{name}_grey.png", im[..., 0], level=1)
        np.testing.assert_array_equal(imread(tmp_path / f"port_{name}.png"), im)
    for path in sorted(tmp_path.iterdir()):
        assert_reads_like_cv2(path)


def test_unsupported_inputs_raise_naming_the_file(tmp_path):
    rng = np.random.default_rng(9)
    im = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    interlaced = tmp_path / "adam7.png"
    interlaced.write_bytes(encode(im.astype(np.int64), 8, 2, (0,), interlace=1))
    with pytest.raises(ValueError, match="adam7.png.*Adam7"):
        imread(interlaced)
    jpeg = tmp_path / "image.jpg"  # JPEG is decoded since the port's JPEG decoder
    assert cv2.imwrite(str(jpeg), im)
    np.testing.assert_array_equal(imread(jpeg), cv2.imread(str(jpeg)))
    for ext, fmt in ((".webp", "WebP"), (".tif", "TIFF"), (".bmp", "BMP")):
        path = tmp_path / f"image{ext}"
        assert cv2.imwrite(str(path), im)
        with pytest.raises(ValueError, match=f"image{ext}.*{fmt}"):
            imread(path)
    truncated = tmp_path / "cut.png"
    truncated.write_bytes(encode_png(im)[:-20])
    with pytest.raises(ValueError, match="cut.png"):
        imread(truncated)
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "missing.png")
