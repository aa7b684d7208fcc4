"""The port's JPEG decoder returns ``cv2.imread``'s bytes.

Files written in the tests by OpenCV and PIL are read by ``cv2.imread``
(IMREAD_COLOR; OpenCV 5.0.0 with libjpeg-turbo 3.1.2, the version the
decoder follows) and by the port's ``data.imread.imread``; the arrays must be equal, byte
for byte (no tolerance): qualities 50/75/95/100 at 4:4:4, 4:2:2, 4:2:0,
4:1:1 and 4:4:0 sampling, progressive files, restart intervals, optimised
Huffman tables, grey, sizes 1x1 to 97x211, EXIF orientations 1-8, Adobe
RGB, truncated files (progressive ones block-smoothed), an MPO file and
files with corrupted entropy data.
CMYK and arithmetic-coded files raise a ValueError naming the file; data
``cv2.imread`` returns None for raises ``CorruptImageError``.  The
committed fixtures decode to their manifest's hashes, which are
``cv2.imread``'s.  A PNG's ``eXIf`` orientation is applied, as OpenCV
applies it.  A failed build of the host library raises."""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from xlstm_yolo_tpu_torch.data.imread import CorruptImageError, encode_png, imread
from xlstm_yolo_tpu_torch.ops import host_build

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 100 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 11)], -1)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def cv2_jpeg(img, *flags):
    ok, enc = cv2.imencode(".jpg", img, list(flags))
    assert ok
    return enc.tobytes()


def pil_jpeg(img, fmt="JPEG", **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(buf, fmt, **kw)
    return buf.getvalue()


def assert_reads_like_cv2(tmp_path, data, name="image.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    ref = cv2.imread(str(path))
    assert ref is not None
    got = imread(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_quality_and_sampling(tmp_path, quality, sampling):
    img = scene(97, 211, quality)
    assert_reads_like_cv2(tmp_path, cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (17, 33), (97, 211)])
@pytest.mark.parametrize("kind", ["420", "progressive", "restart", "optimized", "grey",
                                  "grey_progressive"])
def test_sizes_and_coding(tmp_path, hw, kind):
    img = scene(*hw, seed=hw[0])
    data = {
        "420": lambda: pil_jpeg(img, quality=90, subsampling=2),
        "progressive": lambda: pil_jpeg(img, quality=85, progressive=True, subsampling=2),
        "restart": lambda: cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                    cv2.IMWRITE_JPEG_PROGRESSIVE, int(hw[0] > 7)),
        "optimized": lambda: pil_jpeg(img, quality=70, optimize=True, subsampling=1),
        "grey": lambda: pil_jpeg(img[..., 1], quality=80),
        "grey_progressive": lambda: cv2_jpeg(img[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                             cv2.IMWRITE_JPEG_OPTIMIZE, 1),
    }[kind]()
    assert_reads_like_cv2(tmp_path, data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    exif[0x010F] = "a maker name longer than four bytes"
    assert_reads_like_cv2(tmp_path, pil_jpeg(scene(33, 50, 1), quality=90, exif=exif.tobytes()))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, orientation):
    """cv2.imread turns a PNG by its eXIf chunk, before or after IDAT."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    tiff = exif.tobytes()[6:]  # past "Exif\0\0": the chunk holds the TIFF header
    png = encode_png(scene(21, 34, 2))
    iend = png.rindex(b"IEND") - 4
    chunk = struct.pack(">I", len(tiff)) + b"eXIf" + tiff + struct.pack(
        ">I", zlib.crc32(b"eXIf" + tiff))
    after_ihdr = 8 + 25
    for data in (png[:after_ihdr] + chunk + png[after_ihdr:], png[:iend] + chunk + png[iend:]):
        assert_reads_like_cv2(tmp_path, data, "image.png")


def test_rgb_jpegs_and_mpo(tmp_path):
    """Three components taken as RGB (an Adobe APP14 marker with transform
    0 and no JFIF marker) or YCbCr (transform 1), and an MPO file, whose
    first frame counts."""
    img = scene(40, 57, 5)
    data = pil_jpeg(img, quality=90, subsampling=0)
    app0_end = 4 + struct.unpack(">H", data[4:6])[0]
    body = data[:2] + data[app0_end:]  # drop the JFIF APP0
    for transform in (0, 1):
        app14 = b"\xff\xee\x00\x0eAdobe" + bytes([0, 100, 0, 0, 0, 0, transform])
        assert_reads_like_cv2(tmp_path, body[:2] + app14 + body[2:])
    mpo = pil_jpeg(img, "MPO", save_all=True, append_images=[Image.fromarray(scene(9, 9, 1))])
    assert_reads_like_cv2(tmp_path, mpo, "image.mpo")


@pytest.mark.parametrize("fraction", [0.15, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "progressive_420", "grey_progressive"])
def test_truncated_file(tmp_path, fraction, kind):
    """libjpeg reads zero bits past the end and leaves later MCUs zero; a
    progressive file whose coefficients end incomplete has its blocks
    smoothed (libjpeg-turbo's 5x5 block smoothing)."""
    img = scene(97, 211, 7)
    data = {"baseline": lambda: pil_jpeg(img, quality=90),
            "progressive": lambda: pil_jpeg(img, quality=90, progressive=True, subsampling=0),
            "progressive_420": lambda: cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            "grey_progressive": lambda: pil_jpeg(img[..., 1], quality=70, progressive=True)}[kind]()
    assert_reads_like_cv2(tmp_path, data[: int(len(data) * fraction)])


def test_corrupt_entropy_data(tmp_path):
    """Bytes of the entropy-coded data overwritten at random: the same
    image as cv2.imread, or CorruptImageError where it returns None."""
    rng = np.random.default_rng(3)
    counts = {"equal": 0, "none": 0}
    for t in range(24):
        img = scene(31, 45, t)
        data = bytearray(pil_jpeg(img, quality=80, progressive=t % 3 == 0,
                                  subsampling=t % 3))
        sos = bytes(data).index(b"\xff\xda")
        for _ in range(3):
            data[int(rng.integers(sos + 14, len(data) - 2))] = int(rng.integers(0, 256))
        path = tmp_path / f"c{t}.jpg"
        path.write_bytes(bytes(data))
        ref = cv2.imread(str(path))
        if ref is None:
            with pytest.raises(CorruptImageError, match=f"c{t}.jpg"):
                imread(path)
            counts["none"] += 1
            continue
        np.testing.assert_array_equal(imread(path), ref)
        counts["equal"] += 1
    assert counts["equal"] >= 12, counts


def test_refusals_name_the_file(tmp_path):
    img = scene(20, 30, 1)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    (tmp_path / "cmyk.jpg").write_bytes(cmyk.getvalue())
    with pytest.raises(ValueError, match="cmyk.jpg.*4-component"):
        imread(tmp_path / "cmyk.jpg")
    arith = bytearray(pil_jpeg(img))
    arith[bytes(arith).index(b"\xff\xc0") + 1] = 0xC9  # SOF9
    (tmp_path / "arith.jpg").write_bytes(bytes(arith))
    with pytest.raises(ValueError, match="arith.jpg.*arithmetic"):
        imread(tmp_path / "arith.jpg")
    (tmp_path / "text.jpg").write_bytes(b"not an image at all")
    assert cv2.imread(str(tmp_path / "text.jpg")) is None
    with pytest.raises(CorruptImageError, match="text.jpg"):
        imread(tmp_path / "text.jpg")
    (tmp_path / "soi.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    assert cv2.imread(str(tmp_path / "soi.jpg")) is None
    with pytest.raises(CorruptImageError, match="soi.jpg"):
        imread(tmp_path / "soi.jpg")


def test_fixtures_match_the_manifest():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert len(manifest) >= 10
    for name, want in manifest.items():
        path = FIXTURES / name
        if "raises" in want:
            with pytest.raises(ValueError, match=want["raises"]):
                imread(path)
            continue
        got = imread(path)
        ref = cv2.imread(str(path))
        assert list(got.shape) == want["shape"] and hashlib.sha256(got.tobytes()).hexdigest() \
            == want["sha256"] == hashlib.sha256(ref.tobytes()).hexdigest(), name


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build, "CXX_FLAGS",
                        [*host_build.CXX_FLAGS, "-include", "no_such_header.h"])
    with pytest.raises(RuntimeError, match="jpeg_decode: g\\+\\+ failed"):
        host_build.build("jpeg_decode")
    assert not list(tmp_path.iterdir())
