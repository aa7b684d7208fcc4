"""The train pipeline's pixels, composed on the tensor's device.

Counterparts of the OpenCV calls of ``xlstm_yolo_tpu/data/augment.py``
that the train transforms make, as torch functions on uint8 tensors whose
bytes equal OpenCV 5.0.0's (the build whose float kernels run on AVX-512,
16 float lanes), on the CPU and on the GPU alike:

- :func:`warp_affine_u8` / :func:`warp_perspective_u8`: ``cv2.warpAffine``
  / ``cv2.warpPerspective`` with ``INTER_LINEAR`` and a constant border.
  OpenCV inverts the matrix in float64 (``invertAffineTransform``; the 3x3
  cofactor inverse), rounds it to float32, and maps each output pixel to a
  float32 source coordinate ``fma(x, m0, m1*y + m2)`` (perspective: each
  of x, y and w so, then x/w and y/w); the columns past a row's last whole
  vector of ``LANES`` take the scalar code's ``fma(x, m0, m1*y) + m2``.
  The coordinate splits into ``floor`` and a fraction; each of the four
  taps outside the image reads the border value; the taps blend as
  ``top = fma(p01 - p00, ax, p00)``, ``bottom`` likewise, ``fma(bottom -
  top, ay, top)``, rounded half to even and saturated.
- :func:`hsv_jitter_u8`: ``RandomHSV``: ``COLOR_BGR2HSV`` in OpenCV's 12-bit
  fixed point (its ``sdiv``/``hdiv`` tables), three 256-entry LUTs built
  on the host as JAX builds them (``augment.hsv_luts``), and ``COLOR_HSV2BGR``
  in float32 (sector, fraction, ``v * fma(-s, f, 1)``) truncated to uint8.
  Exact for images of a whole number of 16-pixel vectors, which every
  train image is (``imgsz`` is a multiple of 32); OpenCV's scalar tail of
  other sizes is not reproduced.
- :func:`mixup_u8`: ``(img * r + img2 * (1 - r)).astype(uint8)`` in float64.

A float32 fused multiply-add is computed through float64 (the product of
two float32 is exact there), then rounded once to float32.

:func:`compose_batch` builds a collated train batch from the loader's
per-sample recipes (``augment.TrainTransforms``) and decoded tiles: each
canvas (mosaic, or the letterboxed image) is pasted together on the
device, then one warp gathers the whole batch, the mixup partners with it,
then the copy-paste rectangles, one LUT gather, the flips and BGR -> RGB.
:func:`compose_classify` builds a classify train batch from
``augment.ClassifyAugment``'s recipes: each crop (cut by the loader's
worker, so only its bytes move) resized by :func:`augment.resize_linear_u8`, the flips,
one LUT gather for the HSV, the erased rectangles, BGR -> RGB.
"""

from __future__ import annotations

import numpy as np
import torch

from xlstm_yolo_tpu_torch.data.augment import resize_linear_u8

LANES = 16  # OpenCV's float32 vector width on AVX-512
HSV_SHIFT = 12
PAD = 114


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def invert_affine(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a 2x3 (or the top of a 3x3) matrix,
    as a 3x3 float64 matrix."""
    M = np.asarray(M, np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * D, M[0, 0] * D, -M[0, 1] * D, -M[1, 0] * D
    b1 = -a11 * M[0, 2] - a12 * M[1, 2]
    b2 = -a21 * M[0, 2] - a22 * M[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2], [0.0, 0.0, 1.0]])


def invert_perspective(M: np.ndarray) -> np.ndarray:
    """OpenCV's 3x3 float64 inverse (cofactors over the determinant)."""
    S = np.asarray(M, np.float64)
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    d = 1.0 / d if d != 0 else 0.0
    return np.array([
        [(S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
         (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d],
        [(S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d, (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d,
         (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d],
        [(S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
         (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d]])


def warp_batch_u8(src: torch.Tensor, inv: np.ndarray, dsize: tuple[int, int],
                  perspective: bool, border_value: int = PAD) -> torch.Tensor:
    """Warp each of ``src`` (B, H, W, 3) uint8 by its inverse matrix ``inv``
    (B, 3, 3) float64 to ``dsize`` (w, h): (B, h, w, 3) uint8."""
    B, H, W, _ = src.shape
    dw, dh = dsize
    dev = src.device
    m = torch.from_numpy(np.asarray(inv, np.float64).astype(np.float32)).to(dev)
    m = m.view(B, 3, 3, 1, 1)
    xs = torch.arange(dw, dtype=torch.float32, device=dev).view(1, 1, dw)
    ys = torch.arange(dh, dtype=torch.float32, device=dev).view(1, dh, 1)
    tail = torch.arange(dw, device=dev).view(1, 1, dw) >= dw - dw % LANES

    def row(k):
        main = _fma(xs, m[:, k, 0], m[:, k, 1] * ys + m[:, k, 2])
        scalar = _fma(xs, m[:, k, 0], m[:, k, 1] * ys) + m[:, k, 2]
        return torch.where(tail, scalar, main)

    sx, sy = row(0), row(1)
    if perspective:
        w = row(2)
        sx, sy = sx / w, sy / w
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - x0f)[..., None], (sy - y0f)[..., None]
    # coordinates far outside the image read the border; clamp before the cast
    x0 = x0f.clamp(-2, W + 1).long()
    y0 = y0f.clamp(-2, H + 1).long()
    flat = src.reshape(-1, 3)
    base = torch.arange(B, device=dev).view(B, 1, 1) * (H * W)
    fill = _f32(border_value, dev)

    def tap(yy, xx):
        ok = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[..., None]
        idx = base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.where(ok, flat[idx].float(), fill)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma(p01 - p00, ax, p00)
    bottom = _fma(p11 - p10, ax, p10)
    out = _fma(bottom - top, ay, top)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def warp_affine_u8(img: torch.Tensor, M, dsize: tuple[int, int],
                   border_value: int = PAD) -> torch.Tensor:
    """``cv2.warpAffine(img, M[:2], dsize, borderValue=(v, v, v))`` of a uint8
    (H, W, 3) tensor."""
    return warp_batch_u8(img[None], invert_affine(M)[None], dsize, False, border_value)[0]


def warp_perspective_u8(img: torch.Tensor, M, dsize: tuple[int, int],
                        border_value: int = PAD) -> torch.Tensor:
    """``cv2.warpPerspective(img, M, dsize, borderValue=(v, v, v))`` of a uint8
    (H, W, 3) tensor."""
    return warp_batch_u8(img[None], invert_perspective(M)[None], dsize, True, border_value)[0]


def _hsv_tables(device):
    i = torch.arange(256, dtype=torch.float64, device=device)
    one = i.clamp(min=1)
    sdiv = torch.where(i > 0, torch.round((255 << HSV_SHIFT) / one), 0)
    hdiv = torch.where(i > 0, torch.round((180 << HSV_SHIFT) / (6.0 * one)), 0)
    return sdiv.long(), hdiv.long()


def bgr_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` of uint8 (..., 3): H in [0, 180)."""
    sdiv, hdiv = _hsv_tables(img.device)
    b, g, r = img.long().unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def hsv_to_bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` of uint8 (..., 3), H in [0, 180)."""
    dev = hsv.device
    h, s, v = hsv.float().unbind(-1)
    inv255 = _f32(1.0 / 255.0, dev)
    s, v = s * inv255, v * inv255
    h = h * _f32(6.0 / 180.0, dev)
    sector = torch.floor(h)
    f = h - sector
    sector = sector.long()
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, 0, sector)
    f = torch.where(bad, _f32(0.0, dev), f)
    one = _f32(1.0, dev)
    tab = torch.stack([v, v * (one - s), v * _fma(-s, f, one), v * _fma(-s, one - f, one)], -1)
    pick = torch.tensor(_SECTORS, device=dev)[sector]
    out = torch.gather(tab, -1, pick)
    out = torch.where((s == 0)[..., None], v[..., None], out)
    return torch.trunc(out * _f32(255.0, dev)).clamp_(0, 255).to(torch.uint8)


def hsv_jitter_u8(img: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """``RandomHSV`` of BGR uint8 images (B, H, W, 3) with per-image LUTs
    (B, 3, 256) uint8 (``augment.hsv_luts``), one gather for the batch."""
    B = img.shape[0]
    hsv = bgr_to_hsv_u8(img).long()
    offs = (torch.arange(B, device=img.device) * 768).view(B, 1, 1, 1)
    offs = offs + torch.tensor([0, 256, 512], device=img.device)
    return hsv_to_bgr_u8(luts.to(img.device).reshape(-1)[hsv + offs])


def mixup_u8(img: torch.Tensor, img2: torch.Tensor, r: float) -> torch.Tensor:
    """``(img * r + img2 * (1 - r)).astype(np.uint8)``, float64."""
    return (img.double() * r + img2.double() * (1 - r)).to(torch.uint8)


def _canvas(spec: dict, tiles: list, device) -> torch.Tensor:
    """A mosaic or letterboxed canvas from its recipe: the 114-filled
    (h, w) canvas, each tile resized through its sizes and pasted, then the
    crop."""
    h, w = spec["size"]
    out = torch.full((h, w, 3), PAD, dtype=torch.uint8, device=device)
    for ti, sizes, (y1a, y2a, x1a, x2a), (y1b, y2b, x1b, x2b) in spec["tiles"]:
        im = tiles[ti]
        for tw, th in sizes:
            im = resize_linear_u8(im, tw, th)
        out[y1a:y2a, x1a:x2a] = im[y1b:y2b, x1b:x2b]
    if spec.get("crop") is not None:
        yc, xc, ch, cw = spec["crop"]
        out = out[yc:yc + ch, xc:xc + cw]
    return out


def _warped(parts: list[tuple[dict, dict]], tiles_of: list, device) -> list[torch.Tensor]:
    """Canvases and their warps: one gather per (output size, kind) over all
    of them; a canvas padded with the border value warps as the canvas."""
    canv = [_canvas(spec, tiles_of[j], device) for j, (spec, _) in enumerate(parts)]
    out: list = [None] * len(parts)
    groups: dict = {}
    for j, (_, warp) in enumerate(parts):
        key = (tuple(warp["dsize"]), warp["perspective"])
        groups.setdefault(key, []).append(j)
    for (dsize, persp), idx in groups.items():
        H = max(canv[j].shape[0] for j in idx)
        W = max(canv[j].shape[1] for j in idx)
        src = torch.full((len(idx), H, W, 3), PAD, dtype=torch.uint8, device=device)
        inv = []
        for k, j in enumerate(idx):
            c = canv[j]
            src[k, :c.shape[0], :c.shape[1]] = c
            M = parts[j][1]["M"]
            inv.append(np.eye(3) if M is None else
                       invert_perspective(M) if persp else invert_affine(M))
        res = warp_batch_u8(src, np.stack(inv), dsize, persp)
        for k, j in enumerate(idx):
            out[j] = res[k]
    return out


def compose_batch(recipes: list[dict], tiles: list[list[np.ndarray]],
                  device: str | torch.device) -> torch.Tensor:
    """The uint8 RGB (B, imgsz, imgsz, 3) pixels of a collated train batch
    on ``device``: the bytes JAX's ``TrainTransforms`` gives each sample."""
    dev = torch.device(device)
    tiles_t = [[torch.from_numpy(np.array(t, copy=True)).to(dev) for t in ts] for ts in tiles]
    parts, tiles_of, main_at, mix_at = [], [], [], {}
    for j, rc in enumerate(recipes):
        main_at.append(len(parts))
        parts.append((rc["canvas"], rc["warp"]))
        tiles_of.append(tiles_t[j])
        if rc.get("mixup") is not None:
            mix_at[j] = len(parts)
            parts.append((rc["mixup"]["canvas"], rc["mixup"]["warp"]))
            tiles_of.append(tiles_t[j])
    warped = _warped(parts, tiles_of, dev)
    imgs = []
    for j, rc in enumerate(recipes):
        img = warped[main_at[j]]
        if j in mix_at:
            img = mixup_u8(img, warped[mix_at[j]], rc["mixup"]["r"])
        if rc["paste"]:
            src = img
            img = img.clone()
            for y1, y2, x1, x2, nx1, nx2 in rc["paste"]:
                img[y1:y2, nx1:nx2] = src[y1:y2, x1:x2].flip(1)
        imgs.append(img)
    shapes = {tuple(im.shape) for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f"train images of different shapes in one batch: {sorted(shapes)}")
    x = _flip_where(_hsv_of(torch.stack(imgs), recipes), recipes)
    return x.flip(-1).contiguous()  # BGR -> RGB



def _flip_where(x: torch.Tensor, recipes: list[dict]) -> torch.Tensor:
    """The recipes' up-down, then left-right flips of the (B, H, W, 3) batch."""
    dev = x.device
    ud = torch.tensor([rc["flipud"] for rc in recipes], device=dev).view(-1, 1, 1, 1)
    lr = torch.tensor([rc["fliplr"] for rc in recipes], device=dev).view(-1, 1, 1, 1)
    x = torch.where(ud, x.flip(1), x)
    return torch.where(lr, x.flip(2), x)


def _hsv_of(x: torch.Tensor, recipes: list[dict]) -> torch.Tensor:
    """The recipes' HSV LUTs applied to the BGR batch (none drawn: as is)."""
    if all(rc["hsv"] is None for rc in recipes):
        return x
    ident = np.stack([np.arange(256, dtype=np.uint8)] * 3)
    luts = np.stack([ident if rc["hsv"] is None else rc["hsv"] for rc in recipes])
    return hsv_jitter_u8(x, torch.from_numpy(luts).to(x.device))


def compose_classify(recipes: list[dict], crops: list[np.ndarray],
                     device: str | torch.device) -> torch.Tensor:
    """The uint8 RGB (B, size, size, 3) pixels of a classify train batch on
    ``device`` from ``augment.ClassifyAugment``'s recipes and their BGR
    crops (cut from the decoded images by the recipes' ``crop``): the bytes
    JAX's ``ClassifyAugment`` gives each sample."""
    dev = torch.device(device)
    crops = [resize_linear_u8(torch.from_numpy(np.ascontiguousarray(c)).to(dev), rc["size"],
                              rc["size"]) for rc, c in zip(recipes, crops)]
    x = _hsv_of(_flip_where(torch.stack(crops), recipes), recipes)
    for j, rc in enumerate(recipes):
        if rc["erase"] is not None:
            top, left, eh, ew = rc["erase"]
            x[j, top:top + eh, left:left + ew] = 0
    return x.flip(-1).contiguous()  # BGR -> RGB
