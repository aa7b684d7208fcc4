"""Host counterparts of the OpenCV calls of the task paths, in numpy.

The JAX package calls OpenCV for these; the card machine has none.  Each
function reproduces OpenCV 5.0.0's result on the inputs the task paths
give it (``tests/test_torch_task_ops.py`` holds them against ``cv2``):

- :func:`fill_poly`: ``cv2.fillPoly(mask, [pts], value)`` with int32
  points, shift 0 and LINE_8 (the segment ground-truth masks).  OpenCV draws
  every edge with its 8-connected line first, then fills the scanlines
  between the sorted edge crossings (16-bit fixed point), so a scanline
  fill alone would miss boundary pixels; an edge with an end outside the
  mask takes the x of its clipped line (the part off a side runs along the
  border column) and, where the clipped line is not flat, its rows;
- :func:`min_area_rect`: ``cv2.minAreaRect`` of float32 points (the OBB
  ground truth), bit for bit: 5.0.0's Sklansky hull in OpenCV's order, whose
  float convexity test normalises each difference vector to float32 first
  (so nearly collinear points drop out as OpenCV drops them), its rotating
  calipers, which pick the least-turning edge by float32 cross products,
  and its angle, -atan2(u.x, u.y) of the rectangle's first side u;
- :func:`resize_linear_f32`: ``cv2.resize(..., INTER_LINEAR)`` of a
  float32 map (the segment predictor's masks), which OpenCV 5.0.0's wheel
  runs through IPP: the fraction in float64 rounded to float32, and each
  pass ``fma(S1 - S0, f, S0)`` in float32;
- :func:`resize_nearest`: ``cv2.resize(..., INTER_NEAREST)`` (the
  segment validator's predicted masks at the ground truth's size);
- :func:`find_contours_external` and :func:`contour_area`:
  ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` and
  ``cv2.contourArea`` (``Masks.xy``): the image padded with one zero pixel,
  Suzuki's border following of the outer borders in raster order with
  OpenCV's marks (so a border inside a one-pixel-wide ring is found as
  OpenCV finds it), the contours in reverse order of discovery.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16  # OpenCV's fixed point of polygon edges
XY_ONE = 1 << XY_SHIFT


# ---------------------------------------------------------------------------
# fillPoly


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine``: (x1, y1, x2, y2, inside); like OpenCV's, the
    points are moved even when the segment turns out to miss the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """OpenCV's 8-connected ``Line`` (its ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        x1, y1, x2, y2, inside = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    n = dx + 1
    # one step: always along the major axis, along the minor one where err < 0
    minor = np.zeros(n, np.int64)
    for i in range(1, n):
        if err < 0:
            err += 2 * dx - 2 * dy
            minor[i] = 1
        else:
            err -= 2 * dy
    major = np.arange(n)
    minor = np.cumsum(minor)
    if vert:
        xs, ys = x1 + sx * minor, y1 + sy * major
    else:
        xs, ys = x1 + sx * major, y1 + sy * minor
    img[ys, xs] = value


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], value)`` in place: int points (P, 2),
    shift 0, LINE_8; returns ``img``."""
    pts = np.asarray(pts).reshape(-1, 2).astype(np.int64)
    h, w = img.shape[:2]
    edges = []
    x0, y0 = int(pts[-1, 0]) << XY_SHIFT, int(pts[-1, 1])
    for px, py in pts.tolist():
        x1, y1 = px << XY_SHIFT, py
        t0x, t1x = (x0 + (XY_ONE >> 1)) >> XY_SHIFT, (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        t0y, t1y = y0, y1
        _line8(img, t0x, t0y, t1x, t1y, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= t0y < h and 0 <= t1y < h):
            t0x, t0y, t1x, t1y, _ = _clip_line(w, h, t0x, t0y, t1x, t1y)
            if t0y != t1y:
                c0y, c1y = t0y, t1y
            c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT  # an edge off the side runs along it
        if y0 != y1:
            # C's truncating division of the fixed-point slope
            num, den = c1x - c0x, c1y - c0y
            dxe = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)
            if y0 < y1:
                edges.append((y0, y1, c0x + (y0 - c0y) * dxe, dxe))
            else:
                edges.append((y1, y0, c1x + (y1 - c1y) * dxe, dxe))
        x0, y0 = x1, y1
    if len(edges) < 2:
        return img
    e = np.asarray(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    xend = ex + (ey1 - ey0) * edx
    if (ey1.max() < 0 or ey0.min() >= h or max(ex.max(), xend.max()) < 0
            or min(ex.min(), xend.min()) >= (w << XY_SHIFT)):
        return img
    for y in range(max(int(ey0.min()), 0), min(int(ey1.max()), h)):
        act = (ey0 <= y) & (y < ey1)
        xs = np.sort(ex[act] + (y - ey0[act]) * edx[act])
        for a, b in zip(xs[0::2], xs[1::2]):
            x1, x2 = (int(a) + XY_ONE - 1) >> XY_SHIFT, int(b) >> XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
    return img


# ---------------------------------------------------------------------------
# minAreaRect


def _sign(v: float) -> int:
    return int(v > 0) - int(v < 0)


def _unit(x, y):
    """5.0.0's float Sklansky step normalises each difference vector: its
    float64 length, 1 / length (0 for a zero vector), the products rounded
    back to float32."""
    x, y = float(x), float(y)
    length = math.sqrt(y * y + (x * x + 0.0))
    inv = 1.0 / length if length != 0 else 0.0
    return float(np.float32(x * inv)), float(np.float32(inv * y))


def _sklansky(pts, order, start: int, end: int, nsign: int, sign2: int) -> list[int]:
    """OpenCV's ``Sklansky_``: one monotone chain over ``order[start..end]``
    (positions in the x-sorted order); float32 differences, each normalised
    (``_unit``) before the float64 cross product, so that points within a
    float32 rounding of a line count as on it."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or tuple(pts[order[start]]) == tuple(pts[order[end]]):
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[order[pcur]][1], pts[order[pnext]][1]
        by = np.float32(nexty - cury)
        if _sign(by) != nsign:
            ax, ay = _unit(pts[order[pcur]][0] - pts[order[pprev]][0],
                           cury - pts[order[pprev]][1])
            bx, by = _unit(pts[order[pnext]][0] - pts[order[pcur]][0], by)
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def _hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points, clockwise=False)``: Sklansky's scan of the
    x-sorted points and OpenCV's cyclic shift of the hull's point indices
    into an ascending or descending run where one exists."""
    pts = points.astype(np.float32)
    total = len(pts)
    if total < 2:
        return pts.copy()
    order = sorted(range(total), key=lambda i: (pts[i][0], pts[i][1]))
    miny = maxy = 0
    for i in range(1, total):
        y = pts[order[i]][1]
        if pts[order[miny]][1] > y:
            miny = i
        if pts[order[maxy]][1] < y:
            maxy = i
    if tuple(pts[order[0]]) == tuple(pts[order[-1]]):
        return pts[order[:1]].copy()
    tl = _sklansky(pts, order, 0, maxy, -1, 1)
    tr = _sklansky(pts, order, total - 1, maxy, -1, -1)
    tl, tr = tr, tl  # counter-clockwise
    out = [order[i] for i in tl[:-1]] + [order[i] for i in tr[:0:-1]]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(pts, order, 0, miny, 1, -1)
    br = _sklansky(pts, order, total - 1, miny, 1, 1)
    if stop >= 0:
        check = (bl[1] if len(bl) > 2 else br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0 and tuple(pts[order[check]]) == tuple(pts[order[stop]])):
            bl, br = bl[:2], br[:2]  # all points on one line
    out += [order[i] for i in bl[:-1]] + [order[i] for i in br[:0:-1]]
    n = len(out)
    if n >= 3:  # the cyclic shift into an ascending or descending run
        lo = hi = lt = 0
        for i in range(1, n):
            lt += out[i - 1] < out[i]
            if 1 < lt <= i - 2:
                break
            if out[i] < out[lo]:
                lo = i
            if out[i] > out[hi]:
                hi = i
        if abs(hi - lo) in (1, n - 1) and (lt <= 1 or lt >= n - 2):
            ascending = (hi + 1) % n == lo
            i0 = lo if ascending else hi
            if i0 > 0:
                shifted = out[i0:] + out[:i0]
                if all((shifted[i] < shifted[i + 1]) == ascending for i in range(n - 1)):
                    out = shifted
    return pts[out]


def _calipers(p: np.ndarray):
    """5.0.0's ``rotatingCalipers(CALIPERS_MINAREARECT)`` in float32 over the
    counter-clockwise hull: (corner, side 1, side 2).  Each step takes, of
    the four calipers' next edges turned onto the first one (rotated by 0,
    90, 180 and 270 degrees), the one that turns least, by float32 cross
    products in that order; the base is that edge's unit vector."""
    f = np.float32
    n = len(p)
    vect = np.roll(p, -1, axis=0) - p
    inv_len = [f(1.0 / math.sqrt(float(dy) * float(dy) + float(dx) * float(dx)))
               for dx, dy in vect]
    left = right = top = bottom = 0
    left_x = right_x = p[0, 0]
    top_y = bottom_y = p[0, 1]
    for i in range(n):
        if p[i, 0] < left_x:
            left_x, left = p[i, 0], i
        if p[i, 0] > right_x:
            right_x, right = p[i, 0], i
        if p[i, 1] > top_y:
            top_y, top = p[i, 1], i
        if p[i, 1] < bottom_y:
            bottom_y, bottom = p[i, 1], i
    seq = [bottom, right, top, left]
    minarea = f(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[i] for i in seq]
        turned = [(v[0][0], v[0][1]), (v[1][1], -v[1][0]), (-v[2][0], -v[2][1]),
                  (-v[3][1], v[3][0])]
        main = 1 if (-v[1][0]) * v[0][0] - v[1][1] * v[0][1] < 0 else 0
        cx, cy = turned[main]
        if (-v[2][1]) * cx + v[2][0] * cy < 0:
            main, (cx, cy) = 2, turned[2]
        if cx * v[3][0] + cy * v[3][1] < 0:
            main = 3
        pi = seq[main]
        lx, ly = vect[pi, 0] * inv_len[pi], inv_len[pi] * vect[pi, 1]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        dx = p[seq[1], 0] - p[seq[3], 0]
        dy = p[seq[1], 1] - p[seq[3], 1]
        width = dx * base_a + dy * base_b
        dx = p[seq[2], 0] - p[seq[0], 0]
        dy = p[seq[2], 1] - p[seq[0], 1]
        height = dy * base_a - dx * base_b
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i0, a1, width, b1, height, i5 = best
    a2, b2 = -b1, a1
    c1 = a1 * p[i0, 0] + p[i0, 1] * b1
    c2 = a2 * p[i5, 0] + p[i5, 1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height)


def _length(x, y) -> np.float32:
    return np.float32(math.sqrt(float(x) * float(x) + float(y) * float(y)))


def _degrees(y, x, scale: float) -> float:
    return float(np.float32(math.atan2(float(y), float(x)) * scale / math.pi))


def min_area_rect(points) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``cv2.minAreaRect`` of (P, 2) points: ((cx, cy), (w, h), angle in
    degrees), as 5.0.0 computes it: the angle is -atan2(u.x, u.y) of the
    first side u, in degrees, and the sizes are (|v|, |u|) of the sides u, v
    (-90 degrees and (|u|, |v|) where u points straight down the y axis);
    two points give a rectangle of width or height 0."""
    hull = _hull(np.asarray(points, np.float32).reshape(-1, 2))
    f = np.float32
    n = len(hull)
    if n > 2:
        (px, py), (ux, uy), (vx, vy) = _calipers(hull)
        center = (px + (ux + vx) * f(0.5), py + (uy + vy) * f(0.5))
        w, h = _length(ux, uy), _length(vx, vy)
        if ux == 0 and uy > 0:
            size, angle = (w, h), -90.0
        else:
            size, angle = (h, w), _degrees(ux, uy, -180.0)
    elif n == 2:
        (x0, y0), (x1, y1) = hull
        center = ((x0 + x1) * f(0.5), (y0 + y1) * f(0.5))
        dx, dy = x0 - x1, y0 - y1
        d = _length(dx, dy)
        size, angle = (f(0), d), -90.0
        if dx == 0:
            size = (d, f(0))
        elif dy < 0:
            size, angle = (d, f(0)), _degrees(dy, dx, 180.0)
        elif dy > 0:
            angle = _degrees(dx, dy, -180.0)
    else:
        center = tuple(hull[0]) if n else (f(0), f(0))
        size, angle = (f(0), f(0)), -90.0
    return ((float(center[0]), float(center[1])), (float(size[0]), float(size[1])),
            angle)


# ---------------------------------------------------------------------------
# resize


def _linear_taps(src: int, dst: int):
    """The float INTER_LINEAR taps of OpenCV's IPP path: (index0, index1,
    fraction), the fraction computed in float64 and rounded to float32."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= src - 1
    f[high], s[high] = 0, src - 1
    return s, np.minimum(s + 1, src - 1), f.astype(np.float32)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``fma(b - a, t, a)``: the difference rounded, then one rounding
    of the exact product-sum."""
    return ((b - a).astype(np.float64) * t.astype(np.float64) + a).astype(np.float32)


def resize_linear_f32(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)`` of a
    float32 (H, W) map of at least 2 x 2 pixels (OpenCV takes its IPP path
    there; a one-pixel-wide source goes another way)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    if (h, w) == (height, width):
        return img.copy()
    if h < 2 or w < 2:
        raise ValueError(f"resize_linear_f32 needs a source of at least 2 x 2, got {h} x {w}")
    x0, x1, fx = _linear_taps(w, width)
    y0, y1, fy = _linear_taps(h, height)
    rows = _lerp(img[:, x0], img[:, x1], fx[None])
    return _lerp(rows[y0], rows[y1], fy[:, None])


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``."""
    h, w = img.shape[:2]
    # OpenCV's step is the reciprocal of dst / src, in float64
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]


# ---------------------------------------------------------------------------
# findContours (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) and contourArea

_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))  # (dx, dy)
_NBD = 2
_RIGHT = 2 | -128  # OpenCV's mark of a border pixel with background on its right


def _follow(img: np.ndarray, y: int, x: int) -> list[tuple[int, int]]:
    """Trace the outer border from (y, x) (OpenCV's ``icvFetchContour``,
    CHAIN_APPROX_SIMPLE), marking it in ``img``; points (x, y) in the
    padded frame."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        dx, dy = _DELTAS[s]
        if img[y + dy, x + dx] != 0 or s == s_end:
            break
    if s == s_end and img[y + _DELTAS[s][1], x + _DELTAS[s][0]] == 0:
        img[y, x] = _RIGHT
        return [(x, y)]
    i1 = (y + _DELTAS[s][1], x + _DELTAS[s][0])
    i0 = (y, x)
    i3 = i0
    prev_s = s ^ 4
    pts = []
    px, py = x, y
    while True:
        s_end = s
        while s < 15:
            s += 1
            dx, dy = _DELTAS[s & 7]
            i4 = (i3[0] + dy, i3[1] + dx)
            if img[i4] != 0:
                break
        s &= 7
        if (s - 1) % (1 << 32) < s_end:
            img[i3] = _RIGHT
        elif img[i3] == 1:
            img[i3] = _NBD
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px += _DELTAS[s][0]
        py += _DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return pts


def find_contours_external(mask: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``:
    (K, 1, 2) int32 contours of the nonzero pixels."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int16)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        if not row.any():
            continue
        x = 1
        prev = 0
        lnbd = 0
        while x < w + 2:
            change = np.flatnonzero(row[x:] != prev)
            if not change.size:
                break
            x += int(change[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:
                found.append(_follow(img, y, x))
                prev = int(row[x])  # the start pixel, now marked, is not a last border
            else:
                prev = p
                if prev & -2:
                    lnbd = x
            x += 1
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) - 1 for c in found[::-1]]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea``: |shoelace| / 2 of float32 points, summed in float64."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float32).astype(np.float64)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, axis=0)
    a = 0.0
    for (x0, y0), (x1, y1) in zip(q.tolist(), p.tolist()):
        a += x0 * y1 - y0 * x1
    return abs(a * 0.5)
