"""The cv2 drawing and filter calls of the synthetic generator, without cv2.

Each function equals cv2 5.0.0's result exactly, by doing the same integer
and floating-point operations in the same order:

  ellipse2poly       cv2.ellipse2Poly (its sine table holds sin of whole
                     degrees rounded to 7 decimals, then to f32)
  fill_convex_poly   cv2.fillConvexPoly(pts, shift=16, LINE_8): the outline
                     drawn with cv2's fixed-point line (Line2), then a
                     scanline fill
  fill_ellipse       cv2.ellipse(img, c, axes, angle, 0, 360, color, -1)
  fill_poly          cv2.fillPoly(img, rings, color, LINE_8, shift=0):
                     every edge drawn with cv2's integer line, then the
                     even-odd scanline fill of all rings together
  gaussian_blur3     cv2.GaussianBlur(uint8, (3, 3), 0)
  dilate3            cv2.dilate(uint8, ones((3, 3)))
  resize_cubic_f32   cv2.resize(f32, (w, h), interpolation=INTER_CUBIC)

Points are fixed-point integers with 16 fractional bits, as cv2 keeps them.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# sin of 0..450 whole degrees as cv2's drawing code tabulates them (the
# values were read back through cv2.ellipse2Poly with axes of 2^30)
SIN_TABLE = [float(v) for v in
             np.float32(np.round(np.sin(np.deg2rad(np.arange(451))), 7))]


def _cv_round(v: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(round(v))


def ellipse2poly_f64(center: tuple[float, float], axes: tuple[float, float],
                     angle: int, arc_start: int, arc_end: int,
                     delta: int) -> list[tuple[float, float]]:
    """The double-precision points of cv2's ellipse2Poly(Point2d, Size2d)."""
    if not 0 < delta <= 180:
        raise ValueError("delta must lie in (0, 180]")
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha = SIN_TABLE[450 - angle]            # cos
    beta = SIN_TABLE[angle]                   # sin
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * SIN_TABLE[450 - a]
        y = axes[1] * SIN_TABLE[a]
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(map(float, center))] * 2
    return pts


def _dedupe(pts: list[tuple[int, int]], center) -> list[tuple[int, int]]:
    out = []
    for p in pts:
        if not out or p != out[-1]:
            out.append(p)
    if len(out) == 1:
        out = [tuple(center)] * 2
    return out


def ellipse2poly(center: tuple[int, int], axes: tuple[int, int], angle: int,
                 arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """cv2.ellipse2Poly: [n, 2] int32 points, consecutive repeats dropped."""
    pts = ellipse2poly_f64((float(center[0]), float(center[1])),
                           (float(axes[0]), float(axes[1])), int(angle),
                           int(arc_start), int(arc_end), int(delta))
    out = _dedupe([(_cv_round(x), _cv_round(y)) for x, y in pts],
                  (int(center[0]), int(center[1])))
    return np.asarray(out, np.int32).reshape(-1, 2)


def _clip_line(w: int, h: int, p1: list[int], p2: list[int]) -> bool:
    """cv2's clipLine on int64 points against a w x h box (in place)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(img: np.ndarray, pt1, pt2, color) -> None:
    """cv2's Line2, the outline of fillConvexPoly: an 8-connected line
    between two XY_SHIFT fixed-point points, clipped to the image in fixed
    point, walked along its major axis from the lower end in whole pixels
    with a truncated fixed-point slope, plus the rounded end point.  (cv2.line
    with a shift draws a different line: the rounded ends, Bresenham.)"""
    h, w = img.shape[:2]
    p1, p2 = list(pt1), list(pt2)
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    half = XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            p1, p2, dy = p2, p1, -dy
        y_step = _tdiv(dy << XY_SHIFT, abs(dx) | 1)
        k = np.arange(((p2[0] - p1[0]) >> XY_SHIFT) + 1, dtype=np.int64)
        xs = ((p1[0] + half) >> XY_SHIFT) + k
        ys = (p1[1] + half + k * y_step) >> XY_SHIFT
    else:
        if dy < 0:
            p1, p2, dx = p2, p1, -dx
        x_step = _tdiv(dx << XY_SHIFT, abs(dy) | 1)
        k = np.arange(((p2[1] - p1[1]) >> XY_SHIFT) + 1, dtype=np.int64)
        xs = (p1[0] + half + k * x_step) >> XY_SHIFT
        ys = ((p1[1] + half) >> XY_SHIFT) + k
    xs = np.append(xs, (p2[0] + half) >> XY_SHIFT)
    ys = np.append(ys, (p2[1] + half) >> XY_SHIFT)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = XY_SHIFT) -> None:
    """cv2.fillConvexPoly(img, pts, color, LINE_8, shift) in place, for
    0 < shift <= 16 (points with `shift` fractional bits): the outline,
    then from the top vertex down, the span between the two edges walked
    in fixed point, each end rounded."""
    if not 0 < shift <= XY_SHIFT:
        raise NotImplementedError("fill_convex_poly draws 0 < shift <= 16 only")
    v = [(int(x), int(y)) for x, y in np.asarray(pts, np.int64).reshape(-1, 2)]
    n = len(v)
    h, w = img.shape[:2]
    up = XY_SHIFT - shift
    delta = 1 << shift >> 1
    half = XY_ONE >> 1                 # LINE_8 rounds both span ends
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= n:
                    idx -= n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + half) >> XY_SHIFT
            xx2 = (edge[right]["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _line(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int], color) -> None:
    """cv2's Line(img, p1, p2, color, 8): clipped to the image, then
    LineIterator's 8-connected walk from the left end along the major axis,
    stepping the minor axis while the error term is negative."""
    h, w = img.shape[:2]
    a, b = list(p1), list(p2)
    if not (0 <= a[0] < w and 0 <= b[0] < w and 0 <= a[1] < h and 0 <= b[1] < h):
        if not _clip_line(w, h, a, b):
            return
    dx, dy = b[0] - a[0], b[1] - a[1]
    if dx < 0:                                  # leftToRight
        a, b, dx, dy = b, a, -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1)
    # err_k = major - 2 minor (k + 1) + 2 major (number of minor steps so far);
    # a minor step is taken where the error before it is negative
    steps = np.zeros(major + 1, np.int64)
    err, m = major - 2 * minor, 0
    for i in range(1, major + 1):
        if err < 0:
            err += 2 * major
            m += 1
        err -= 2 * minor
        steps[i] = m
    if vert:
        xs, ys = a[0] + steps, a[1] + sy * k
    else:
        xs, ys = a[0] + k, a[1] + sy * steps
    img[ys, xs] = color


def fill_poly(img: np.ndarray, rings, color) -> None:
    """cv2.fillPoly(img, rings, color) in place, LINE_8 with shift 0: each
    ring an [n, 2] array of integer (x, y) points.  As drawing.cpp's
    CollectPolyEdges and FillEdgeCollection: every edge, horizontal ones too,
    drawn with `_line`; each non-horizontal edge kept in 16-bit fixed point
    (its x at the upper row, its truncated slope dx, rows [y0, y1); an edge
    that leaves the image runs between its clipped ends); then per row the
    active edges, merged with the edges starting there (a new edge goes
    before active edges of equal x), are filled pair by pair from ceil(x) to
    floor(x) of the next, each edge stepping by dx when its pair is drawn,
    and re-sorted by x, stably.  Equal to cv2 on every polygon whose
    vertices lie inside the image; where an edge leaves it, cv2 5.0 can fill
    a column more at the border (see the ROADMAP)."""
    h, w = img.shape[:2]
    edges = []
    for ring in rings:
        v = [(int(x), int(y)) for x, y in np.asarray(ring, np.int64).reshape(-1, 2)]
        x0, y0 = v[-1][0] << XY_SHIFT, v[-1][1]
        for px, py in v:
            x1, y1 = px << XY_SHIFT, py
            t0 = [(x0 + (XY_ONE >> 1)) >> XY_SHIFT, y0]
            t1 = [(x1 + (XY_ONE >> 1)) >> XY_SHIFT, y1]
            _line(img, tuple(t0), tuple(t1), color)
            c0, c1 = [x0, y0], [x1, y1]
            if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
                _clip_line(w, h, t0, t1)
                if t0[1] != t1[1]:
                    c0 = [t0[0] << XY_SHIFT, t0[1]]
                    c1 = [t1[0] << XY_SHIFT, t1[1]]
            if y0 != y1:
                dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
                if y0 < y1:
                    edges.append([y0, y1, c0[0] + (y0 - c0[1]) * dx, dx])
                else:
                    edges.append([y1, y0, c1[0] + (y1 - c1[1]) * dx, dx])
            x0, y0 = x1, y1
    if len(edges) < 2:
        return
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min, y_max = min(e[0] for e in edges), max(e[1] for e in edges)
    x_min = min(min(e[2] for e in edges), min(ends))
    x_max = max(max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    # an edge: [x, dx, y1]
    new = [[e[2], e[3], e[1], e[0]] for e in edges]
    ni, active = 0, []
    for y in range(new[0][3], min(y_max, h)):
        merged = []
        ai = 0
        while True:
            last = active[ai] if ai < len(active) else None
            e = new[ni] if ni < len(new) else None
            if last is not None and last[2] == y:
                ai += 1                                    # the edge ends here
                continue
            if last is not None and (e is None or e[3] > y or last[0] < e[0]):
                merged.append(last)
                ai += 1
            elif e is not None and e[3] == y:
                merged.append(e[:3])
                ni += 1
            else:
                break
        for a, b in zip(merged[0::2], merged[1::2]):
            if y >= 0:
                lo, hi = (b[0], a[0]) if a[0] > b[0] else (a[0], b[0])
                x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = color
            a[0] += a[1]
            b[0] += b[1]
        active = sorted(merged, key=lambda e: e[0])


def fill_ellipse(img: np.ndarray, center: tuple[int, int],
                 axes: tuple[int, int], angle: float, color) -> None:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, thickness=-1)
    in place (LINE_8, integer center and axes)."""
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    d = (max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT
    d = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    pts = ellipse2poly_f64((float(cx), float(cy)), (float(ax), float(ay)),
                           _cv_round(angle), 0, 360, d)
    v = _dedupe([(_cv_round(x), _cv_round(y)) for x, y in pts], (cx, cy))
    fill_convex_poly(img, v, color, XY_SHIFT)


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) for uint8 images: the kernel
    (1, 2, 1) along each axis in integers, (sum + 8) >> 4, with cv2's
    default border (reflect-101)."""
    a = img.astype(np.int32)
    p = np.pad(a, [(1, 1), (1, 1)] + [(0, 0)] * (a.ndim - 2), mode="reflect")
    v = p[:-2] + 2 * p[1:-1] + p[2:]
    s = v[:, :-2] + 2 * v[:, 1:-1] + v[:, 2:]
    return ((s + 8) >> 4).astype(np.uint8)


def dilate3(img: np.ndarray) -> np.ndarray:
    """cv2.dilate(img, np.ones((3, 3), np.uint8)): the maximum over each
    pixel's 3 x 3 neighbourhood; outside the image counts as nothing."""
    lo = np.iinfo(img.dtype).min
    p = np.pad(img, 1, mode="constant", constant_values=lo)
    h, w = img.shape
    return np.max([p[i:i + h, j:j + w] for i in range(3) for j in range(3)], axis=0)


def _cubic_taps(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    """Source indices [n_dst, 4] (clamped: the replicated border) and their
    f32 weights, as cv2's resize computes them for INTER_CUBIC: the source
    position (dx + 0.5) * (1 / (n_dst / n_src)) - 0.5 in f64 cast to f32, its
    floor, and interpolateCubic of the f32 fraction (A = -0.75)."""
    f32 = np.float32
    scale = 1.0 / (n_dst / n_src)
    fx = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx.astype(f32)).astype(f32)
    a, one = f32(-0.75), f32(1)
    xp, y = x + one, one - x
    c0 = ((a * xp - f32(5) * a) * xp + f32(8) * a) * xp - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * y - (a + f32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None], 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(f32)


def resize_cubic_f32(src: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(src, size=(w, h), interpolation=INTER_CUBIC) for f32
    [H, W] or [H, W, C]: rows first, each output (((t0 + t1) + t2) + t3) of
    products t_k = tap_k * weight_k; then columns, summed as the vectorised
    loop sums them, r0 * b0 + (r1 * b1 + (r2 * b2 + r3 * b3)) (the scalar
    loop's order for a row's last floats), all in f32.
    Equal to cv2's own code path, which cv2 takes for two channels; for one,
    three and four channels cv2 hands the call to Intel IPP when it is built
    with it, whose results differ from this in the last bits."""
    w_out, h_out = size
    s = np.asarray(src, np.float32)
    flat = s.ndim == 2
    if flat:
        s = s[..., None]
    ix, ax = _cubic_taps(s.shape[1], w_out)
    iy, ay = _cubic_taps(s.shape[0], h_out)
    t = [s[:, ix[:, k], :] * ax[None, :, k, None] for k in range(4)]
    row = ((t[0] + t[1]) + t[2]) + t[3]
    r = [(row[iy[:, k]] * ay[:, k, None, None]).reshape(h_out, -1) for k in range(4)]
    out = r[0] + (r[1] + (r[2] + r[3]))
    # the vectorised loop takes 4 floats at a time; a row's last
    # (w_out * C) % 4 floats are summed by the scalar loop, in order
    tail = out.shape[1] - out.shape[1] % 4
    out[:, tail:] = ((r[0][:, tail:] + r[1][:, tail:]) + r[2][:, tail:]) + r[3][:, tail:]
    out = out.reshape(h_out, w_out, -1)
    return out[..., 0] if flat else out
