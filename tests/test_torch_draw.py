"""The port's cv2-free drawing and filter ops (`kgtpu_torch/data/draw.py`)
against cv2 itself, which kgtpu's synthetic generator calls.

Tolerance: none.  Every comparison is exact: rasters, integer filters, and
the f32 cubic resize on the code path cv2 runs itself (two channels; one,
three and four channels with cv2's IPP dispatch switched off, since cv2
otherwise hands those to Intel IPP, whose f32 results differ in the last
bits: see `tests/test_torch_synthetic.py`).
"""

import cv2
import numpy as np
import pytest

from kgtpu_torch.data import draw


def test_sine_table_read_back_through_cv2():
    """Axes of 2^30 make cv2.ellipse2Poly print its table values exactly."""
    big = 1 << 30
    pts = cv2.ellipse2Poly((0, 0), (big, big), 0, 0, 360, 1).astype(np.float64)
    a = np.arange(361)
    assert np.array_equal(np.float32(pts[:, 1] / big), np.float32(draw.SIN_TABLE)[a])
    assert np.array_equal(np.float32(pts[:, 0] / big), np.float32(draw.SIN_TABLE)[450 - a])


@pytest.mark.parametrize("seed", range(3))
def test_ellipse2poly_matches_cv2(seed):
    """Arbitrary centers, axes, angles, arcs (reversed, negative, > 360)
    and steps: the same points, repeats dropped."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        c = tuple(int(v) for v in rng.integers(-50, 300, 2))
        a = tuple(int(v) for v in rng.integers(0, 200, 2))
        ang = int(rng.integers(-400, 400))
        s, e = (int(v) for v in rng.integers(-400, 400, 2))
        d = int(rng.integers(1, 181))
        want = cv2.ellipse2Poly(c, a, ang, s, e, d)
        got = draw.ellipse2poly(c, a, ang, s, e, d)
        assert got.shape == want.shape and np.array_equal(got, want), (c, a, ang, s, e, d)


def _convex_polygon(rng, size):
    """A random convex polygon in 16-bit fixed point: points on a jittered
    ellipse, in angle order."""
    n = int(rng.integers(3, 40))
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    c = rng.uniform(-0.2 * size, 1.2 * size, 2)
    r = rng.uniform(0.5, 0.6 * size, 2)
    pts = np.stack([c[0] + r[0] * np.cos(th), c[1] + r[1] * np.sin(th)], -1)
    return np.round(pts * 65536).astype(np.int64)


@pytest.mark.parametrize("kind", ["ellipse", "random"])
def test_fill_convex_poly_matches_cv2(kind):
    """cv2.fillConvexPoly(shift=16, LINE_8) on 400 polygons: the ellipse
    outlines cv2.ellipse fills, and random convex ones, many clipped by the
    canvas."""
    rng = np.random.default_rng(11 if kind == "ellipse" else 12)
    for t in range(400):
        h, w = 64, 69
        if kind == "ellipse":
            c = rng.uniform(-10, 74, 2) * 65536
            a = rng.uniform(0.5, 40, 2) * 65536
            pts = np.round(np.array(draw.ellipse2poly_f64(
                tuple(c), tuple(a), int(rng.integers(0, 360)), 0, 360,
                int(rng.choice([5, 18, 30, 90]))))).astype(np.int64)
        else:
            pts = _convex_polygon(rng, h)
        want = np.zeros((h, w), np.uint8)
        cv2.fillConvexPoly(want, pts.astype(np.int32), 1, cv2.LINE_8, 16)
        got = np.zeros((h, w), np.uint8)
        draw.fill_convex_poly(got, pts, 1, 16)
        assert np.array_equal(got, want), (kind, t)


@pytest.mark.parametrize("case", ["small_axes", "half_angles", "clipped", "mixed"])
def test_fill_ellipse_matches_cv2(case):
    """cv2.ellipse(img, c, axes, angle, 0, 360, 1, -1) on 150 ellipses per
    case (600 in all): axes 0-3, angles at x.5 (cv2 rounds them half to
    even), centers on and outside the canvas' edges, and a mix."""
    rng = np.random.default_rng({"small_axes": 1, "half_angles": 2, "clipped": 3,
                                 "mixed": 4}[case])
    h, w = 96, 103
    for t in range(150):
        c = tuple(int(v) for v in rng.integers(0, 96, 2))
        a = tuple(int(v) for v in rng.integers(1, 60, 2))
        ang = float(rng.uniform(0, 360))
        if case == "small_axes":
            a = tuple(int(v) for v in rng.integers(0, 4, 2))
        elif case == "half_angles":
            ang = float(rng.integers(0, 360)) + 0.5
        elif case == "clipped":
            c = (int(rng.choice([-8, -1, 0, 1, w - 2, w - 1, w, w + 6])),
                 int(rng.integers(-10, h + 10)))
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, c, a, ang, 0, 360, 1, -1)
        got = np.zeros((h, w), np.uint8)
        draw.fill_ellipse(got, c, a, ang, 1)
        assert np.array_equal(got, want), (case, t, c, a, ang)


def test_fill_ellipse_keeps_what_is_drawn_and_colours():
    """Filling writes the colour over the raster and leaves the rest."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 9, (40, 50)).astype(np.int32)
    want, got = base.copy(), base.copy()
    cv2.ellipse(want, (20, 18), (15, 7), 33.0, 0, 360, 77, -1)
    draw.fill_ellipse(got, (20, 18), (15, 7), 33.0, 77)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 80, 3), (7, 5, 3), (33, 17), (1, 5, 3), (2, 2)])
def test_gaussian_blur3_matches_cv2(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(draw.gaussian_blur3(img), cv2.GaussianBlur(img, (3, 3), 0))


@pytest.mark.parametrize("shape", [(64, 80), (5, 7), (1, 9)])
def test_dilate3_matches_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    img = ((rng.uniform(size=shape) < 0.1) * rng.integers(1, 256, shape)).astype(np.uint8)
    assert np.array_equal(draw.dilate3(img), cv2.dilate(img, np.ones((3, 3), np.uint8)))


@pytest.mark.parametrize("src,size", [((17, 17, 2), (512, 512)), ((9, 9, 2), (96, 96)),
                                      ((5, 7, 2), (64, 40)), ((6, 9, 2), (13, 9)),
                                      ((4, 4, 2), (128, 128))])
def test_resize_cubic_matches_cv2_two_channels(src, size):
    """The elastic field's upsample (two channels): exact, IPP or not, also
    where a row's float count is not a multiple of 4 (the scalar tail)."""
    field = np.random.default_rng(sum(src)).uniform(-1, 1, src).astype(np.float32)
    want = cv2.resize(field, size, interpolation=cv2.INTER_CUBIC)
    assert np.array_equal(draw.resize_cubic_f32(field, size), want)


@pytest.mark.parametrize("src,size", [((8, 8), (512, 512)), ((8, 8), (96, 96)),
                                      ((6, 9), (50, 70)), ((6, 9), (45, 7)),
                                      ((8, 8, 3), (64, 64)), ((5, 6, 4), (33, 20))])
def test_resize_cubic_matches_cv2_own_path(src, size):
    """One, three and four channels against cv2 with its IPP dispatch off."""
    img = np.random.default_rng(sum(src)).normal(0, 1, src).astype(np.float32)
    use_ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(use_ipp)
    assert np.array_equal(draw.resize_cubic_f32(img, size), want)
