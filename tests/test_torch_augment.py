"""The port's train-time augmentation (`kgtpu_torch/data/transforms.py`)
against kgtpu's cv2 calls.

Tolerance: none.  Matrices are f64 arithmetic in cv2's order, warped images
and label maps are f32 arithmetic in cv2 5.0's order (fused multiply-adds
where cv2 fuses), so every comparison is exact.
"""

import cv2
import numpy as np
import pytest
import torch

from kgtpu.data import transforms as jt
from kgtpu_torch.data import transforms as tt


def test_rotation_matrix_and_inverse_match_cv2():
    rng = np.random.default_rng(0)
    for _ in range(500):
        c = (float(rng.integers(1, 1000)) / 2, float(rng.integers(1, 1000)) / 2)
        ang, scale = float(rng.uniform(-180, 180)), float(rng.uniform(0.1, 3))
        want = cv2.getRotationMatrix2D(c, ang, scale)
        np.testing.assert_array_equal(tt.get_rotation_matrix_2d(c, ang, scale), want)
        m = rng.normal(0, 2, (2, 3))
        np.testing.assert_array_equal(tt.invert_affine(m), cv2.invertAffineTransform(m))
    np.testing.assert_array_equal(tt.invert_affine(np.zeros((2, 3))),
                                  cv2.invertAffineTransform(np.zeros((2, 3))))


@pytest.mark.parametrize("rotate,flip", [(0.0, 0.5), (15.0, 0.5), (90.0, 1.0), (30.0, 0.0)])
def test_random_affine_params_match_kgtpu(rotate, flip):
    """Same matrix from the same generator state, and the generator left in
    the same state (the same draws in the same order)."""
    for seed in range(20):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        hw = (int(a.integers(20, 700)), int(a.integers(20, 700)))
        b.integers(20, 700), b.integers(20, 700)
        got = tt.random_affine_params(a, 128, hw, scale_range=(0.6, 1.4),
                                      rotate_deg=rotate, flip_prob=flip)
        want = jt.random_affine_params(b, 128, hw, scale_range=(0.6, 1.4),
                                       rotate_deg=rotate, flip_prob=flip)
        np.testing.assert_array_equal(got, want)
        assert a.uniform() == b.uniform()


def _sample(rng, h, w, big):
    img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if rng.uniform() < 0.5
           else (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8))
    lab = rng.integers(0, 300, (h, w)).astype(np.int32)
    if big:                       # ids >= 2^16 take kgtpu's f32 branch
        lab = np.where(lab > 0, lab + 70_000, 0).astype(np.int32)
    return {"image": img, "label_map": lab, "id": "s"}


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("rotate", [0.0, 15.0, 180.0])
def test_apply_affine_matches_kgtpu(rotate, big):
    """Random matrices (scale, rotation, flip, crop jitter) from square and
    non-square sources onto 96-160 canvases, with and without the colour
    jitter branch; image and label map bitwise, both label branches."""
    rng = np.random.default_rng(int(rotate) + big)
    for t in range(12):
        h, w = (int(v) for v in rng.integers(20, 300, 2))
        out = int(rng.choice([96, 128, 160]))
        m = jt.random_affine_params(rng, out, (h, w), scale_range=(0.5, 1.5),
                                    rotate_deg=rotate, flip_prob=0.5)
        s = _sample(rng, h, w, big)
        jitter = 0.2 if t % 3 == 0 else 0.0
        got = tt.apply_affine(s, m, out, jitter, np.random.default_rng(t))
        want = jt.apply_affine(s, m, out, jitter, np.random.default_rng(t))
        for k in ("image", "label_map"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {t}")
            assert got[k].dtype == want[k].dtype, k
        assert got["id"] == "s"


@pytest.mark.parametrize("out,alpha,sigma", [(96, 12.0, 32.0), (128, 6.0, 48.0),
                                             (160, 20.0, 96.0), (64, 3.0, 0.5)])
def test_random_elastic_field_matches_kgtpu(out, alpha, sigma):
    a, b = np.random.default_rng(out), np.random.default_rng(out)
    got = tt.random_elastic_field(a, out, alpha, sigma)
    want = jt.random_elastic_field(b, out, alpha, sigma)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert a.uniform() == b.uniform()


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("alpha", [3.0, 12.0, 40.0])
def test_apply_elastic_matches_kgtpu(alpha, big):
    """cv2.remap with f32 maps (bilinear image, nearest labels, constant-0
    border), fields strong enough to push pixels off the canvas."""
    rng = np.random.default_rng(int(alpha) + big)
    for t in range(6):
        size = int(rng.choice([64, 96, 128]))
        s = _sample(rng, size, size, big)
        field = jt.random_elastic_field(rng, size, alpha, 32.0)
        got, want = tt.apply_elastic(s, field), jt.apply_elastic(s, field)
        for k in ("image", "label_map"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {t}")
            assert got[k].dtype == want[k].dtype, k


def test_warp_affine_nearest_matches_cv2_on_coordinates():
    """Each destination pixel's source pixel, read off a coordinate-coded
    label map, under random matrices (rint of cv2's f32 source points,
    halves to even)."""
    rng = np.random.default_rng(9)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(20, 120, 2))
        m = jt.random_affine_params(rng, 96, (h, w), scale_range=(0.5, 2.0),
                                    rotate_deg=45.0)
        lab = (np.arange(h * w).reshape(h, w) + 1).astype(np.float32)
        want = cv2.warpAffine(lab, m, (96, 96), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = tt.sample_nearest(torch.from_numpy(lab), *tt.affine_points(m, 96, 96))
        np.testing.assert_array_equal(got.numpy(), want)
