"""The port's overlay renderer (`kgtpu_torch/visualize.py`, no cv2) against
kgtpu's (`kgtpu/visualize.py`, cv2 5.0): `tests/test_visualize.py`'s three
cases, and `draw_instances` equal to kgtpu's pixel for pixel on random
scenes whose boxes and score labels cross every border.  cv2 5.0 draws the
labels anti-aliased; the port blends them from the committed glyph table
(`tools/make_torch_glyphs.py`), so both are held exactly.
"""

import cv2
import numpy as np
import pytest

from kgtpu.visualize import draw_instances as jdraw
from kgtpu_torch.visualize import (_palette, denormalize, draw_instances, put_score,
                                   rectangle)


def test_denormalize_roundtrip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(16, 16, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    norm = (img.astype(np.float32) / 255.0 - mean) / std
    back = denormalize(norm, mean, std)
    assert back.dtype == np.uint8
    np.testing.assert_allclose(back, img, atol=1)


def test_draw_instances_overlays_and_boxes():
    img = np.full((32, 32, 3), 100, np.uint8)
    label = np.zeros((32, 32), np.int32)
    label[4:12, 4:12] = 1
    boxes = np.asarray([[4.0, 4.0, 12.0, 12.0], [0, 0, 0, 0]], np.float32)
    scores = np.asarray([0.9, 0.0], np.float32)
    valid = np.asarray([True, False])
    vis = draw_instances(img, label, boxes, scores, valid)
    assert vis.shape == img.shape and vis.dtype == np.uint8
    assert not np.array_equal(vis[6, 6], img[6, 6])
    np.testing.assert_array_equal(vis[30, 30], img[30, 30])


def test_draw_instances_empty_scene():
    img = np.zeros((8, 8, 3), np.uint8)
    vis = draw_instances(img, np.zeros((8, 8), np.int32),
                         np.zeros((0, 4)), np.zeros(0), np.zeros(0, bool))
    np.testing.assert_array_equal(vis, img)


@pytest.mark.parametrize("seed", range(4))
def test_draw_instances_equals_kgtpu(seed):
    """Random images, label maps and boxes (up to 15 px beyond every
    border), valid and invalid slots: the port's overlay equals kgtpu's."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(8, 90, 2))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        label = (rng.integers(0, 9, (h, w)) * (rng.random((h, w)) < 0.3)).astype(np.int32)
        d = int(rng.integers(0, 14))
        boxes = rng.uniform(-15, max(h, w) + 15, (d, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, d).astype(np.float32)
        valid = rng.random(d) < 0.7
        np.testing.assert_array_equal(draw_instances(img, label, boxes, scores, valid),
                                      jdraw(img, label, boxes, scores, valid))


def test_palette_is_kgtpus():
    from kgtpu.visualize import _palette as jpalette
    for n in (0, 1, 7, 300):
        np.testing.assert_array_equal(_palette(n), jpalette(n))


def test_score_labels_and_rectangles_equal_cv2_at_every_border():
    """Every string "0.00" ... "1.00" at random positions on noise, cut by
    each border of the image, in random colours; rectangles of every
    orientation, partly or wholly outside."""
    rng = np.random.default_rng(9)
    for i in range(101):
        text = f"{i / 100:.2f}"
        for _ in range(8):
            h, w = (int(v) for v in rng.integers(5, 50, 2))
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            org = (int(rng.integers(-25, w + 3)), int(rng.integers(-3, h + 10)))
            col = tuple(int(v) for v in rng.integers(0, 256, 3))
            want = img.copy()
            cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.35, col, 1)
            got = img.copy()
            put_score(got, text, org, col)
            np.testing.assert_array_equal(got, want, err_msg=f"{text} at {org} in {h}x{w}")
            p0 = tuple(int(v) for v in rng.integers(-10, max(h, w) + 10, 2))
            p1 = tuple(int(v) for v in rng.integers(-10, max(h, w) + 10, 2))
            cv2.rectangle(want, p0, p1, col, 1)
            rectangle(got, p0, p1, col)
            np.testing.assert_array_equal(got, want, err_msg=f"rectangle {p0} {p1}")
