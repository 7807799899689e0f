"""Inference ops of the PyTorch port against the JAX package and the numpy
oracles (tests/golden/oracles.py), on f32 inputs made with numpy.

Integer results are held exactly: peak indices and their order, grouped-box
selection, NMS keep-sets, label maps.  Float results: 1e-6 for values the
two packages compute with the same elementwise formula (sigmoid scores,
grouping scores), 1e-5 for the resampling matmuls (different summation
order).  The predictor's cv2-style resizes are held against cv2 itself.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import GroupConfig as JaxGroupConfig
from kgtpu.data.transforms import resize_sample
from kgtpu.ops import decode as jdecode
from kgtpu.ops import group as jgroup
from kgtpu.ops import nms as jnms
from kgtpu.ops import preprocess as jpre
from kgtpu.ops import roi as jroi
from kgtpu_torch.config import GroupConfig
from kgtpu_torch.ops import decode, group, nms, preprocess, roi
from kgtpu_torch.data.transforms import resize_image
from kgtpu_torch.predictor import resize_nearest
from tests.golden import oracles


def _t(x):
    return torch.from_numpy(np.array(x))


def _heatmaps(seed, b=2, h=32, w=32, c=5, plateaus=False):
    rng = np.random.default_rng(seed)
    hm = rng.normal(-2.0, 1.5, size=(b, h, w, c)).astype(np.float32)
    if plateaus:
        # few distinct values: equal neighbours and ties at the k boundary
        hm = np.round(hm * 2.0) / 2.0
    reg = rng.uniform(-0.2, 1.2, size=(b, h, w, 2)).astype(np.float32)
    return hm, reg


@pytest.mark.parametrize("plateaus", [False, True])
def test_decode_peaks_exact(plateaus):
    hm, reg = _heatmaps(1 + plateaus, plateaus=plateaus)
    k = 24
    got = decode.decode_peaks(_t(hm), _t(reg), k)
    want = jax.vmap(lambda h, r: jdecode.decode_peaks(h, r, k))(
        jnp.asarray(hm), jnp.asarray(reg))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(want.coords),
                               rtol=0, atol=1e-6)
    for i in range(hm.shape[0]):
        s, c, idx = oracles.decode_peaks(hm[i], reg[i], k)
        np.testing.assert_array_equal(got.indices[i].numpy(), idx)
        np.testing.assert_allclose(got.scores[i].numpy(), s, atol=1e-6)
        np.testing.assert_allclose(got.coords[i].numpy(), c, atol=1e-5)



@pytest.mark.parametrize("h,w,k", [(16, 16, 128), (15, 18, 24), (8, 8, 64)])
def test_decode_peaks_full_topk_exact(h, w, k):
    """Maps with an odd side or fewer than 4k pixels (a small TTA scale's
    heatmap) take kgtpu's top_k over every pixel; plateaus tie at k."""
    hm, reg = _heatmaps(7, h=h, w=w, plateaus=True)
    got = decode.decode_peaks(_t(hm), _t(reg), k)
    want = jax.vmap(lambda h_, r: jdecode.decode_peaks(h_, r, k))(
        jnp.asarray(hm), jnp.asarray(reg))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(want.coords),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="k <= H\\*W"):
        decode.decode_peaks(_t(hm), _t(reg), h * w + 1)

def _box_peaks(seed, b=2, n=10, k=16):
    """Per-class peaks of random boxes with keypoint noise, tied scores and
    stray peaks; plus a random wh map at the peaks."""
    rng = np.random.default_rng(seed)
    scores = np.zeros((b, 5, k), np.float32)
    coords = np.zeros((b, 5, k, 2), np.float32)
    for i in range(b):
        x0 = rng.uniform(0, 40, n)
        y0 = rng.uniform(0, 40, n)
        x1 = x0 + rng.uniform(3, 16, n)
        y1 = y0 + rng.uniform(3, 16, n)
        kp = np.stack([np.stack([x0, y0], -1), np.stack([x1, y0], -1),
                       np.stack([x0, y1], -1), np.stack([x1, y1], -1),
                       np.stack([(x0 + x1) / 2, (y0 + y1) / 2], -1)], 1)
        kp = kp + rng.normal(0, 0.7, kp.shape)
        s = np.round(rng.uniform(0.05, 1.0, (n, 5)), 1)     # ties on purpose
        for c in range(5):
            coords[i, c, :n] = kp[:, c]
            scores[i, c, :n] = s[:, c]
            coords[i, c, n:] = rng.uniform(0, 56, (k - n, 2))
            scores[i, c, n:] = rng.uniform(0.0, 0.5, k - n)
    kp_wh = rng.uniform(2, 12, (b, 5, k, 2)).astype(np.float32)
    idx = np.zeros((b, 5, k), np.int64)
    return scores, coords, idx, kp_wh


@pytest.mark.parametrize("size_prune", [0.0, 3.0])
def test_group_keypoints_exact(size_prune):
    scores, coords, idx, kp_wh = _box_peaks(3)
    jcfg = JaxGroupConfig(max_detections=12, size_prune=size_prune)
    tcfg = GroupConfig(max_detections=12, size_prune=size_prune)
    got = group.group_keypoints(
        decode.Peaks(_t(scores), _t(coords), _t(idx)), tcfg, kp_wh=_t(kp_wh))
    want = jax.vmap(lambda s, c, i, w: jgroup.group_keypoints(
        jdecode.Peaks(s, c, i), jcfg, kp_wh=w))(
        jnp.asarray(scores), jnp.asarray(coords), jnp.asarray(idx, jnp.int32),
        jnp.asarray(kp_wh))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 4
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


def test_decode_group_chain_exact():
    """Decoded random heatmaps through the grouper (low thresholds so many
    candidate edges compete in the matching)."""
    hm, reg = _heatmaps(7, h=32, w=32)
    cfg = dict(max_peaks_per_class=32, max_detections=32, kp_score_thresh=0.05,
               center_thresh=0.05, score_thresh=0.02)
    peaks = decode.decode_peaks(_t(hm), _t(reg), 32)
    got = group.group_keypoints(peaks, GroupConfig(**cfg))
    want = jax.vmap(lambda h, r: jgroup.group_keypoints(
        jdecode.decode_peaks(h, r, 32), JaxGroupConfig(**cfg)))(
        jnp.asarray(hm), jnp.asarray(reg))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 10
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


def _nms_inputs(seed, b=3, n=40):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (b, n, 2))
    wh = rng.uniform(4, 20, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # near-duplicates so suppression chains form
    boxes[:, 1::3] = boxes[:, 0::3][:, :boxes[:, 1::3].shape[1]] + rng.normal(
        0, 1.5, boxes[:, 1::3].shape)
    scores = np.round(rng.uniform(0, 1, (b, n)), 2).astype(np.float32)
    valid = rng.uniform(size=(b, n)) < 0.8
    return boxes, scores, valid


@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_box_nms_exact(iou):
    boxes, scores, valid = _nms_inputs(int(iou * 10))
    got = nms.box_nms(group.Boxes(_t(boxes), _t(scores), _t(valid)), iou)
    want = jax.vmap(lambda bx, s, v: jnms.box_nms(jgroup.Boxes(bx, s, v), iou))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    for i in range(boxes.shape[0]):
        kept = oracles.greedy_nms(boxes[i], scores[i], valid[i], iou)
        nk = len(kept)
        assert int(got.valid[i].sum()) == nk
        np.testing.assert_array_equal(got.boxes[i, :nk].numpy(), boxes[i][kept])
    np.testing.assert_allclose(
        nms.batched_box_iou(_t(boxes), _t(boxes)).numpy(),
        np.stack([np.asarray(jnms.batched_box_iou(jnp.asarray(x), jnp.asarray(x)))
                  for x in boxes]), rtol=0, atol=1e-7)


def test_crop_and_resize():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 24, 20, 6)).astype(np.float32)
    xy = rng.uniform(-3, 15, (2, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 12, (2, 5, 2))],
                           -1).astype(np.float32)
    got = roi.crop_and_resize(_t(img), _t(boxes), 8).numpy()
    assert got.shape == (2, 5, 8, 8, 6)
    for i in range(2):
        want = np.asarray(jroi.crop_and_resize(jnp.asarray(img[i]),
                                               jnp.asarray(boxes[i]), 8))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[i], oracles.crop_and_resize(img[i], boxes[i], 8),
                                   rtol=0, atol=1e-5)


def test_crop_and_resize_bf16():
    """bf16 features keep bf16 operands: within bf16 resolution of JAX."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    boxes = np.array([[[1.5, 2.0, 9.0, 12.5], [0, 0, 16, 16]]], np.float32)
    x = torch.from_numpy(img).to(torch.bfloat16)
    got = roi.crop_and_resize(x, _t(boxes), 4)
    assert got.dtype == torch.bfloat16
    want = jroi.crop_and_resize(jnp.asarray(img[0]).astype(jnp.bfloat16),
                                jnp.asarray(boxes[0]), 4)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=0.02)


def test_paste_masks_batch_exact():
    rng = np.random.default_rng(6)
    b, d, r, hgt, wid = 2, 40, 8, 48, 40
    masks = 1 / (1 + np.exp(-rng.normal(0, 3, (b, d, r, r)))).astype(np.float32)
    xy = rng.uniform(-4, 36, (b, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (b, d, 2))],
                           -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (b, d)), 1).astype(np.float32)
    valid = np.zeros((b, d), bool)
    valid[:, :21] = rng.uniform(size=(b, 21)) < 0.9   # chunk 2 of 3 partly valid
    got_l, got_s = roi.paste_masks_batch(_t(masks), _t(boxes), _t(scores),
                                         _t(valid), hgt, wid, box_chunk=16)
    want_l, want_s = jroi.paste_masks_batch(
        jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(valid), hgt, wid, box_chunk=16)
    assert got_l.dtype == torch.int32 and got_l.shape == (b, hgt, wid)
    assert (got_l.numpy() > 0).mean() > 0.2
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_normalize_images():
    img = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = preprocess.normalize_images(_t(img), mean, std)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jpre.normalize_images(jnp.asarray(img), mean, std)), rtol=0, atol=1e-6)


def test_normalize_images_traced_first_keeps_real_constants():
    """A `torch.export` trace that normalises first (fake tensors) leaves no
    fake mean or std behind for eager calls, and both give the same
    values; eager calls share one vector per device."""
    img = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    mean, std = (0.11, 0.22, 0.33), (0.44, 0.55, 0.66)   # values no other test uses

    class Norm(torch.nn.Module):
        def forward(self, x):
            return preprocess.normalize_images(x, mean, std)

    program = torch.export.export(Norm(), (_t(img),), strict=False)
    eager = preprocess.normalize_images(_t(img), mean, std)
    assert type(preprocess._channel_vector(mean, _t(img))) is torch.Tensor
    assert preprocess._channel_vector(std, _t(img)) is preprocess._channel_vector(std, _t(img))
    torch.testing.assert_close(program.module()(_t(img)), eager, rtol=0, atol=0)
    np.testing.assert_allclose(eager.numpy(), np.asarray(
        jpre.normalize_images(jnp.asarray(img), mean, std)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,canvas", [(400, 600, 128), (600, 400, 128),
                                        (128, 96, 128), (300, 517, 256),
                                        (517, 517, 512), (260, 347, 512),
                                        (260, 347, 1024)])
def test_resize_matches_cv2(h, w, canvas):
    """The predictor's image resize equals kgtpu's cv2.warpAffine resize on
    the CPU (exact; the scale-1 case is a copy), and its label-map resize
    equals cv2.resize(INTER_NEAREST)."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = resize_sample({"image": img, "label_map": np.zeros((h, w), np.int32)},
                         canvas)["image"]
    got = resize_image(torch.from_numpy(img), canvas).numpy()
    np.testing.assert_array_equal(got, want)
    lab = rng.integers(0, 200, (canvas * h // max(h, w), canvas * w // max(h, w)))
    want_l = cv2.resize(lab.astype(np.uint16), (w, h),
                        interpolation=cv2.INTER_NEAREST).astype(np.int32)
    got_l = resize_nearest(torch.from_numpy(lab.astype(np.int32)), h, w).numpy()
    np.testing.assert_array_equal(got_l, want_l)


def test_resize_sweep_matches_cv2():
    """A seeded sweep of 120 (image size, canvas) pairs: the predictor's image
    resize equals cv2.warpAffine's exactly.  Half of the images take only the
    values 0 and 255, whose bilinear blends land on or next to half-way
    values, where the order of cv2's fused multiply-adds decides the
    rounding."""
    rng = np.random.default_rng(2024)
    for i in range(120):
        h, w = (int(v) for v in rng.integers(8, 600, 2))
        canvas = int(rng.choice([64, 96, 128, 256, 384, 512, 100, 333]))
        if i % 2:
            img = (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
        else:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = resize_sample({"image": img, "label_map": np.zeros((h, w), np.int32)},
                             canvas)["image"]
        got = resize_image(torch.from_numpy(img), canvas).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} -> {canvas}")


def test_fma_rounds_once():
    """The resize's fused multiply-add rounds a * b + c to f32 once, also
    where the f64 sum lies on a tie between two floats and rounding it again
    would go the wrong way (checked against exact rationals)."""
    from fractions import Fraction

    from kgtpu_torch.data.transforms import _fma

    def exact32(x):
        r = np.float32(float(x))
        near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
        return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                        int(np.float32(v).view(np.int32)) & 1))

    rng = np.random.default_rng(0)
    n = 300
    c = rng.uniform(1, 255, n).astype(np.float32)
    half_ulp = np.spacing(c).astype(np.float64) / 2 * rng.choice([1.0, -1.0], n)
    a = np.concatenate([np.full(n, 1 + 2 ** -23), np.full(n, 1 - 2 ** -24),
                        rng.uniform(0, 1, n)]).astype(np.float32)
    b = np.concatenate([half_ulp * (1 - 2 ** -23), half_ulp * (1 + 2 ** -23),
                        rng.uniform(-255, 255, n)]).astype(np.float32)
    c = np.concatenate([c, c, c])
    got = _fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([exact32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
