"""Targets and crops of the port's train step against the JAX package, on
the CPU in f32: `kgtpu_torch.ops.targets` (the Gaussian kernel's plain
version), the kernel's wrapper on CPU tensors, the nearest and bilinear
crops of `kgtpu_torch.ops.roi`, the colour jitter of `ops.preprocess` and
`kgtpu_torch.data.transforms`.

Tolerances: heatmaps atol 1e-6 (the Pallas kernel's skip cutoff alone
allows exp(-14) ~ 8e-7) with the positive masks (t >= 1.0) exactly equal;
radii and keypoints 1e-6; crops of label maps exact; the bilinear crop's
gradient 1e-5 (f32 sums in another order); normalisation 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.data import transforms as jtransforms
from kgtpu.ops import preprocess as jpre
from kgtpu.ops import roi as jroi
from kgtpu.ops import targets as jtargets
from kgtpu.ops.pallas.gaussian import render_heatmaps_pallas
from kgtpu_torch.data import transforms
from kgtpu_torch.ops import gaussian, roi, targets
from kgtpu_torch.ops.preprocess import normalize_images


def _scene(seed=0, n=32, h=128, w=128, n_valid=24, border=False, tiny=False,
           stacked=False):
    """Boxes in stride coords like tests/test_pallas.py::_scene, with the
    train step's keypoint clamp; optional border-touching boxes (corners at
    exactly w - 1e-3 after the clamp), tiny boxes (radius < 1, sigma 1/6)
    and two instances on one pixel."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, w - 30, n)
    y0 = rng.uniform(0, h - 30, n)
    bw = rng.uniform(3, 25, n)
    bh = rng.uniform(3, 25, n)
    boxes = np.stack([x0, y0, np.minimum(x0 + bw, w - 1),
                      np.minimum(y0 + bh, h - 1)], -1).astype(np.float32)
    if border:
        boxes[:4, 2] = w
        boxes[2:6, 3] = h
        boxes[6, :2] = 0.0
    if tiny:
        boxes[8:12, 2:] = boxes[8:12, :2] + rng.uniform(0.2, 1.5, (4, 2))
    if stacked:
        boxes[13] = boxes[12]
    kpts = np.asarray(jtargets.keypoints_from_boxes(jnp.asarray(boxes)))
    kpts = np.stack([np.clip(kpts[..., 0], 0.0, np.float32(w - 1e-3)),
                     np.clip(kpts[..., 1], 0.0, np.float32(h - 1e-3))], -1)
    sizes = np.stack([boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0]], -1)
    valid = (np.arange(n) < n_valid).astype(np.float32)
    return kpts.astype(np.float32), sizes.astype(np.float32), valid, h, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_heatmaps(got, want):
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got >= 1.0, want >= 1.0)


def test_gaussian_radius_matches_kgtpu():
    rng = np.random.default_rng(0)
    hw = np.concatenate([rng.uniform(0, 40, (200, 2)), [[0, 0], [0.5, 3], [1, 1]]]
                        ).astype(np.float32)
    for mo in (0.7, 0.5):
        want = np.asarray(jtargets.gaussian_radius(jnp.asarray(hw), mo))
        got = targets.gaussian_radius(torch.from_numpy(hw), mo).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(np.floor(got), np.floor(want))


def test_keypoints_from_boxes_matches_kgtpu():
    boxes = np.random.default_rng(1).uniform(0, 100, (3, 7, 4)).astype(np.float32)
    want = np.asarray(jtargets.keypoints_from_boxes(jnp.asarray(boxes)))
    got = targets.keypoints_from_boxes(torch.from_numpy(boxes)).numpy()
    assert got.shape == (3, 7, 5, 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_valid=0), dict(n_valid=1), dict(n_valid=32, border=True),
    dict(tiny=True, stacked=True), dict(h=100, w=72, n_valid=20),
])
def test_render_heatmaps_matches_kgtpu_scan(kw):
    kpts, sizes, valid, h, w = _scene(seed=len(kw), **kw)
    want = np.asarray(jtargets.render_heatmaps(*map(jnp.asarray, (kpts, sizes, valid)), h, w))
    got = targets.render_heatmaps(*_t(kpts, sizes, valid), h, w).numpy()
    assert got.shape == (h, w, 5)
    _assert_heatmaps(got, want)
    if valid.sum():
        assert (got >= 1.0).sum() >= 1


def test_render_heatmaps_batch_matches_kgtpu():
    scenes = [_scene(seed=s, n_valid=nv) for s, nv in ((3, 24), (4, 0), (5, 32))]
    kpts, sizes, valid = (np.stack([s[i] for s in scenes]) for i in range(3))
    want = np.asarray(jtargets.render_heatmaps_batch(
        *map(jnp.asarray, (kpts, sizes, valid)), 128, 128))
    got = targets.render_heatmaps_batch(*_t(kpts, sizes, valid), 128, 128).numpy()
    _assert_heatmaps(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_valid=0), dict(n_valid=32, border=True, seed=6),
    dict(tiny=True, stacked=True, seed=7), dict(h=96, w=80, seed=8),
])
def test_render_heatmaps_matches_pallas_interpret(kw):
    """The plain version against the Pallas kernel it replaces (interpret
    mode; its grid covers H // 16 row tiles, so H is a multiple of 16)."""
    kpts, sizes, valid, h, w = _scene(**kw)
    want = np.asarray(render_heatmaps_pallas(
        *map(jnp.asarray, (kpts, sizes, valid)), h, w, interpret=True))
    got = targets.render_heatmaps(*_t(kpts, sizes, valid), h, w).numpy()
    _assert_heatmaps(got, want)


def test_kernel_wrapper_takes_plain_version_for_cpu_tensors():
    kpts, sizes, valid, h, w = _scene(seed=9)
    k, s, v = _t(kpts[None], sizes[None], valid[None])
    before = gaussian.launches
    got = gaussian.render_heatmaps(k, s, v, h, w)
    assert gaussian.launches == before
    assert torch.equal(got, targets.render_heatmaps_batch(k, s, v, h, w))
    assert got.shape == (1, h, w, 5) and got.dtype == torch.float32


def test_kernel_wrapper_rejects_bad_shapes():
    k, s, v = torch.zeros(2, 4, 5, 2), torch.zeros(2, 4, 2), torch.zeros(2, 4)
    with pytest.raises(ValueError):
        gaussian.render_heatmaps(k[0], s[0], v[0], 8, 8)
    with pytest.raises(ValueError):
        gaussian.render_heatmaps(k[..., :3, :], s, v, 8, 8)
    with pytest.raises(ValueError):
        gaussian.render_heatmaps(k, s[:, :3], v, 8, 8)


def _tile_reach(kpts, sizes, valid, h, w):
    """A plain mirror of the Gaussian kernel's per-class compaction: keep
    [B, tiles_y, tiles_x, 5, N], true where valid instance i's floored
    class-c keypoint is within reach of the tile (the rectangle distance d
    gives d^2 * coef < CUTOFF, in the kernel's f32 arithmetic)."""
    th, tw = gaussian.TILE_H, gaussian.TILE_W
    k = torch.floor(kpts)                                         # [B, N, 5, 2]
    coef = targets.splat_coef(sizes, valid)                       # [B, N]
    y0 = torch.arange(0, h, th, dtype=torch.float32)
    x0 = torch.arange(0, w, tw, dtype=torch.float32)
    y1, x1 = torch.clamp(y0 + th, max=h) - 1, torch.clamp(x0 + tw, max=w) - 1
    kx = k[..., 0].transpose(1, 2)[:, None, None]                 # [B, 1, 1, 5, N]
    ky = k[..., 1].transpose(1, 2)[:, None, None]
    dx = torch.clamp(torch.maximum(x0[None, None, :, None, None] - kx,
                                   kx - x1[None, None, :, None, None]), min=0)
    dy = torch.clamp(torch.maximum(y0[None, :, None, None, None] - ky,
                                   ky - y1[None, :, None, None, None]), min=0)
    return ((dx * dx + dy * dy) * coef[:, None, None, None] < gaussian.CUTOFF
            ) & (valid > 0)[:, None, None, None]


@pytest.mark.parametrize("kw", [
    dict(), dict(n_valid=32, border=True, seed=6), dict(tiny=True, stacked=True, seed=7),
    dict(h=100, w=72, seed=8, n_valid=32),
])
def test_tile_reach_drops_only_what_the_cutoff_allows(kw):
    """Rendering only the (tile, class, instance) triples the kernel's
    compaction keeps differs from the plain renderer by at most the f32
    exp(-14), keeps every positive, and drops most of the triples."""
    scenes = [_scene(**{**kw, "seed": kw.get("seed", 0) + j}) for j in range(2)]
    h, w = scenes[0][3], scenes[0][4]
    kpts, sizes, valid = (torch.from_numpy(np.stack([sc[i] for sc in scenes]))
                          for i in range(3))
    keep = _tile_reach(kpts, sizes, valid, h, w)
    assert keep.shape == (2, -(-h // gaussian.TILE_H), -(-w // gaussian.TILE_W), 5, 32)
    live = keep.sum().item()
    assert 0 < live < 0.5 * keep.numel() * valid.mean().item()
    k = torch.floor(kpts)
    coef = targets.splat_coef(sizes, valid)
    ys = torch.arange(h, dtype=torch.float32)[:, None, None, None]
    xs = torch.arange(w, dtype=torch.float32)[None, :, None, None]
    kept = keep.repeat_interleave(gaussian.TILE_H, 1)[:, :h].repeat_interleave(
        gaussian.TILE_W, 2)[:, :, :w]                             # [B, H, W, 5, N]
    out = []
    for b in range(2):
        dx = xs - k[b, :, :, 0].T                                 # [1, W, 5, N]
        dy = ys - k[b, :, :, 1].T                                 # [H, 1, 5, N]
        g = torch.exp(-(dx * dx + dy * dy) * coef[b])
        out.append(torch.where(kept[b], g, 0.0).amax(-1))
    got = torch.stack(out)
    want = targets.render_heatmaps_batch(kpts, sizes, valid, h, w)
    cut = torch.exp(torch.tensor(-gaussian.CUTOFF)).item()
    assert (got - want).abs().max().item() <= cut
    assert torch.equal(got >= 1.0, want >= 1.0) and (want >= 1.0).any()


# --------------------------------------------------------------------------
# crops
# --------------------------------------------------------------------------

def _label_map(seed, h=64, w=80, n=9):
    rng = np.random.default_rng(seed)
    lab = np.zeros((h, w), np.int32)
    for i in range(1, n + 1):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        lab[y:y + rng.integers(3, 20), x:x + rng.integers(3, 20)] = i
    return lab


def _boxes(seed, b, d, h, w):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-5, w - 4, (b, d))
    y0 = rng.uniform(-5, h - 4, (b, d))
    return np.stack([x0, y0, x0 + rng.uniform(0.3, 40, (b, d)),
                     y0 + rng.uniform(0.3, 40, (b, d))], -1).astype(np.float32)


@pytest.mark.parametrize("out_size", [8, 16])
def test_nearest_crop_matches_kgtpu_exactly(out_size):
    labs = np.stack([_label_map(s) for s in (0, 1)])
    boxes = _boxes(2, 2, 6, 64, 80)
    boxes[0, 0] = [0, 0, 80, 64]                      # whole map
    want = np.stack([np.asarray(jroi.crop_and_resize(
        jnp.asarray(labs[i][..., None].astype(np.float32)), jnp.asarray(boxes[i]),
        out_size, method="nearest"))[..., 0] for i in range(2)])
    got = roi.crop_and_resize(torch.from_numpy(labs)[..., None], torch.from_numpy(boxes),
                              out_size, method="nearest")[..., 0]
    assert got.dtype == torch.int32 and got.shape == (2, 6, out_size, out_size)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_bilinear_crop_backpropagates_into_features():
    """The mask loss trains the backbone through the crop: its gradient in
    the feature map equals JAX's."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 24, 20, 3)).astype(np.float32)
    boxes = _boxes(4, 2, 5, 24, 20)
    proj = rng.normal(size=(2, 5, 8, 8, 3)).astype(np.float32)

    def jloss(f):
        crops = jax.vmap(lambda fi, bi: jroi.crop_and_resize(fi, bi, 8))(f, jnp.asarray(boxes))
        return jnp.sum(crops * proj)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feat)))
    ft = torch.from_numpy(feat).requires_grad_(True)
    (roi.crop_and_resize(ft, torch.from_numpy(boxes), 8) * torch.from_numpy(proj)).sum().backward()
    assert ft.grad is not None and float(ft.grad.abs().max()) > 0
    np.testing.assert_allclose(ft.grad.numpy(), want, atol=1e-5, rtol=1e-5)


def test_normalize_with_colour_jitter_matches_kgtpu():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    gain = rng.uniform(0.8, 1.2, (2, 3)).astype(np.float32)
    bias = rng.uniform(-6, 6, (2, 3)).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = np.asarray(jpre.normalize_images(jnp.asarray(img), mean, std,
                                            jnp.asarray(gain), jnp.asarray(bias)))
    ti, tg, tb = _t(img, gain, bias)
    got = normalize_images(ti, mean, std, tg, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# label map -> instance slots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_instances", [4, 16])
def test_boxes_and_renumber_match_kgtpu(max_instances):
    lab = _label_map(6, n=12)
    lab[0, 0] = 13                                   # a 1-pixel sliver: dropped
    want = jtransforms.boxes_from_label_map(lab, max_instances)
    got = transforms.boxes_from_label_map(lab, max_instances)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(transforms.renumber_label_map(lab, got[2]),
                                  jtransforms.renumber_label_map(lab, want[2]))
