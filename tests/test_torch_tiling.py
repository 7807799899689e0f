"""Whole-slide tiling of the PyTorch port against the JAX package, on the CPU
in f32: the tiling ops (`ops/tiling.py`), `paste_masks` and
`paste_masks_batch` with `id_base` and `init`, and `build_tiled_infer_fn`.

Held exactly: tile grids, ownership rects and masks, extracted tiles,
stitched maps (score ties included), pasted label maps, and the tiled
path's label map and valid slots.  Boxes to 1e-4 px, scores to 1e-4 (f32
convolutions summed in another order; see test_torch_infer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.infer import build_tiled_infer_fn as jax_build_tiled_infer_fn
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.ops import roi as jroi
from kgtpu.ops import tiling as jtiling
from kgtpu.ops.group import Boxes as JaxBoxes
from kgtpu_torch.infer import build_tiled_infer_fn
from kgtpu_torch.ops import roi, tiling
from kgtpu_torch.ops.group import Boxes
from test_torch_infer import _port_model, port_config
from test_torch_tta import one_torch_thread, random_params, tta_config  # noqa: F401

GRIDS = [(224, 224, 128, 32), (1024, 1024, 512, 64), (2048, 2048, 512, 64),
         (300, 500, 128, 40), (512, 512, 512, 0), (700, 260, 256, 100)]


@pytest.mark.parametrize("h,w,tile,overlap", GRIDS)
def test_tile_grid_and_ownership_rects_match_kgtpu(h, w, tile, overlap):
    origins = tiling.tile_grid(h, w, tile, overlap)
    want = jtiling.tile_grid(h, w, tile, overlap)
    assert origins.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(origins, want)
    assert origins[:, 0].max() == h - tile and origins[:, 1].max() == w - tile   # clamped
    rects = tiling.ownership_rects(origins, tile)
    assert rects.dtype == np.float32
    np.testing.assert_array_equal(rects, jtiling.ownership_rects(want, tile))


@pytest.mark.parametrize("h,w,tile,overlap", [(300, 500, 128, 40), (224, 224, 128, 32)])
def test_ownership_mask_is_a_partition_and_matches_kgtpu(h, w, tile, overlap):
    """Detections whose centers cover the image (integer and half-pixel
    centers, on the rect boundaries too) are each owned by exactly one tile
    that contains them; the mask equals kgtpu's."""
    origins = tiling.tile_grid(h, w, tile, overlap)
    rects = tiling.ownership_rects(origins, tile)
    rng = np.random.default_rng(0)
    t = len(origins)
    cy = rng.integers(0, 2 * h, 400) * np.float32(0.5)
    cx = rng.integers(0, 2 * w, 400) * np.float32(0.5)
    half = (rng.integers(4, 24, (400, 2)) / 4).astype(np.float32)   # exact centers
    img_boxes = np.stack([cx - half[:, 0], cy - half[:, 1], cx + half[:, 0], cy + half[:, 1]],
                         -1).astype(np.float32)
    local = (img_boxes[None] - origins[:, None, [1, 0, 1, 0]]).astype(np.float32)  # [T, N, 4]
    valid = np.repeat((rng.uniform(size=400) < 0.9)[None], t, axis=0)
    got = tiling.ownership_mask(Boxes(torch.from_numpy(local), None, torch.from_numpy(valid)),
                                torch.from_numpy(origins), torch.from_numpy(rects)).numpy()
    want = jax.vmap(lambda b, v, o, r: jtiling.ownership_mask(JaxBoxes(b, None, v), o, r))(
        jnp.asarray(local), jnp.asarray(valid), jnp.asarray(origins), jnp.asarray(rects))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got.sum(0), valid[0].astype(int))
    inside = ((cy[None] >= origins[:, :1]) & (cy[None] < origins[:, :1] + tile)
              & (cx[None] >= origins[:, 1:]) & (cx[None] < origins[:, 1:] + tile))
    assert not (got & ~inside).any()


def test_extract_and_stitch_tiles_match_kgtpu():
    """Tiles of a [300, 500, 3] image; stitching random canvases whose scores
    tie often (a few levels) so that the lowest tile must win ties, and
    zero-score pixels that must not land."""
    h, w, ts = 300, 500, 128
    origins = tiling.tile_grid(h, w, ts, 40)
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    tiles = tiling.extract_tiles(torch.from_numpy(img), origins, ts)
    want = jtiling.extract_tiles(jnp.asarray(img), jnp.asarray(origins), ts)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(want))
    t = len(origins)
    labels = (np.arange(t, dtype=np.int32)[:, None, None] * 100
              + rng.integers(1, 100, (t, ts, ts), dtype=np.int32))
    scores = rng.choice(np.float32([0.0, 0.3, 0.6, 0.9]), (t, ts, ts))
    got_l, got_s = tiling.stitch_tiles(torch.from_numpy(labels), torch.from_numpy(scores),
                                       torch.from_numpy(origins), h, w)
    want_l, want_s = jtiling.stitch_tiles(jnp.asarray(labels), jnp.asarray(scores),
                                          jnp.asarray(origins), h, w)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_l.dtype == torch.int32 and got_s.dtype == torch.float32


def _paste_inputs(seed, b=3, d=20, r=8, size=64):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(0, 1, (b, d, r, r)).astype(np.float32)
    xy = rng.uniform(-8, size - 8, (b, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 30, (b, d, 2))], -1).astype(np.float32)
    scores = rng.choice(np.float32([0.2, 0.5, 0.8]), (b, d)).astype(np.float32)   # ties
    valid = rng.uniform(size=(b, d)) < 0.7
    valid[:, 12:] = False                    # a chunk with no valid slot skips
    return masks, boxes, scores, valid


@pytest.mark.parametrize("id_base", [0, 37, "per_image"])
def test_paste_masks_batch_id_base_matches_kgtpu(id_base):
    masks, boxes, scores, valid = _paste_inputs(2)
    base = np.array([0, 40, 80], np.int32) if id_base == "per_image" else id_base
    tbase = torch.from_numpy(base) if id_base == "per_image" else base
    got = roi.paste_masks_batch(torch.from_numpy(masks), torch.from_numpy(boxes),
                                torch.from_numpy(scores), torch.from_numpy(valid), 64, 64,
                                thresh=0.5, box_chunk=8, id_base=tbase)
    want = jroi.paste_masks_batch(jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(valid), 64, 64, thresh=0.5, box_chunk=8,
                                  id_base=jnp.asarray(base))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    assert int((got[0] > 0).sum()) > 500


@pytest.mark.parametrize("with_init", [False, True])
def test_paste_masks_id_base_and_init_match_kgtpu(with_init):
    """One image, on top of a carried (label, score) map whose scores tie with
    the new instances' (ties keep the carry), and a negative carried score."""
    masks, boxes, scores, valid = (a[0] for a in _paste_inputs(3))
    init = None
    if with_init:
        rng = np.random.default_rng(4)
        init = (rng.integers(0, 5, (64, 64)).astype(np.int32),
                rng.choice(np.float32([-1.0, 0.0, 0.2, 0.5, 0.9]), (64, 64)))
    got = roi.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                          torch.from_numpy(scores), torch.from_numpy(valid), 64, 64,
                          thresh=0.5, box_chunk=8, id_base=100,
                          init=None if init is None else tuple(map(torch.from_numpy, init)))
    want = jroi.paste_masks(jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(valid), 64, 64, thresh=0.5, box_chunk=8, id_base=100,
                            init=None if init is None else tuple(map(jnp.asarray, init)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int((got[0] > 100).sum()) > 100


@pytest.mark.parametrize("tile_batch,rescore", [(3, 0.0), (8, 0.5)])
def test_build_tiled_infer_fn_matches_kgtpu(tile_batch, rescore):
    """A 224x224 slide in 128x128 tiles with overlap 32 (4 tiles): tile_batch
    3 leaves a short last chunk (kgtpu pads it); tile_batch 8 is larger than
    the grid."""
    base = tta_config(rescore=rescore)
    jcfg = base.replace(infer=dataclasses.replace(base.infer, tile_size=128, tile_overlap=32,
                                                  test_scales=(1.0,), test_flip=False))
    params = random_params(jcfg.model)
    img = np.random.default_rng(5).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    want = jax_build_tiled_infer_fn(JaxKGNet(cfg=jcfg.model), jcfg, (224, 224),
                                    tile_batch=tile_batch)(params, jnp.asarray(img))
    cfg = port_config(jcfg)
    got = build_tiled_infer_fn(_port_model(cfg, params), cfg, (224, 224), device="cpu",
                               tile_batch=tile_batch)(img)
    d = cfg.group.max_detections
    assert got["label_map"].shape == (224, 224) and got["label_map"].dtype == torch.int32
    assert got["boxes"].shape == (4 * d, 4) and got["valid"].shape == (4 * d,)
    v = np.asarray(want["valid"])
    assert v.sum() >= 8
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["label_map"].numpy(), np.asarray(want["label_map"]))
    np.testing.assert_allclose(got["score_map"].numpy(), np.asarray(want["score_map"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-4)
    ids = np.unique(got["label_map"].numpy())
    assert v[ids[ids > 0] - 1].all()          # every pasted id is an owned slot
