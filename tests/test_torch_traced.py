"""The traced forms of the port's data-dependent loops and branches
(`ops/control.py`, `traced=True` in `infer.py`; what `torch.export` records)
against the host forms the live path runs: the grouper's matching rounds and
NMS's suppression rounds as a while_loop, the mask stage's and the paste's
slot chunks as conds.  A round after the last live entry changes nothing and
a skipped chunk's logits are 0, so every output must be equal, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import GroupConfig as JGroupConfig
from kgtpu.ops.decode import Peaks as JPeaks
from kgtpu.ops.group import group_keypoints as jgroup
from kgtpu_torch.config import GroupConfig, tiny_test_config
from kgtpu_torch.infer import build_infer_fn, mask_probs
from kgtpu_torch.models import build_model
from kgtpu_torch.ops.decode import Peaks
from kgtpu_torch.ops.group import Boxes, group_keypoints
from kgtpu_torch.ops.nms import box_nms, merge_scales
from kgtpu_torch.ops.roi import paste_masks_batch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a: Boxes, b: Boxes) -> None:
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _adversarial_peaks(seed: int, b: int, k: int):
    """tests/test_utils.py:42's peaks: scores uniform, coordinates up to 2 px
    outside a 32x32 map, for every class."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (b, 5, k)).astype(np.float32)
    coords = rng.uniform(-2, 34, (b, 5, k, 2)).astype(np.float32)
    return scores, coords


@pytest.mark.parametrize("seed,k", [(1, 16), (2, 32), (3, 64), (4, 128)])
def test_group_keypoints_loop_forms_agree(seed, k):
    """Equal keep-sets from the host loop and the while_loop, on
    test_utils.py:42's adversarial peaks (b=1, seed 1, k=16) and random
    batches; both equal kgtpu's lax.while_loop per image."""
    b = 1 if seed == 1 else 3
    scores, coords = _adversarial_peaks(seed, b, k)
    cfg = GroupConfig(max_peaks_per_class=k, max_detections=min(k, 32))
    peaks = Peaks(torch.from_numpy(scores), torch.from_numpy(coords),
                  torch.zeros((b, 5, k), dtype=torch.long))
    host = group_keypoints(peaks, cfg)
    traced = group_keypoints(peaks, cfg, traced=True)
    _equal(host, traced)
    assert int(host.valid.sum()) > 0
    jcfg = JGroupConfig(max_peaks_per_class=k, max_detections=min(k, 32))
    for i in range(b):
        want = jax.block_until_ready(jgroup(JPeaks(jnp.asarray(scores[i]), jnp.asarray(coords[i]),
                                                   jnp.zeros((5, k), jnp.int32)), jcfg))
        np.testing.assert_array_equal(traced.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(traced.boxes[i].numpy(), np.asarray(want.boxes))


@pytest.mark.parametrize("seed", range(4))
def test_box_nms_and_merge_loop_forms_agree(seed):
    """Equal keep-sets from both forms of NMS on heavily overlapping random
    boxes with tied scores, and through the TTA merge with the mean vote."""
    rng = np.random.default_rng(seed)
    b, n = 3, 96
    xy = rng.uniform(0, 40, (b, n, 2))
    wh = rng.uniform(2, 20, (b, n, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    scores = torch.from_numpy(rng.choice([0.2, 0.5, 0.7, 0.9], (b, n)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, n)) < 0.8)
    dets = Boxes(boxes, scores, valid)
    for iou in (0.3, 0.5, 0.7):
        _equal(box_nms(dets, iou, max_out=64), box_nms(dets, iou, max_out=64, traced=True))
    parts = [Boxes(boxes[:, i::3], scores[:, i::3], valid[:, i::3]) for i in range(3)]
    _equal(merge_scales(parts, 0.5, 32, vote="mean", vote_thresh=0.3),
           merge_scales(parts, 0.5, 32, vote="mean", vote_thresh=0.3, traced=True))


def test_paste_chunk_forms_agree():
    """The paste's chunks as conds equal the host-skipped chunks, with
    chunks that hold no valid slot in any image, and per-image id bases."""
    rng = np.random.default_rng(5)
    b, d, r, h, w = 2, 40, 8, 48, 40
    masks = torch.from_numpy(rng.uniform(0, 1, (b, d, r, r)).astype(np.float32))
    xy = rng.uniform(-4, 36, (b, d, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(1, 16, (b, d, 2))],
                                            -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (b, d)).astype(np.float32))
    valid = torch.zeros(b, d, dtype=torch.bool)
    valid[0, :5] = True
    valid[1, 20:23] = True                      # chunks 1 and 4 of 8 are empty
    base = torch.tensor([0, 100], dtype=torch.int32)
    host = paste_masks_batch(masks, boxes, scores, valid, h, w, box_chunk=8, id_base=base)
    traced = paste_masks_batch(masks, boxes, scores, valid, h, w, box_chunk=8, id_base=base,
                               traced=True)
    for x, y in zip(host, traced):
        assert torch.equal(x, y)
    assert int((host[0] > 0).sum()) > 0


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, mask_chunk=8),
                              group=dataclasses.replace(cfg.group, size_prune=0.0))
    model = build_model(cfg.model, seed=0, device="cpu")
    with torch.no_grad():
        model.heads[-1].heads["hm"].out.bias.fill_(1.0)     # peaks everywhere: detections
    return cfg, model


def test_mask_chunk_forms_agree(tiny_model):
    """The mask stage's chunks as conds (the mask head's state passed in as
    operands) equal the host-skipped chunks: skipped slots hold 0.5."""
    cfg, model = tiny_model
    model.eval()
    rng = np.random.default_rng(6)
    b, d = 2, 32
    feats = torch.from_numpy(rng.normal(size=(b, 32, 32, 32)).astype(np.float32))
    xy = rng.uniform(0, 24, (b, d, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + 6], -1).astype(np.float32))
    valid = torch.zeros(b, d, dtype=torch.bool)
    valid[0, :3] = True
    valid[1, 17] = True
    dets = Boxes(boxes, torch.ones(b, d), valid)
    with torch.no_grad():
        host = mask_probs(model, cfg, feats, dets)
        traced = mask_probs(model, cfg, feats, dets, traced=True)
    assert torch.equal(host, traced)
    assert torch.all(host[:, 8:16] == 0.5) and not torch.all(host[:, :8] == 0.5)


def test_infer_fn_forms_agree(tiny_model):
    """build_infer_fn(traced=True), run eagerly, equals the live pipeline."""
    cfg, model = tiny_model
    images = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), np.uint8)
    live = build_infer_fn(model, cfg, device="cpu")(images)
    with torch.no_grad():
        traced = build_infer_fn(model, cfg, device="cpu", traced=True)(images)
    assert int(live["valid"].sum()) > 0
    for k in live:
        assert torch.equal(live[k], traced[k]), k
