"""Multi-scale and flip TTA of the PyTorch port against the JAX package, on
the CPU in f32: `ops.nms.merge_scales`, `build_detect_fn` and
`build_multiscale_fn`, and the duplicated-member ensemble
(test_torch_ensemble.py holds `build_ensemble_fn` against kgtpu's).

The same numpy images and weights (flax params converted with
`kgtpu_torch.convert`) go through both packages.  Held exactly: valid
slots, keep order, label maps.  Boxes to 1e-4 px, scores and masks to 1e-4
(f32 convolutions summed in another order; see test_torch_infer).
`merge_scales` on the same boxes is held exactly.

The random-weight cases loosen the grouping thresholds as
test_torch_infer does.  Their score gate (0.05) lies above the mean vote's
(0.02), so the rescored case also holds the rescore gate at the looser of
the two: with the gate at score_thresh, voted boxes would drop.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.infer import build_detect_fn as jax_build_detect_fn
from kgtpu.infer import build_multiscale_fn as jax_build_multiscale_fn
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.ops.group import Boxes as JaxBoxes
from kgtpu.ops.nms import merge_scales as jax_merge_scales
from kgtpu_torch.infer import build_detect_fn, build_ensemble_fn, build_multiscale_fn
from kgtpu_torch.ops.group import Boxes
from kgtpu_torch.ops.nms import merge_scales
from test_torch_infer import LOW_THRESH, _assert_same, _port_model, port_config

SCORE_THRESH, VOTE_THRESH = 0.05, 0.02


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tta_config(vote="mean", rescore=0.0, base_channels=32):
    base = jax_tiny_config()
    return base.replace(
        model=dataclasses.replace(base.model, base_channels=base_channels),
        group=dataclasses.replace(base.group, **{**LOW_THRESH, "score_thresh": SCORE_THRESH}),
        infer=dataclasses.replace(base.infer, test_scales=(0.5, 1.0), test_flip=True,
                                  tta_vote=vote, tta_vote_thresh=VOTE_THRESH,
                                  mask_rescore=rescore, mask_chunk=8))


@functools.cache
def random_params(model_cfg, seed=0):
    """kgtpu's init of `model_cfg` from `seed`, as numpy; made once per
    (architecture, seed), since a jitted init compiles in a third of the
    eager init's time, and the arrays are only read."""
    init = jax.jit(lambda k: JaxKGNet(cfg=model_cfg).init(
        k, jnp.zeros((1, 128, 128, 3)), method=JaxKGNet.init_all)["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def stacks():
    rng = np.random.default_rng(3)
    return {"0.5": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
            "1": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _variants(seed, b=3, v=4, dv=16):
    """V variants of Dv boxes per image with planted ties: rows repeated
    across variants (same box and score), equal scores on different boxes,
    the same box at two scores, overlapping near-duplicates, invalid rows."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (b, v, dv, 2))
    wh = rng.uniform(4, 16, (b, v, dv, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.choice(np.float32([0.1, 0.25, 0.4, 0.55, 0.7, 0.9]),
                        (b, v, dv)).astype(np.float32)
    valid = rng.uniform(size=(b, v, dv)) < 0.8
    boxes[:, 1, :4], scores[:, 1, :4] = boxes[:, 0, :4], scores[:, 0, :4]   # copies
    boxes[:, 2, 4:6] = boxes[:, 0, 4:6]                                   # other scores
    boxes[:, 3, :6] = boxes[:, 0, :6] + np.float32(0.5)                   # near copies
    scores[:, :, 8:11] = np.float32(0.55)                                 # equal scores
    return boxes, scores, valid


@pytest.mark.parametrize("vote,vote_thresh", [("max", 0.0), ("mean", 0.0), ("mean", 0.2)])
def test_merge_scales_matches_kgtpu(vote, vote_thresh):
    boxes, scores, valid = _variants(seed=len(vote) + int(vote_thresh * 10))
    v = boxes.shape[1]
    got = merge_scales([Boxes(torch.from_numpy(boxes[:, i]), torch.from_numpy(scores[:, i]),
                              torch.from_numpy(valid[:, i])) for i in range(v)],
                       0.5, 48, vote=vote, vote_iou=0.5, vote_thresh=vote_thresh)

    def one(bx, sc, va):
        return jax_merge_scales([JaxBoxes(bx[i], sc[i], va[i]) for i in range(v)], 0.5, 48,
                                vote=vote, vote_iou=0.5, vote_thresh=vote_thresh)

    want = jax.vmap(one)(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    assert got.boxes.shape == (3, 48, 4)
    n = np.asarray(want.valid).sum(1)
    assert n.min() >= 5 and n.max() < 48
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_build_detect_fn_matches_kgtpu(stacks):
    jcfg = tta_config()
    params = random_params(jcfg.model)
    want = jax_build_detect_fn(JaxKGNet(cfg=jcfg.model), jcfg)(params, jnp.asarray(stacks["0.5"]))
    cfg = port_config(jcfg)
    got = build_detect_fn(_port_model(cfg, params), cfg, device="cpu")(stacks["0.5"])
    v = np.asarray(want.valid)
    assert v.sum() >= 4
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-4)


@pytest.mark.parametrize("vote,rescore", [("max", 0.0), ("mean", 0.0), ("mean", 0.5)])
def test_build_multiscale_fn_matches_kgtpu(stacks, vote, rescore):
    jcfg = tta_config(vote, rescore)
    params = random_params(jcfg.model)
    want = jax_build_multiscale_fn(JaxKGNet(cfg=jcfg.model), jcfg)(params, _jnp(stacks))
    cfg = port_config(jcfg)
    fn = build_multiscale_fn(_port_model(cfg, params), cfg, device="cpu")
    got = fn(stacks)
    assert got["label_map"].shape == (2, 128, 128) and got["boxes"].shape == (2, 32, 4)
    assert int(got["valid"].sum()) >= 8
    _assert_same(got, want)
    if vote == "mean":
        # the vote keeps boxes below the detector's score gate, and the
        # rescore gate keeps them too
        assert bool((got["valid"] & (got["scores"] < SCORE_THRESH)).any())
    # one image without a batch axis
    one = fn({k: v[0] for k, v in stacks.items()})
    assert one["label_map"].shape == (128, 128)
    _assert_same({k: v[None] for k, v in one.items()},
                 {k: np.asarray(v)[:1] for k, v in want.items()})


@pytest.mark.parametrize("vote", ["max", "mean"])
def test_duplicated_member_is_noop(stacks, vote):
    """ensemble([m, m]) gives multiscale(m)'s outputs exactly: the doubled
    variant pool holds only exact copies, NMS keeps the same survivors, and
    the mean over 2V copies equals the mean over V."""
    jcfg = tta_config(vote)
    cfg = port_config(jcfg)
    model = _port_model(cfg, random_params(jcfg.model))
    solo = build_multiscale_fn(model, cfg, device="cpu")(stacks)
    duo = build_ensemble_fn([model, model], cfg, device="cpu")(stacks)
    assert int(solo["valid"].sum()) > 0
    for k in ("valid", "label_map", "boxes"):
        np.testing.assert_array_equal(duo[k].numpy(), solo[k].numpy())
    np.testing.assert_allclose(duo["scores"].numpy(), solo["scores"].numpy(), rtol=1e-6,
                               atol=1e-6)
