"""The centernet decode (`group.method="centernet"`) of the PyTorch port
against the JAX package, on the CPU in f32.

`ops.decode.decode_center_wh` against `kgtpu.ops.decode.decode_center_wh`
(vmapped over the batch) on the same numpy logits, kgtpu also on the
port's sigmoid of them: boxes, scores, valid and the peak indices exact,
on an even map (the blocked top-k), an odd-sided map and a map with
k > H*W/4 (both the full top-k), with plateaus and negative sizes
planted.  Then `build_infer_fn` with the centernet decode
against kgtpu's at tiny size (valid slots and label maps exact, as in
test_torch_infer.py), and the refusal without the wh head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.infer import build_infer_fn as jax_build_infer_fn
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.ops.decode import decode_center_wh as jax_decode_center_wh
from kgtpu.ops.decode import decode_peaks as jax_decode_peaks
from kgtpu_torch.infer import build_infer_fn, build_tiled_infer_fn
from kgtpu_torch.models import build_model
from kgtpu_torch.ops.decode import decode_center_wh, decode_peaks
from test_torch_infer import LOW_THRESH, _assert_same, _port_model, port_config
from test_torch_tta import random_params


def _maps(seed, b, h, w):
    rng = np.random.default_rng(seed)
    hm = rng.normal(-3.5, 1.5, (b, h, w, 5)).astype(np.float32)
    hm[0, 2:4, 3:5, 4] = 1.5                            # a plateau on the center class
    hm[:, 5, 6, 4] = hm[:, 7, 1, 4] = 0.75              # equal scores
    reg = rng.uniform(-0.2, 1.2, (b, h, w, 2)).astype(np.float32)
    wh = rng.normal(4, 3, (b, h, w, 2)).astype(np.float32)   # some sizes negative
    return hm, reg, wh


@pytest.mark.parametrize("h,w,k", [(32, 32, 16), (31, 33, 24), (16, 16, 100)],
                         ids=["blocked", "odd_sides", "k_over_quarter"])
@pytest.mark.parametrize("with_reg", [True, False])
def test_decode_center_wh_matches_kgtpu(h, w, k, with_reg):
    """The port decodes logits.  kgtpu given the port's sigmoid of them as
    probabilities gives every output exactly; kgtpu given the logits
    themselves differs only in its sigmoid, by up to 2 ulps on some pixels:
    there the scores are held to 2 ulps, the rest exactly."""
    hm, reg, wh = _maps(h + w + k, 3, h, w)
    thresh = 0.45
    got = decode_center_wh(torch.from_numpy(hm),
                           torch.from_numpy(reg) if with_reg else None,
                           torch.from_numpy(wh), k, thresh)
    # the center channel as the port slices it: torch's sigmoid of a
    # strided view may round differently from that of a contiguous tensor
    prob = hm.copy()
    prob[..., 4:] = torch.sigmoid(torch.from_numpy(hm)[..., 4:]).numpy()
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    for maps, sig in ((prob, False), (hm, True)):
        want = jax.vmap(lambda a, r, s: jax_decode_center_wh(
            a, r if with_reg else None, s, k, thresh, apply_sigmoid=sig))(
                jnp.asarray(maps), jnp.asarray(reg), jnp.asarray(wh))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
        if sig:
            np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(want.scores),
                                            maxulp=2)
        else:
            np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        # the peaks the sizes were gathered at
        jidx = jax.vmap(lambda a: jax_decode_peaks(a, None, k, sig).indices)(
            jnp.asarray(maps[..., 4:]))
        idx = decode_peaks(torch.from_numpy(hm[..., 4:]), None, k).indices
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def _centernet_config():
    base = jax_tiny_config()
    return base.replace(group=dataclasses.replace(
        base.group, **{**LOW_THRESH, "method": "centernet", "score_thresh": 0.05}))


def test_build_infer_fn_centernet_matches_kgtpu():
    jcfg = _centernet_config()
    params = random_params(jcfg.model, seed=4)
    cfg = port_config(jcfg)
    imgs = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = jax_build_infer_fn(JaxKGNet(cfg=jcfg.model), jcfg)(params, jnp.asarray(imgs))
    got = build_infer_fn(_port_model(cfg, params), cfg, device="cpu")(imgs)
    assert int(got["valid"].sum()) >= 4
    _assert_same(got, want)


def test_centernet_needs_the_wh_head():
    jcfg = _centernet_config()
    cfg = port_config(jcfg)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_wh_head=False))
    model = build_model(cfg.model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="use_wh_head"):
        build_infer_fn(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="use_wh_head"):
        build_tiled_infer_fn(model, cfg, (256, 256), device="cpu")
