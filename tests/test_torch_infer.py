"""The whole inference slice of the PyTorch port against the JAX package:
`build_infer_fn` and `Predictor`, on the CPU in f32.

The same numpy images and the same weights (flax params converted with
`kgtpu_torch.convert`) go through both packages.  Held exactly: valid slots,
label maps, detection count.  Boxes to 1e-4 px, scores and masks to 1e-4
(f32 convolutions summed in another order; see test_torch_models).

The random-weight cases loosen the grouping thresholds (in both packages) so
that random heatmaps yield detections and the mask stage runs; the trained
flagship checkpoint runs at the default thresholds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu import checkpoint
from kgtpu.config import Config as JaxConfig
from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.data.synthetic import SyntheticCells
from kgtpu.infer import build_infer_fn as jax_build_infer_fn
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.predictor import Predictor as JaxPredictor
from kgtpu_torch import config as tcfg
from kgtpu_torch.convert import load_flax_params
from kgtpu_torch.infer import build_infer_fn
from kgtpu_torch.models import build_model
from kgtpu_torch.predictor import Predictor

LOW_THRESH = dict(kp_score_thresh=0.05, center_thresh=0.05, score_thresh=0.02,
                  center_tol=1.0, size_prune=10.0)


def port_config(jcfg) -> tcfg.Config:
    """The port's Config with the same values as a kgtpu Config."""
    def section(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})
    return tcfg.Config(model=section(tcfg.ModelConfig, jcfg.model),
                       data=section(tcfg.DataConfig, jcfg.data),
                       group=section(tcfg.GroupConfig, jcfg.group),
                       infer=section(tcfg.InferConfig, jcfg.infer))


def _random_params(jcfg):
    h = jcfg.data.input_size
    v = JaxKGNet(cfg=jcfg.model).init(jax.random.PRNGKey(0), jnp.zeros((1, h, h, 3)),
                                      method=JaxKGNet.init_all)
    return jax.tree.map(lambda a: np.array(a), v["params"])


def _port_model(cfg, params):
    return load_flax_params(build_model(cfg.model, seed=None, device="cpu"), params)


def _assert_same(got, want, box_atol=1e-4):
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_map"].numpy(), np.asarray(want["label_map"]))
    v = valid
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               rtol=0, atol=box_atol)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["masks"].numpy()[v], np.asarray(want["masks"])[v],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("mask_chunk,mask_rescore", [(32, 0.0), (8, 0.0), (8, 0.5)])
def test_build_infer_fn_tiny(mask_chunk, mask_rescore):
    base = jax_tiny_config()
    jcfg = base.replace(
        group=dataclasses.replace(base.group, **LOW_THRESH),
        infer=dataclasses.replace(base.infer, mask_chunk=mask_chunk,
                                  mask_rescore=mask_rescore))
    params = _random_params(jcfg)
    cfg = port_config(jcfg)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = jax_build_infer_fn(JaxKGNet(cfg=jcfg.model), jcfg)(params, jnp.asarray(imgs))
    got = build_infer_fn(_port_model(cfg, params), cfg, device="cpu")(imgs)
    d, m = jcfg.group.max_detections, jcfg.model.mask_size
    assert got["boxes"].shape == (2, d, 4) and got["masks"].shape == (2, d, m, m)
    assert got["label_map"].shape == (2, 128, 128)
    assert got["label_map"].dtype == torch.int32
    assert int(got["valid"].sum()) >= 4
    _assert_same(got, want)


def test_flagship_checkpoint_full_width():
    """runs/kg_hard1024/model_99 (2-stack hourglass, 128 channels) on one
    128x128 synthetic_hard image through both packages, in f32."""
    params, extra = checkpoint.restore_bundle("runs/kg_hard1024/model_99", use_ema=True)
    stored = checkpoint.decode_config(extra)
    assert stored.model.backbone == "hourglass" and stored.model.base_channels == 128
    jcfg = JaxConfig(model=dataclasses.replace(stored.model, compute_dtype="float32"))
    cfg = port_config(jcfg)
    img = SyntheticCells(size=128, num_images=1, seed=13, hard=True)[0]["image"][None]
    want = jax_build_infer_fn(JaxKGNet(cfg=jcfg.model), jcfg)(params, jnp.asarray(img))
    got = build_infer_fn(_port_model(cfg, params), cfg, device="cpu")(img)
    assert int(got["valid"].sum()) >= 3          # the trained net finds cells
    _assert_same(got, want)


def test_predictor_matches_kgtpu():
    base = jax_tiny_config()
    jcfg = base.replace(group=dataclasses.replace(base.group, **LOW_THRESH))
    params = _random_params(jcfg)
    cfg = port_config(jcfg)
    sd = _port_model(cfg, params).state_dict()
    rng = np.random.default_rng(2)
    jp = JaxPredictor(jcfg, params)
    p = Predictor(cfg, sd, device="cpu")
    for shape in [(400, 600, 3), (96, 128, 3)]:        # scale 128/600; scale 1
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want, got = jp.predict(img), p.predict(img)
        assert got["label_map"].shape == shape[:2]
        assert got["num_instances"] == want["num_instances"]
        np.testing.assert_array_equal(got["label_map"], want["label_map"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)
    assert got["num_instances"] >= 1
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)   # float input path
    np.testing.assert_array_equal(p.predict(img)["label_map"],
                                  jp.predict(img)["label_map"])
