"""Checkpoint ensembles of the PyTorch port against the JAX package, on the
CPU in f32: `build_ensemble_fn` with two hourglass members of different
widths and seeds, each member as the mask member, at scales (0.5, 1.0) with
flip, and an hourglass with a unet member (tests/test_ensemble.py's
heterogeneous contract).  Inputs, weights and tolerances as in
test_torch_tta.py: valid slots, keep order and label maps exact; boxes 1e-4
px, scores and masks 1e-4.
"""

import dataclasses

import pytest
import torch

from kgtpu.infer import build_ensemble_fn as jax_build_ensemble_fn
from kgtpu.models import KGNet as JaxKGNet
from kgtpu_torch.infer import build_ensemble_fn
from test_torch_infer import _assert_same, _port_model, port_config
from test_torch_tta import _jnp, one_torch_thread, random_params, stacks, tta_config  # noqa: F401


@pytest.mark.parametrize("mask_member,vote,rescore", [(0, "max", 0.0), (1, "mean", 0.5)])
def test_build_ensemble_fn_matches_kgtpu(stacks, mask_member, vote, rescore):  # noqa: F811
    """cfg.model is the mask member's (the stage-2 crop geometry)."""
    jcfgs = [tta_config(vote, rescore), tta_config(vote, rescore, base_channels=16)]
    params = [random_params(jcfgs[0].model, seed=1), random_params(jcfgs[1].model, seed=2)]
    jcfg = jcfgs[mask_member]
    want = jax_build_ensemble_fn([JaxKGNet(cfg=c.model) for c in jcfgs], jcfg,
                                 mask_member=mask_member)(params, _jnp(stacks))
    cfgs = [port_config(c) for c in jcfgs]
    models = [_port_model(c, p) for c, p in zip(cfgs, params)]
    got = build_ensemble_fn(models, cfgs[mask_member], mask_member=mask_member,
                            device="cpu")(stacks)
    assert got["masks"].shape[-1] == cfgs[mask_member].model.mask_size
    assert int(got["valid"].sum()) >= 8
    _assert_same(got, want)


def test_heterogeneous_members_match_kgtpu(stacks):  # noqa: F811
    """tests/test_ensemble.py's contract of an hourglass and a unet member,
    the unet running the mask stage (cfg.model is its ModelConfig), held
    against kgtpu's outputs."""
    jcfg_a = tta_config("mean")
    jcfg_b = jcfg_a.replace(model=dataclasses.replace(jcfg_a.model, backbone="unet",
                                                      base_channels=16))
    params = [random_params(jcfg_a.model, seed=1), random_params(jcfg_b.model, seed=2)]
    want = jax_build_ensemble_fn([JaxKGNet(cfg=jcfg_a.model), JaxKGNet(cfg=jcfg_b.model)],
                                 jcfg_b, mask_member=1)(params, _jnp(stacks))
    cfgs = [port_config(jcfg_a), port_config(jcfg_b)]
    models = [_port_model(c, p) for c, p in zip(cfgs, params)]
    assert models[1].cfg.backbone == "unet" and len(models[1].heads) == 1
    got = build_ensemble_fn(models, cfgs[1], mask_member=1, device="cpu")(stacks)
    d, m = jcfg_b.group.max_detections, jcfg_b.model.mask_size
    assert got["boxes"].shape == (2, d, 4) and got["masks"].shape == (2, d, m, m)
    assert got["label_map"].shape == (2, 128, 128) and got["label_map"].dtype == torch.int32
    assert int(got["valid"].sum()) >= 8
    _assert_same(got, want)
