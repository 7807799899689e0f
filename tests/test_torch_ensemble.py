"""Checkpoint ensembles of the PyTorch port against the JAX package, on the
CPU in f32: `build_ensemble_fn` with two hourglass members of different
widths and seeds, each member as the mask member, at scales (0.5, 1.0) with
flip.  Inputs, weights and tolerances as in test_torch_tta.py: valid slots,
keep order and label maps exact; boxes 1e-4 px, scores and masks 1e-4.
"""

import pytest

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
