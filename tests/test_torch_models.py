"""Models of the PyTorch port against the flax models of the JAX package.

Random flax params (numpy) are converted with `kgtpu_torch.convert` and both
packages run the same numpy inputs in f32 (compute_dtype="float32": the
point is the architecture and the weight mapping, not bf16 rounding).
Tolerance: 1e-4 absolute + relative, for f32 convolutions summed in a
different order by XLA and by PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.models.blocks import ConvBlock as JaxConvBlock
from kgtpu.models.blocks import Residual as JaxResidual
from kgtpu.models.blocks import upsample2x as jax_upsample2x
from kgtpu_torch import config as tcfg
from kgtpu_torch.convert import _Converter, flax_to_state_dict, load_flax_params
from kgtpu_torch.models import KGNet, build_model
from kgtpu_torch.models.blocks import ConvBlock, Residual, same_pads, upsample2x

ATOL = RTOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _sub_state_dict(fill, params):
    c = _Converter(params)
    fill(c)
    return c.out


@pytest.mark.parametrize("cin,cout,kernel,stride,size", [
    (3, 16, 7, 2, 32),      # the stem: SAME pads (2, 3)
    (16, 16, 3, 1, 16),
    (16, 32, 3, 2, 16),     # stride-2 3x3: SAME pads (0, 1)
    (8, 8, 3, 2, 15),       # odd side
])
def test_conv_block(cin, cout, kernel, stride, size):
    rng = np.random.default_rng(cin + kernel)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    mod = JaxConvBlock(cout, kernel, stride)
    params = _np_tree(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ours = ConvBlock(cin, cout, kernel, stride)
    ours.load_state_dict(_sub_state_dict(lambda c: c.conv_block((), ""), params))
    got = _nhwc(ours(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout,stride", [(16, 16, 1), (8, 16, 2), (16, 32, 1)])
def test_residual(cin, cout, stride):
    rng = np.random.default_rng(cin + cout + stride)
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    mod = JaxResidual(cout, stride)
    params = _np_tree(mod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ours = Residual(cin, cout, stride)
    ours.load_state_dict(_sub_state_dict(lambda c: c.residual((), ""), params))
    got = _nhwc(ours(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_same_pads_and_upsample():
    assert same_pads(7, 2, 512) == (2, 3)
    assert same_pads(3, 2, 128) == (0, 1)
    assert same_pads(3, 1, 64) == (1, 1)
    assert same_pads(1, 2, 64) == (0, 0)
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(upsample2x(_nchw(x))),
                                  np.asarray(jax_upsample2x(jnp.asarray(x))))


def _model_pair(jcfg):
    """(flax model, numpy params, port model with the converted params)."""
    jmodel = JaxKGNet(cfg=jcfg.model)
    h = jcfg.data.input_size
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, h, h, 3)),
                                  method=JaxKGNet.init_all)["params"])
    fields = {f.name for f in dataclasses.fields(tcfg.ModelConfig)}
    mcfg = tcfg.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg.model).items()
                               if k in fields})
    tmodel = load_flax_params(build_model(mcfg, seed=None, device="cpu"), params)
    return jmodel, params, tmodel


# tiny_test_config (1 stack) and a 2-stack variant that has the inter-stack
# fuse convs of the default config
CONFIGS = {
    "tiny": jax_tiny_config(),
    "two_stacks": dataclasses.replace(
        jax_tiny_config(), model=dataclasses.replace(
            jax_tiny_config().model, num_stacks=2, base_channels=16,
            head_channels=16, hg_depth=2)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kgnet_forward_and_mask_head(name):
    jcfg = CONFIGS[name]
    jmodel, params, tmodel = _model_pair(jcfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert len(got["stacks"]) == jcfg.model.num_stacks
    for gs, ws in zip(got["stacks"], want["stacks"]):
        assert sorted(gs) == sorted(ws) == ["hm", "reg", "wh"]
        for k in ws:
            assert gs[k].dtype == torch.float32
            np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                       atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["feat"].numpy(), np.asarray(want["feat"]),
                               atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        last = tmodel(torch.from_numpy(x), last_stack_only=True)
    assert len(last["stacks"]) == 1
    for k, v in last["stacks"][0].items():
        assert torch.equal(v, got["stacks"][-1][k])

    r, f = jcfg.model.roi_size, jcfg.model.base_channels
    crops = rng.normal(size=(6, r, r, f)).astype(np.float32)
    want_m = jmodel.apply({"params": params}, jnp.asarray(crops),
                          method=JaxKGNet.apply_mask_head)
    with torch.no_grad():
        got_m = tmodel.apply_mask_head(torch.from_numpy(crops))
    assert got_m.shape == (6, jcfg.model.mask_size, jcfg.model.mask_size)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               atol=ATOL, rtol=RTOL)


def test_converter_is_strict():
    jcfg = CONFIGS["tiny"]
    _, params, _ = _model_pair(jcfg)
    mcfg = tcfg.tiny_test_config().model
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray"):
        flax_to_state_dict(extra, mcfg)
    # batch stats of a norm the GroupNorm model does not have are not consumed
    stats = {"mask_head": {"Norm_9": {"BatchNorm_0": {"mean": np.zeros(3, np.float32)}}}}
    with pytest.raises(ValueError, match="Norm_9"):
        flax_to_state_dict({"params": params, "batch_stats": stats}, mcfg)


def test_random_init_and_plain_switch():
    cfg = tcfg.tiny_test_config()
    a = build_model(cfg.model, seed=3, device="cpu")
    b = build_model(cfg.model, seed=3, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.heads[0].heads["hm"].out.bias == -2.19)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        y0 = a(x)["feat"]
        y1 = a.use_plain_norm(True)(x)["feat"]
    # on the CPU the kernel path is the plain version: identical
    assert torch.equal(y0, y1)
    with pytest.raises(ValueError, match="unknown backbone"):
        KGNet(dataclasses.replace(cfg.model, backbone="vgg"))
