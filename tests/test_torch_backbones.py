"""The port's backbones, norms and prediction feedback against the JAX
package: unet, resnet_fpn, hourglass_fast and the 2-stack hourglass with
inter_inject, each with GroupNorm and with BatchNorm, at base_channels 16,
hg_depth 2 and 64x64 inputs.

The same flax variables (params, and for BatchNorm running stats drawn
away from their init) go through `kgtpu_torch.convert.flax_to_state_dict`,
and both packages run the same numpy images in eval mode and in training
mode (flax `train=True` with `mutable=["batch_stats"]`).  Held: every stack's
head maps and the stride-4 features, and (training, BatchNorm) the running
stats after the forward, at 1e-4 abs + rel in f32 (f32 convolutions summed
in another order; the stats at 1e-5), and in bf16 as a relative error of
each whole map, mean |port - kgtpu| <= 0.05 * mean |kgtpu| (about 3% is
seen): one bf16 convolution of the two packages already differs by one ulp
on ~3e-5 of its outputs (another summation order before the rounding), and
those flips cascade through 20+ layers into isolated entries up to ~0.2 off
at magnitudes ~1 (2% of the entries beyond 0.05 abs + rel), so an
elementwise bound measures the cascade, not the port.  The converter must
consume every flax leaf of each variant.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.models import KGNet as JaxKGNet
from kgtpu_torch import config as tcfg
from kgtpu_torch.convert import flax_to_state_dict
from kgtpu_torch.models import KGNet, build_model
from kgtpu_torch.models.blocks import BatchNorm, GroupNorm

TOL = {"float32": 1e-4, "bfloat16": 0.05}
SIDE = 64
VARIANTS = {"unet": ("unet", False), "resnet_fpn": ("resnet_fpn", False),
            "hourglass_fast": ("hourglass_fast", False),
            "inter_inject": ("hourglass", True)}
CASES = [(v, n) for v in VARIANTS for n in ("group", "batch")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_config(variant, norm, dtype="float32"):
    backbone, inject = VARIANTS[variant]
    base = jax_tiny_config().model
    return dataclasses.replace(base, backbone=backbone, norm=norm, inter_inject=inject,
                               num_stacks=2, base_channels=16, head_channels=16,
                               hg_depth=2, compute_dtype=dtype)


def port_model_config(jmodel_cfg) -> tcfg.ModelConfig:
    return tcfg.ModelConfig(**dataclasses.asdict(jmodel_cfg))


def draw_variables(jmodel_cfg, seed: int) -> dict:
    """Random flax variables of a kgtpu ModelConfig, as numpy, drawn with
    numpy from the shapes of kgtpu's init (`jax.eval_shape`: no compile):
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1),
    BatchNorm running means N(0, 0.2) and variances in [0.5, 1.5] (eval
    mode reads them)."""
    jm = JaxKGNet(cfg=jmodel_cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, SIDE, SIDE, 3)),
                                              method=JaxKGNet.init_all),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            x = rng.normal(0, 1 / np.sqrt(fan_in), a.shape)
        elif name == "scale":
            x = 1 + rng.normal(0, 0.1, a.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, a.shape)
        else:                                   # bias, mean
            x = rng.normal(0, 0.1 if name == "bias" else 0.2, a.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.cache
def flax_variables(variant, norm):
    return draw_variables(model_config(variant, norm), len(variant) + len(norm))


def _port(variant, norm, dtype):
    v = flax_variables(variant, norm)
    model = build_model(port_model_config(model_config(variant, norm, dtype)), seed=None,
                        device="cpu")
    model.load_state_dict(flax_to_state_dict(v, model.cfg), strict=True)
    return model


def _close(got, want, dtype, what):
    t, want = TOL[dtype], np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=t, rtol=t, err_msg=what)
    else:
        err, scale = float(np.abs(got - want).mean()), float(np.abs(want).mean())
        assert err <= t * scale, f"{what}: mean abs err {err}, mean magnitude {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant,norm", CASES)
def test_forward_matches_kgtpu(variant, norm, dtype):
    """Eval mode, then training mode (BatchNorm: batch statistics, and the
    running stats the forward leaves)."""
    jcfg = model_config(variant, norm, dtype)
    jm = JaxKGNet(cfg=jcfg)
    v = flax_variables(variant, norm)
    model = _port(variant, norm, dtype)
    x = np.random.default_rng(3).normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
    n_stacks = jcfg.num_stacks if variant in ("hourglass_fast", "inter_inject") else 1

    for train in (False, True):
        fn = jax.jit(lambda vs, xs: jm.apply(vs, xs, train, mutable=["batch_stats"]))
        # XLA's CPU work runs asynchronously: let it finish before torch's
        # threads start (the two thread pools side by side can crash)
        want, mut = jax.block_until_ready(fn(v, jnp.asarray(x)))
        model.train(train)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        mode = "train" if train else "eval"
        assert len(got["stacks"]) == len(want["stacks"]) == n_stacks
        for s, (gs, ws) in enumerate(zip(got["stacks"], want["stacks"])):
            assert sorted(gs) == sorted(ws) == ["hm", "reg", "wh"]
            for k in ws:
                _close(gs[k].numpy(), ws[k], dtype, f"{mode} stack {s} {k}")
        assert got["feat"].dtype == getattr(torch, dtype)
        _close(got["feat"].float().numpy(), np.asarray(want["feat"], np.float32), dtype,
               f"{mode} feat")
        if norm == "batch" and train:
            stats = flax_to_state_dict({"params": v["params"],
                                        "batch_stats": mut["batch_stats"]}, model.cfg)
            for name, buf in model.named_buffers():
                # the forward runs no mask head: its stats stay as loaded.  In
                # f32 the stats hold at 1e-5; in bf16 they are statistics of
                # activations that differ as the maps do
                if dtype == "float32":
                    np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=1e-5,
                                               rtol=1e-5, err_msg=name)
                else:
                    _close(buf.numpy(), stats[name].numpy(), dtype, name)
        if norm == "batch" and not train:
            # eval mode reads the running stats and leaves them alone
            for name, buf in model.named_buffers():
                assert torch.equal(buf, flax_to_state_dict(v, model.cfg)[name]), name
    if dtype == "float32":
        r, f = jcfg.roi_size, jcfg.base_channels
        crops = np.random.default_rng(4).normal(size=(3, r, r, f)).astype(np.float32)
        want_m = jax.block_until_ready(jax.jit(
            lambda vs, c: jm.apply(vs, c, method=JaxKGNet.apply_mask_head))(v, jnp.asarray(crops)))
        with torch.no_grad():
            got_m = model.eval().apply_mask_head(torch.from_numpy(crops))
        _close(got_m.numpy(), want_m, dtype, "mask head")


@pytest.mark.parametrize("variant,norm", CASES)
def test_converter_is_strict_per_variant(variant, norm):
    """Every flax leaf is consumed (a stray param or stat raises), every
    port tensor is filled, and the port's norms are of the asked kind."""
    v = flax_variables(variant, norm)
    mcfg = port_model_config(model_config(variant, norm))
    sd = flax_to_state_dict(v, mcfg)
    model = KGNet(mcfg)
    assert set(sd) == set(model.state_dict())
    kinds = {type(m) for m in model.modules() if isinstance(m, (GroupNorm, BatchNorm))}
    assert kinds == {GroupNorm if norm == "group" else BatchNorm}
    stray = dict(v, params={**v["params"], "stray": {"kernel": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="stray"):
        flax_to_state_dict(stray, mcfg)
    if norm == "batch":
        stats = {**v["batch_stats"], "stray_bn": {"mean": np.zeros(3, np.float32)}}
        with pytest.raises(ValueError, match="stray_bn"):
            flax_to_state_dict(dict(v, batch_stats=stats), mcfg)
        # a tree without stats (optimizer moments) maps the parameters alone
        params_only = flax_to_state_dict(v["params"], mcfg)
        assert set(params_only) == {n for n, _ in model.named_parameters()}


def test_unknown_backbone_and_norm_raise():
    cfg = tcfg.tiny_test_config().model
    with pytest.raises(ValueError, match="unknown backbone"):
        KGNet(dataclasses.replace(cfg, backbone="vgg"))
    with pytest.raises(ValueError, match="unknown norm"):
        KGNet(dataclasses.replace(cfg, norm="layer"))
