"""GroupNorm(+ReLU) of the PyTorch port against the JAX package.

The port's plain version (`group_norm_relu_reference`, what the wrapper runs
for CPU tensors and what the CUDA kernel is held against on the card) is
compared with the Pallas kernel `fused_group_norm` in interpret mode and
with flax `nn.GroupNorm` (+ReLU), the default JAX path.  Tolerances are the
JAX suite's own for the Pallas kernel (tests/test_pallas.py): 2e-4 in f32
(different summation orders), 0.05 in bf16 (one bf16 ulp at |y| ~ 8).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.ops.pallas.groupnorm import fused_group_norm
from kgtpu_torch.ops import _cuda
from kgtpu_torch.ops import groupnorm as gn

TOL = {"float32": 2e-4, "bfloat16": 0.05}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(2.0, 3.0, size=shape).astype(np.float32)
    scale = rng.normal(1.0, 0.2, size=shape[-1]).astype(np.float32)
    bias = rng.normal(0.0, 0.5, size=shape[-1]).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, relu, dtype):
    xt = torch.from_numpy(x_nhwc).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = gn.group_norm_relu(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                           groups, relu)
    assert y.dtype == xt.dtype
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("channels", [64, 128])
def test_plain_matches_pallas_and_flax(channels, relu, dtype):
    shape = (2, 16, 8, channels)
    x, scale, bias = _inputs(channels + relu, shape)
    groups = gn.num_groups(channels)
    assert groups == 32
    xj = jnp.asarray(x).astype(dtype)
    # the port sees exactly the values JAX sees (bf16-rounded input)
    x_in = np.array(xj.astype(jnp.float32))
    got = _port(x_in, scale, bias, groups, relu, dtype)

    pallas = np.asarray(fused_group_norm(
        xj, jnp.asarray(scale), jnp.asarray(bias), groups, relu=relu,
        interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype], rtol=TOL[dtype])

    mod = fnn.GroupNorm(num_groups=groups, dtype=jnp.dtype(dtype))
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    flax_y = mod.apply(params, xj)
    if relu:
        flax_y = jax.nn.relu(flax_y)
    np.testing.assert_allclose(got, np.asarray(flax_y.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_cpu_tensor_takes_plain_version_without_launch():
    x, scale, bias = _inputs(3, (2, 8, 8, 64))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    before = gn.launches
    y = gn.group_norm_relu(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                           32, True)
    want = gn.group_norm_relu_reference(xt, torch.from_numpy(scale),
                                        torch.from_numpy(bias), 32, True)
    assert torch.equal(y, want)
    assert gn.launches == before


@pytest.mark.parametrize("channels", [1, 3, 16, 48, 64, 96, 128, 100])
def test_num_groups_is_flax_norm_rule(channels):
    want = max(d for d in range(1, min(32, channels) + 1) if channels % d == 0)
    assert gn.num_groups(channels) == want


def test_wrapper_rejects_bad_inputs():
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(TypeError):
        gn.group_norm_relu(torch.zeros(1, 64, 4, 4, dtype=torch.float16), w, b, 32)
    with pytest.raises(ValueError):
        gn.group_norm_relu(torch.zeros(1, 64, 4, 4), w, b, 30)
    with pytest.raises(ValueError):
        gn.group_norm_relu(torch.zeros(1, 4, 4, 64), w, b, 32)
    with pytest.raises(ValueError):
        gn.group_norm_relu(torch.zeros(64, 4, 4), w, b, 32)


def test_build_flags_target_hopper():
    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_training_mode_takes_differentiable_norm_eval_mode_the_wrapper(monkeypatch):
    """The norm follows nn.Module.training: training mode computes the plain
    version (its graph reaches x, weight and bias), eval mode calls the
    kernel's wrapper."""
    from kgtpu_torch.models import blocks

    calls = []
    monkeypatch.setattr(blocks, "group_norm_relu",
                        lambda *a: calls.append(a) or gn.group_norm_relu(*a))
    norm = blocks.GroupNorm(64, relu=True)
    x = torch.randn(2, 64, 4, 4).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    norm.train()
    y = norm(x)
    assert not calls and y.grad_fn is not None
    y.square().sum().backward()
    assert x.grad is not None and norm.weight.grad is not None
    assert norm.bias.grad is not None
    norm.eval()
    with torch.no_grad():
        y_eval = norm(x)
    assert len(calls) == 1
    torch.testing.assert_close(y_eval, y.detach(), rtol=0, atol=0)
