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


def test_traced_calls_are_one_op_node_eager_calls_skip_the_dispatch(monkeypatch):
    """A traced call records the op `kgtpu_torch::group_norm_relu` (what an
    exported program holds), with real or fake tensors; an eager call runs
    its implementation without the op's dispatch, with the same result."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, scale, bias = _inputs(4, (2, 8, 8, 64))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    for mode in ("real", "fake"):
        graph = make_fx(lambda t, s, o: gn.group_norm_relu(t, s, o, 32, True),
                        tracing_mode=mode)(xt, w, b).graph
        targets = [n.target for n in graph.nodes if n.op == "call_function"]
        assert targets == [torch.ops.kgtpu_torch.group_norm_relu.default], mode
    # the op holds the implementation it was registered with; the eager path
    # looks the module's function up at each call
    direct, impl = [], gn._group_norm_relu_cpu
    monkeypatch.setattr(gn, "_group_norm_relu_cpu",
                        lambda *a: direct.append(1) or impl(*a))
    y = gn.group_norm_relu(xt, w, b, 32, True)
    assert direct == [1]
    assert torch.equal(y, torch.ops.kgtpu_torch.group_norm_relu(xt, w, b, 32, True))
    assert direct == [1]


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


# The main-path norms at 512x512 (B x C x H x W; the mask head sees
# batch x mask_chunk crops) and odd shapes: an H*W no part size divides,
# C = 48 (G = 24), C = 100 (vec = 1 in bf16), a sample larger than all
# resident blocks' shared memory together.
_LEVELS = [(64, 256, 256), (128, 128, 128), (128, 64, 64), (128, 32, 32),
           (128, 16, 16), (128, 8, 8)]
_PLAN_CASES = ([(b, *lvl, 2, 8) for b in (1, 8, 32) for lvl in _LEVELS]
               + [(32 * 32, 64, 32, 32, 2, 8), (8, 64, 256, 256, 4, 4),
                  (3, 128, 37, 41, 2, 8), (5, 48, 60, 70, 2, 8),
                  (2, 100, 20, 30, 2, 1), (2, 100, 20, 30, 4, 1),
                  (1, 64, 512, 512, 2, 8), (4, 64, 1024, 1024, 2, 8)])


@pytest.mark.parametrize("capacity", [264, 132])
@pytest.mark.parametrize("b,c,h,w,itemsize,vec", _PLAN_CASES)
def test_launch_plan(b, c, h, w, itemsize, vec, capacity):
    """The GroupNorm kernel's launch plan: parts cover a sample's rows with
    none empty, a slab fits its shared memory, the persistent grid is a
    multiple of the parts and fits the card, no sample straddles two rounds
    of the walk, and x is read once wherever a sample fits the resident
    blocks' shared memory."""
    hw, groups = h * w, gn.num_groups(c)
    p = gn.launch_plan(b, hw, c, groups, itemsize, vec, capacity)
    row = c * itemsize
    assert p.parts * p.rows_per_block >= hw > (p.parts - 1) * p.rows_per_block
    assert p.slab_rows * p.chunks >= p.rows_per_block
    assert p.slab_bytes % 16 == 0 and p.slab_bytes >= p.slab_rows * row
    assert p.smem == gn.SLOTS * p.slab_bytes + gn.scratch_bytes(c, groups, vec)
    assert p.smem <= gn.SMEM_PER_BLOCK
    assert p.grid % p.parts == 0 and p.parts <= p.grid <= min(capacity, b * p.parts)
    assert p.rounds == -(-b * p.parts // p.grid)
    rounds_of = {}
    for item in range(b * p.parts):
        rounds_of.setdefault(item // p.parts, set()).add(item // p.grid)
    assert all(len(r) == 1 for r in rounds_of.values())
    assert p.workspace == b * p.parts * (-(-2 * groups // 4) * 4)
    max_rows = (gn.SMEM_PER_BLOCK - gn.scratch_bytes(c, groups, vec) - 15 * gn.SLOTS) // (
        gn.SLOTS * row)
    assert (p.chunks == 1) == (hw <= capacity * max_rows)
    main_path = (c, h, w) in _LEVELS or (b, c, h, w) == (32 * 32, 64, 32, 32)
    if main_path and itemsize == 2 and capacity == 264:
        assert p.chunks == 1     # bf16 at two blocks per H100 SM: x is read once


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        gn.launch_plan(2, 64, 300, 30, 2, 1, 264)     # 300 vectors > 256 threads
    with pytest.raises(ValueError):
        gn.launch_plan(2, 64, 128, 32, 2, 8, 0)       # nothing fits the card
    with pytest.raises(ValueError):
        gn.launch_plan(2, 64, 129, 129, 2, 1, 264)    # 2G + 2 sums > the scratch's 2C


def test_kernel_constants_match_wrapper():
    """The wrappers' copies of the kernels' compile-time constants."""
    import re
    from pathlib import Path

    from kgtpu_torch.ops import gaussian

    src = Path(_cuda.CSRC)
    gn_src = (src / "groupnorm.cu").read_text()
    assert int(re.search(r"kThreads = (\d+);", gn_src).group(1)) == gn.THREADS
    assert int(re.search(r"kSlots = (\d+);", gn_src).group(1)) == gn.SLOTS
    g_src = (src / "gaussian.cu").read_text()
    assert int(re.search(r"kTileH = (\d+);", g_src).group(1)) == gaussian.TILE_H
    assert int(re.search(r"kTileW = (\d+);", g_src).group(1)) == gaussian.TILE_W
    assert float(re.search(r"kCutoff = ([\d.]+)f;", g_src).group(1)) == gaussian.CUTOFF


def test_workspace_banks_take_turns():
    """The wrapper's workspace: successive calls on one stream count in the
    two banks of arrival counters by turns (the kernel zeroes the bank the
    next call counts in), and a call that needs more grows it with zeroed
    counters."""
    dev = torch.device("cpu")
    stream = 12345
    gn._work.pop((dev.index, stream), None)
    try:
        banks = [gn._workspace(dev, stream, 64, 4)[2] for _ in range(4)]
        assert banks == [0, 1, 0, 1]
        partial, counters, _ = gn._workspace(dev, stream, 32, 2)
        assert partial.numel() == 64 and counters.shape == (2, 4)
        counters.fill_(7)                      # as if a call had counted
        partial, counters, bank = gn._workspace(dev, stream, 128, 8)
        assert partial.numel() == 128 and counters.shape == (2, 8)
        assert bank == 0 and not counters.any()
    finally:
        gn._work.pop((dev.index, stream), None)
