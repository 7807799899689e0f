"""BatchNorm of the PyTorch port (`models.blocks.BatchNorm`, `norm="batch"`)
against flax's `nn.BatchNorm` as kgtpu uses it, on the CPU in f32.

  * the norm alone against `kgtpu.models.blocks.Norm("batch")`: the
    training-mode output and the running stats after one and after three
    training forwards (flax `mutable=["batch_stats"]`), then the eval-mode
    output, with and without the fused ReLU, at 1e-5 abs + rel;
  * whole train steps of a tiny BatchNorm model against
    `kgtpu.train_lib`: the running stats after one step (the backbone's
    from the image forward, the mask head's from the flat ROI forward) at
    1e-5, without and with remat; with remat the stats move once per step,
    so three remat steps equal three plain ones (1e-6: the recomputed
    forward is the same arithmetic);
  * checkpoints: `restore_bundle(use_ema=True)` pairs the EMA parameters
    with the raw running stats, in the port's own checkpoints and through
    `tools/orbax_to_torch.py --use_ema --params_only` on a kgtpu one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu import checkpoint as jckpt
from kgtpu import train_lib as jtrain
from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.data import build_dataset, make_batch
from kgtpu.models import KGNet as JaxKGNet
from kgtpu.models.blocks import Norm as JaxNorm
from kgtpu_torch import checkpoint, train_lib
from kgtpu_torch.convert import flax_to_state_dict, load_flax_params
from kgtpu_torch.models import build_model
from kgtpu_torch.models.blocks import BatchNorm
from test_torch_train import _draws, _np_tree, port_config
from tools.orbax_to_torch import convert

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("relu", [False, True])
def test_batchnorm_matches_flax(relu):
    rng = np.random.default_rng(int(relu))
    xs = [rng.normal(1.5, 2.0, (4, 6, 5, 8)).astype(np.float32) for _ in range(3)]
    mod = JaxNorm("batch")
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), True, relu)
    params = {"params": {"BatchNorm_0": {
        "scale": (1 + rng.normal(0, 0.2, 8)).astype(np.float32),
        "bias": rng.normal(0, 0.3, 8).astype(np.float32)}}}
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    ours = BatchNorm(8, relu=relu)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(params["params"]["BatchNorm_0"]["scale"]))
        ours.bias.copy_(torch.from_numpy(params["params"]["BatchNorm_0"]["bias"]))
    ours.train()
    for i, x in enumerate(xs):
        want, mut = mod.apply({**params, "batch_stats": stats}, jnp.asarray(x), True, relu,
                              mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
        with torch.no_grad():
            got = ours(_nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"train forward {i}")
        for buf, key in ((ours.running_mean, "mean"), (ours.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), stats["BatchNorm_0"][key], atol=TOL,
                                       rtol=TOL, err_msg=f"{key} after {i + 1} forwards")
    ours.eval()
    before = ours.running_var.clone()
    want = mod.apply({**params, "batch_stats": stats}, jnp.asarray(xs[0]), False, relu)
    with torch.no_grad():
        got = ours(_nchw(xs[0])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL, err_msg="eval")
    assert torch.equal(before, ours.running_var)


@functools.cache
def _bn_state():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, norm="batch", base_channels=16,
                                        head_channels=16),
        data=dataclasses.replace(jcfg.data, input_size=64),
        train=dataclasses.replace(jcfg.train, lr_warmup_steps=1))
    state = jtrain.create_train_state(jcfg, jax.random.PRNGKey(0))
    batch = make_batch(build_dataset(jcfg.data), [0, 1], jcfg.data, augment=False,
                       rng=np.random.default_rng(0))
    return jcfg, state, batch


def _bn_setup(remat):
    """The config with `remat`, and the state and batch both share (remat
    keeps kgtpu's param tree as it is)."""
    jcfg, state, batch = _bn_state()
    return dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, remat=remat)), \
        state, batch


def _port_state(cfg, state):
    pstate = train_lib.create_train_state(cfg, device="cpu")
    load_flax_params(pstate.model, _np_tree({"params": state.params,
                                             "batch_stats": state.batch_stats}))
    return pstate


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_running_stats_match_kgtpu(remat):
    """One step: the port's stats equal kgtpu's new batch_stats (backbone
    from the image forward, mask head from the ROI forward), moved once."""
    jcfg, state, batch = _bn_setup(remat)
    cfg = port_config(jcfg)
    assert cfg.model.remat == remat and cfg.model.norm == "batch"
    pstate = _port_state(cfg, state)
    init = {k: v.clone() for k, v in pstate.model.named_buffers()}
    key = jax.random.PRNGKey(5)
    # the jitted step donates its state: hand it a copy of the cached one
    new_state, _ = jax.block_until_ready(jtrain.make_train_step(JaxKGNet(cfg=jcfg.model), jcfg)(
        jax.tree.map(jnp.copy, state), batch, key))
    want = flax_to_state_dict(_np_tree({"params": new_state.params,
                                        "batch_stats": new_state.batch_stats}), cfg.model)
    sel_u, jit_u = _draws(key, jcfg, batch)
    train_lib.train_step(pstate, train_lib.batch_to_device(batch, "cpu"), sel_u, jit_u, cfg)
    names = [n for n, _ in pstate.model.named_buffers()]
    assert any(n.startswith("mask_head.") for n in names)
    for name, buf in pstate.model.named_buffers():
        assert not torch.equal(buf, init[name]), f"{name} did not move"
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_remat_moves_the_stats_once_per_step():
    """Three steps with remat equal three without: losses, parameters and
    running stats (a second update in the recomputation would move every
    backbone stat twice as far)."""
    jcfg, state, batch = _bn_setup(False)
    runs = []
    for remat in (False, True):
        cfg = port_config(jcfg)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))
        pstate = _port_state(cfg, state)
        tb = train_lib.batch_to_device(batch, "cpu")
        losses = []
        for i in range(3):
            sel_u, jit_u = _draws(jax.random.PRNGKey(i), jcfg, batch)
            losses.append(float(train_lib.train_step(pstate, tb, sel_u, jit_u, cfg)["loss"]))
        runs.append((losses, dict(pstate.model.state_dict())))
    (l0, sd0), (l1, sd1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_restore_bundle_pairs_ema_params_with_raw_stats(tmp_path):
    jcfg, state, batch = _bn_setup(False)
    cfg = port_config(jcfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=0.5))
    pstate = train_lib.create_train_state(cfg, device="cpu")
    tb = train_lib.batch_to_device(batch, "cpu")
    for i in range(2):
        sel_u, jit_u = _draws(jax.random.PRNGKey(i), jcfg, batch)
        train_lib.train_step(pstate, tb, sel_u, jit_u, cfg)
    checkpoint.save(str(tmp_path / "w"), 0, pstate,
                    extra={"config_json": checkpoint.encode_config(cfg)})
    sd, _ = checkpoint.restore_bundle(str(tmp_path / "w"), use_ema=True)
    names = [n for n, _ in pstate.model.named_parameters()]
    assert set(sd) == set(pstate.model.state_dict())
    for name, e in zip(names, pstate.ema):
        assert torch.equal(sd[name], e), name
    for name, buf in pstate.model.named_buffers():
        assert torch.equal(sd[name], buf), name
    assert not all(torch.equal(sd[n], p) for n, p in pstate.model.named_parameters())
    model = build_model(cfg.model, seed=None, device="cpu")
    model.load_state_dict(sd, strict=True)

    # a kgtpu BatchNorm checkpoint with EMA, converted for serving
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ema_decay=0.9))
    jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    jstate = jstate.replace(
        ema_params=jax.tree.map(lambda a: np.asarray(a) + np.float32(0.5), jstate.ema_params),
        batch_stats=jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                                 jstate.batch_stats))
    src = str(tmp_path / "orbax")
    jckpt.save(src, epoch=1, state=jstate, extra={"config_json": jckpt.encode_config(jcfg)})
    served = convert(src, str(tmp_path / "serve"), use_ema=True, params_only=True)
    sd, _ = checkpoint.restore_bundle(served, use_ema=True)
    want = flax_to_state_dict(_np_tree({"params": jstate.ema_params,
                                        "batch_stats": jstate.batch_stats}), cfg.model)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    full = convert(src, str(tmp_path / "full"))
    pstate = train_lib.create_train_state(port_config(jcfg), device="cpu")
    checkpoint.restore(full, state=pstate)                   # --resume restores the stats
    for name, buf in pstate.model.named_buffers():
        raw = flax_to_state_dict(_np_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}), cfg.model)
        assert torch.equal(buf, raw[name]), name
