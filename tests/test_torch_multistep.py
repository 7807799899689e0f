"""The port's multi-step dispatch (`train_lib.make_train_multi_step`,
`cli.train --steps_per_dispatch`) on the CPU at tiny sizes (tiny_test_config
at 64x64).

  * against kgtpu's `make_train_multi_step` (tests/test_train.py's
    test_multi_step_dispatch_matches_single_steps): 3 steps in one call from
    the same converted weights, EMA 0.9, the draws kgtpu's loss_fn takes
    from fold_in(rng, 7 + j); losses within rtol 1e-5, params and EMA within
    rtol 1e-5 and atol 1e-6 (kgtpu's own tolerance between its multi-step
    and its single steps: the two packages' f32 sums differ in order);
  * the port's k-step call exactly equal to k single steps (the same step
    body with the same scalars; the CPU runs them one after another), also
    with BatchNorm's running stats;
  * `cli.train --steps_per_dispatch 2` over 3 steps an epoch (one dispatch
    and a one-step tail), 2 epochs and a resumed third: metrics.jsonl's
    losses and the checkpoints' tensors exactly those of the
    --steps_per_dispatch 1 run.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from kgtpu import train_lib as jtrain
from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.data import build_dataset, make_batch
from kgtpu.models import KGNet as JaxKGNet
from kgtpu_torch import checkpoint, train_lib
from kgtpu_torch import config as tconfig
from kgtpu_torch.cli import train as train_cli
from kgtpu_torch.convert import flax_to_state_dict, load_flax_params
from test_torch_train import _draws, _np_tree, port_config

K = 3
SIDE = 64
TINY_FLAGS = ["--backbone", "hourglass_lite", "--num_stacks", "1", "--roi_size", "8",
              "--mask_size", "16", "--K", "32", "--max_detections", "32"]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: tiny shapes, and XLA's CPU pool beside torch's
    OpenMP pool has crashed a process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(jcfg, k):
    ds = build_dataset(jcfg.data)
    nprng = np.random.default_rng(0)
    return [make_batch(ds, [2 * j, 2 * j + 1], jcfg.data, augment=False, rng=nprng)
            for j in range(k)]


def _jcfg(**model):
    c = jax_tiny_config()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, **model),
        data=dataclasses.replace(c.data, input_size=SIDE),
        train=dataclasses.replace(c.train, lr_warmup_steps=1, ema_decay=0.9))


def test_multi_step_matches_kgtpu():
    jcfg = _jcfg()
    state = jtrain.create_train_state(jcfg, jax.random.PRNGKey(0))
    p0 = _np_tree(state.params)
    batches = _batches(jcfg, K)
    stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    rng = jax.random.PRNGKey(0)
    multi = jtrain.make_train_multi_step(JaxKGNet(cfg=jcfg.model), jcfg, K)
    # kgtpu's results are awaited before torch computes (the two CPU pools
    # side by side have crashed a process)
    s_multi, ms = jax.block_until_ready(
        multi(state, stacked, rng, np.arange(7, 7 + K, dtype=np.int32)))
    want_loss = np.asarray(ms["loss"])
    want = flax_to_state_dict(_np_tree(s_multi.params), port_config(jcfg).model)
    want_ema = flax_to_state_dict(_np_tree(s_multi.ema_params), port_config(jcfg).model)

    cfg = port_config(jcfg)
    pstate = train_lib.create_train_state(cfg, device="cpu")
    load_flax_params(pstate.model, p0)
    pstate.ema = [p.detach().clone() for p in pstate.model.parameters()]
    draws = [_draws(jax.random.fold_in(rng, 7 + j), jcfg, batches[j]) for j in range(K)]
    got = train_lib.make_train_multi_step(cfg, K)(
        pstate, stacked, torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]))

    assert got["loss"].shape == (K,)
    np.testing.assert_allclose(got["loss"].numpy(), want_loss, rtol=1e-5)
    assert pstate.step == pstate.optimizer.count == K
    for i, (name, p) in enumerate(pstate.model.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(pstate.ema[i].numpy(), want_ema[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_multi_step_equals_single_steps(norm):
    """k bodies in one call and k `train_step` calls from one state: every
    metric, parameter, moment, EMA entry and buffer bitwise equal."""
    jcfg = _jcfg(norm=norm)
    cfg = port_config(jcfg)
    batches = _batches(jcfg, K)
    stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    gens = [torch.Generator().manual_seed(100 + j) for j in range(K)]
    draws = [train_lib.step_draws(cfg, g, 2, batches[0]["valid"].shape[1], torch.device("cpu"))
             for g in gens]

    single = train_lib.create_train_state(cfg, seed=3, device="cpu")
    want = [train_lib.train_step(single, train_lib.batch_to_device(b, "cpu"), *d, cfg)
            for b, d in zip(batches, draws)]
    multi = train_lib.create_train_state(cfg, seed=3, device="cpu")
    got = train_lib.make_train_multi_step(cfg, K)(
        multi, stacked, torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]))

    assert set(got) == set(want[0])
    for key in got:
        assert torch.equal(got[key], torch.stack([m[key] for m in want])), key
    assert (multi.step, multi.optimizer.count) == (single.step, single.optimizer.count) == (K, K)
    for a, b in zip(train_lib._state_tensors(multi), train_lib._state_tensors(single)):
        assert torch.equal(a, b)
    if norm == "batch":
        assert any(not torch.equal(b, torch.zeros_like(b)) for b in multi.model.buffers())


@pytest.fixture(scope="module")
def tiny_json(tmp_path_factory):
    c = tconfig.tiny_test_config()
    c = c.replace(data=dataclasses.replace(c.data, max_instances=12),
                  train=dataclasses.replace(c.train, lr_warmup_steps=20, ema_decay=0.9))
    path = str(tmp_path_factory.mktemp("cfg") / "tiny.json")
    with open(path, "w") as f:
        f.write(tconfig.config_to_json(c))
    return path


def _cli(tiny_json, save_dir, k, *extra):
    return train_cli.run(
        ["--config", tiny_json, "--dataset", "synthetic", "--synthetic_n", "8",
         "--input_size", str(SIDE), "--batch_size", "2", "--steps_per_epoch", "3",
         "--save_dir", str(save_dir), "--device", "cpu", "--rss_limit_gb", "0",
         "--steps_per_dispatch", str(k)] + TINY_FLAGS + list(extra))


def _losses(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("img_per_sec", "host_rss_gb")}
            for r in rows]


def test_cli_steps_per_dispatch_equals_single_steps(tiny_json, tmp_path):
    """Two epochs of one dispatch and a tail, then one resumed epoch."""
    runs = {}
    for k in (1, 2):
        save = tmp_path / f"k{k}"
        first = _cli(tiny_json, save, k, "--num_epochs", "2")
        resumed = _cli(tiny_json, save, k, "--num_epochs", "3", "--resume")
        assert (first["end_step"], resumed["start_step"], resumed["end_step"]) == (6, 6, 9)
        runs[k] = save
    assert _losses(runs[1]) == _losses(runs[2])
    assert len(_losses(runs[2])) == 3
    for epoch in (1, 2):
        a = checkpoint.restore(os.path.join(runs[1], f"model_{epoch}"))
        b = checkpoint.restore(os.path.join(runs[2], f"model_{epoch}"))
        # the stored configs differ in save_dir alone
        ea, eb = a.pop("extra"), b.pop("extra")
        ca, cb = (json.loads(e.pop("config_json")) for e in (ea, eb))
        assert ca["train"].pop("save_dir") != cb["train"].pop("save_dir")
        assert ea == eb and ca == cb
        flat_a, flat_b = _flatten(a), _flatten(b)
        assert flat_a.keys() == flat_b.keys()
        for name in flat_a:
            assert torch.equal(flat_a[name], flat_b[name]), (epoch, name)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
