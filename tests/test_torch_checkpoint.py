"""The port's checkpoints (`kgtpu_torch.checkpoint`), `Predictor.from_checkpoint`
and `size_prior_fallback`, and the orbax converter, against kgtpu.

Tolerances: a run saved, restored into a fresh state and trained on equals
the unbroken run to 1e-6 in parameters, optimizer moments and EMA (the same
CPU arithmetic in both, so in practice exactly); directory selection,
pruning, predictions and converted tensors are held exactly.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from kgtpu import checkpoint as jckpt
from kgtpu import train_lib as jtrain
from kgtpu.config import Config as JaxConfig
from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.data.synthetic import SyntheticCells
from kgtpu.predictor import size_prior_fallback as jax_size_prior_fallback
from kgtpu_torch import checkpoint, train_lib
from kgtpu_torch.config import Config, tiny_test_config
from kgtpu_torch.convert import flax_to_state_dict
from kgtpu_torch.models import build_model
from kgtpu_torch.predictor import Predictor, size_prior_fallback
from tools.orbax_to_torch import convert

TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run tiny shapes; with the suite's parallel workers on
    every core, torch's default thread pool per worker oversubscribes the
    machine (a 0.5 s test measured 40-50 s), so each test runs on one
    thread and restores the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    c = tiny_test_config()
    return c.replace(train=dataclasses.replace(c.train, ema_decay=0.9, lr_warmup_steps=2))


def _batch(cfg):
    from kgtpu.data import make_batch
    ds = SyntheticCells(size=cfg.data.input_size, num_images=2, seed=0)
    jd = jax_tiny_config().data
    host = make_batch(ds, [0, 1], jd, augment=False, rng=np.random.default_rng(0))
    return train_lib.batch_to_device(host, "cpu")


def _draws(n_steps, cfg, batch):
    rng = np.random.default_rng(7)
    b, n = batch["valid"].shape
    r = cfg.train.mask_train_rois
    return [(torch.from_numpy(rng.uniform(size=(b, n)).astype(np.float32)),
             torch.from_numpy(rng.uniform(size=(b, r, 4)).astype(np.float32)))
            for _ in range(n_steps)]


def _assert_states_close(a, b):
    for (name, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(y.detach().numpy(), x.detach().numpy(), rtol=0, atol=TOL,
                                   err_msg=name)
    for lst in ("mu", "nu"):
        for x, y in zip(getattr(a.optimizer, lst), getattr(b.optimizer, lst)):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=TOL, err_msg=lst)
    for x, y in zip(a.ema, b.ema):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=TOL, err_msg="ema")
    assert (a.optimizer.count, a.step) == (b.optimizer.count, b.step)


@pytest.mark.parametrize("block", [True, False])
def test_save_restore_train_on_equals_unbroken_run(tmp_path, block):
    cfg = _cfg()
    batch = _batch(cfg)
    draws = _draws(4, cfg, batch)
    whole = train_lib.create_train_state(cfg, seed=0, device="cpu")
    for sel, jit in draws:
        train_lib.train_step(whole, batch, sel, jit, cfg)

    first = train_lib.create_train_state(cfg, seed=0, device="cpu")
    for sel, jit in draws[:2]:
        train_lib.train_step(first, batch, sel, jit, cfg)
    d = str(tmp_path / "weights")
    path = checkpoint.save(d, epoch=1, state=first,
                           extra={"config_json": checkpoint.encode_config(cfg),
                                  "max_gt_box_side_px": np.float32(40.0)}, block=block)
    checkpoint.wait()
    assert os.path.basename(path) == "model_1" and os.listdir(d) == ["model_1"]

    resumed = train_lib.create_train_state(cfg, seed=5, device="cpu")
    out = checkpoint.restore(d, state=resumed)
    assert out["epoch"] == 1 and out["state"] is resumed
    _assert_states_close(first, resumed)
    for sel, jit in draws[2:]:
        train_lib.train_step(resumed, batch, sel, jit, cfg)
    _assert_states_close(whole, resumed)

    payload = checkpoint.restore(d)
    assert payload["extra"]["max_gt_box_side_px"] == 40.0
    assert checkpoint.decode_config(payload["extra"]) == cfg
    assert checkpoint.decode_config({}) is None
    assert int(payload["epoch"]) == 1 and int(payload["step"]) == 2


def _tree(root, epochs, best=None, pins=None):
    os.makedirs(root)
    for e in epochs:
        os.makedirs(os.path.join(root, f"model_{e}"))
    for other in ("model_9.orbax-checkpoint-tmp-1", "model_8.tmp-abc", "logs"):
        os.makedirs(os.path.join(root, other))
    if best is not None:
        with open(os.path.join(root, "best.json"), "w") as f:
            json.dump({"epoch": best, "metric": 0.5}, f)
    if pins is not None:
        with open(os.path.join(root, "pinned.json"), "w") as f:
            json.dump(pins, f)


def _outcome(fn, *args):
    try:
        r = fn(*args)
    except FileNotFoundError:
        return "FileNotFoundError"
    return os.path.basename(r) if isinstance(r, str) else r


@pytest.mark.parametrize("epochs,keep,best,pins", [
    ([1, 10, 2, 3, 7], 2, 3, [1]), ([1, 10, 2, 3, 7], 0, None, None),
    ([5], 1, 5, [5]), ([0, 4, 8, 12, 16, 20], 3, None, [4, 0]), ([], 2, None, None)])
def test_latest_resolve_prune_match_kgtpu(tmp_path, epochs, keep, best, pins):
    """The same run directory in each package's hands: the latest epoch,
    `resolve` of the directory, of <dir>/best and of a model_<epoch> path,
    and `prune(keep_last)` with best.json and pinned.json epochs spared."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    for root in (ours, theirs):
        _tree(root, epochs, best, pins)
    for fn_name in ("latest_path", "resolve"):
        assert (_outcome(getattr(checkpoint, fn_name), ours)
                == _outcome(getattr(jckpt, fn_name), theirs))
    assert (_outcome(checkpoint.resolve, os.path.join(ours, "best"))
            == _outcome(jckpt.resolve, os.path.join(theirs, "best")))
    assert (_outcome(checkpoint.resolve, os.path.join(ours, "model_3"))
            == _outcome(jckpt.resolve, os.path.join(theirs, "model_3")) == "model_3")
    got = sorted(os.path.basename(p) for p in checkpoint.prune(ours, keep))
    want = sorted(os.path.basename(p) for p in jckpt.prune(theirs, keep))
    assert got == want
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))


def test_params_only_checkpoint_and_init_params_from(tmp_path):
    cfg = _cfg()
    trained = train_lib.create_train_state(cfg, seed=3, device="cpu")
    with torch.no_grad():
        for p in trained.model.parameters():
            p.add_(0.5)
    sd = {k: v.clone() for k, v in trained.model.state_dict().items()}
    ema = {k: v + 1.0 for k, v in sd.items()}
    d = str(tmp_path / "w")
    checkpoint.write_payload(d, 4, {"params": sd, "ema": ema}, {"train_input_size": 128})
    assert checkpoint.restore_extra(d) == {"train_input_size": 128}
    for use_ema, want in ((False, sd), (True, ema)):
        got = checkpoint.restore_params(d, use_ema=use_ema)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="params-only"):
        checkpoint.restore(d, state=train_lib.create_train_state(cfg, device="cpu"))

    fresh = train_lib.create_train_state(cfg, seed=0, device="cpu")
    checkpoint.init_params_from(fresh, d, use_ema=True)
    for (k, p), e in zip(fresh.model.named_parameters(), fresh.ema):
        assert torch.equal(p, ema[k]) and torch.equal(e, ema[k])
    assert fresh.optimizer.count == 0 and fresh.step == 0
    assert all(float(m.abs().max()) == 0 for m in fresh.optimizer.mu)
    other = cfg.replace(model=dataclasses.replace(cfg.model, base_channels=16))
    with pytest.raises(SystemExit, match="does not match"):
        checkpoint.init_params_from(train_lib.create_train_state(other, device="cpu"), d)


def test_from_checkpoint_equals_constructor(tmp_path):
    cfg = tiny_test_config()
    cfg = cfg.replace(group=dataclasses.replace(
        cfg.group, kp_score_thresh=0.05, center_thresh=0.05, score_thresh=0.02,
        center_tol=1.0, size_prune=10.0))
    sd = build_model(cfg.model, seed=0, device="cpu").state_dict()
    ema = build_model(cfg.model, seed=1, device="cpu").state_dict()
    d = str(tmp_path / "w")
    checkpoint.write_payload(d, 0, {"params": sd, "ema": ema},
                             {"config_json": checkpoint.encode_config(cfg)})
    img = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    stored = dataclasses.replace(Config(), model=cfg.model)
    cases = [(Predictor.from_checkpoint(d, device="cpu"), Predictor(stored, sd, device="cpu")),
             (Predictor.from_checkpoint(d, cfg=cfg, use_ema=True, device="cpu"),
              Predictor(cfg, ema, device="cpu"))]
    for got, want in cases:
        assert got.cfg == want.cfg
        a, b = got.predict(img), want.predict(img)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert cases[1][0].predict(img)["num_instances"] >= 1


@pytest.mark.parametrize("size_prune,wh_head,max_box,extra", [
    (0.0, True, 1e9, {"max_gt_box_side_px": 279.0, "train_input_size": 512.0}),
    (3.0, False, 1e9, {"max_gt_box_side_px": 100.0, "train_input_size": 1024.0}),
    (3.0, True, 1e9, {"max_gt_box_side_px": 279.0, "train_input_size": 512.0}),
    (0.0, True, 20.0, {"max_gt_box_side_px": 279.0, "train_input_size": 512.0}),
    (0.0, True, 1e9, {}), (0.0, False, 1e9, {"max_gt_box_side_px": 50.0})])
def test_size_prior_fallback_matches_kgtpu(size_prune, wh_head, max_box, extra):
    def build(cls):
        c = cls()
        return c.replace(
            model=dataclasses.replace(c.model, use_wh_head=wh_head),
            group=dataclasses.replace(c.group, size_prune=size_prune, max_box_size=max_box),
            infer=dataclasses.replace(c.infer, input_size=384))
    got = size_prior_fallback(build(Config), extra)
    want = jax_size_prior_fallback(build(JaxConfig), {k: np.float32(v) for k, v in extra.items()})
    assert got.group.max_box_size == pytest.approx(float(want.group.max_box_size), rel=1e-6)


def _perturbed_kgtpu_state():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ema_decay=0.9))
    state = jtrain.create_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def bump(x):
        x = np.asarray(x)
        return (x + rng.normal(size=x.shape).astype(x.dtype)
                if np.issubdtype(x.dtype, np.floating) else x + 5)
    return jcfg, state.replace(params=jax.tree.map(bump, state.params),
                               ema_params=jax.tree.map(bump, state.ema_params),
                               opt_state=jax.tree.map(bump, state.opt_state), step=7)


def test_orbax_converter_matches_flax_to_state_dict(tmp_path):
    """tools/orbax_to_torch.py on a tiny kgtpu checkpoint: every tensor equals
    `flax_to_state_dict` of what kgtpu restores, exactly; the port resumes
    from the whole state."""
    jcfg, state = _perturbed_kgtpu_state()
    src = str(tmp_path / "orbax")
    jckpt.save(src, epoch=3, state=state,
               extra={"config_json": jckpt.encode_config(jcfg),
                      "max_gt_box_side_px": np.float32(40.0),
                      "train_input_size": np.float32(128.0)})
    raw = jckpt._restore_numpy(jckpt.resolve(src))
    params, ema_params, adam = raw["params"], raw["ema_params"], raw["opt_state"][1][0]

    def same(got, tree):
        want = flax_to_state_dict(tree, jcfg.model)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    full = convert(src, str(tmp_path / "full"))
    payload = checkpoint.restore(full)
    same(payload["params"], params)
    same(payload["ema"], ema_params)
    same(payload["opt"]["mu"], adam["mu"])
    same(payload["opt"]["nu"], adam["nu"])
    assert int(payload["opt"]["count"]) == int(adam["count"])
    assert (int(payload["step"]), int(payload["epoch"])) == (7, 3)
    assert payload["extra"]["max_gt_box_side_px"] == 40.0
    assert payload["extra"]["train_input_size"] == 128.0
    cfg = checkpoint.decode_config(payload["extra"])
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    assert cfg.train.ema_decay == 0.9

    port = train_lib.create_train_state(cfg, device="cpu")
    checkpoint.restore(full, state=port)
    assert port.step == 7 and port.optimizer.count == int(adam["count"])

    served = convert(src, str(tmp_path / "serve"), use_ema=True, params_only=True)
    assert os.path.basename(served) == "model_3"
    sd, _ = checkpoint.restore_bundle(str(tmp_path / "serve"))
    same(sd, ema_params)
    assert sorted(checkpoint.restore(served)) == ["epoch", "extra", "params"]
    with pytest.raises(SystemExit, match="--params_only"):
        convert(src, str(tmp_path / "bad"), use_ema=True)
