"""The port's train step (`kgtpu_torch.train_lib`, `kgtpu_torch.losses`)
against `kgtpu.train_lib` and `kgtpu.losses`, on the CPU in f32.

Both packages get the same numpy inputs, the same params (flax params
converted with `kgtpu_torch.convert`) and the same random draws (taken from
`jax.random` with the key split as `kgtpu/train_lib.py::loss_fn` splits it).
Tolerances, each with its reason:
  * losses and loss_fn metrics: rtol 1e-5 for a single loss on the same
    inputs, 1e-4 for loss_fn (f32 convolutions summed in another order by
    XLA and by PyTorch, through a whole network);
  * gradients: rtol 1e-3 with atol 1e-6 * max|g| over the whole gradient
    tree (the backward pass sums in yet other orders, and small entries
    cancel: a tensor's own small entries differ by up to ~7e-6 of its max);
  * the other backbones, norms, prediction feedback and remat (unet,
    resnet_fpn, hourglass_fast with remat, inter_inject, BatchNorm):
    loss_fn's metrics and every gradient of one step, at the same
    tolerances, both packages in f64; the unet also in f32, each gradient
    at 1e-4 of its own max (see the test);
  * optimizer: params within 1e-6 after 5 steps on identical gradients
    (f32 rounding of the same arithmetic);
  * schedule values: rel 1e-6 (both compute in f32);
  * EMA: each package's EMA against the rule on its own params at 1e-6;
  * _jitter_boxes: 1e-6 abs + rel on the same noise; ROI selection: exact
    indices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgtpu import losses as jlosses
from kgtpu import train_lib as jtrain
from kgtpu.config import tiny_test_config as jax_tiny_config
from kgtpu.data import build_dataset, make_batch
from kgtpu.models import KGNet as JaxKGNet
from kgtpu_torch import config as tcfg
from kgtpu_torch import losses, train_lib
from kgtpu_torch.convert import flax_to_state_dict, load_flax_params
from kgtpu_torch.models import build_model


def port_config(jcfg) -> tcfg.Config:
    """The port's Config with the same values as a kgtpu Config."""
    def section(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})
    return tcfg.Config(model=section(tcfg.ModelConfig, jcfg.model),
                       data=section(tcfg.DataConfig, jcfg.data),
                       group=section(tcfg.GroupConfig, jcfg.group),
                       train=section(tcfg.TrainConfig, jcfg.train),
                       infer=section(tcfg.InferConfig, jcfg.infer))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _setup(seed=0, **train):
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, lr_warmup_steps=1, **train))
    state = jtrain.create_train_state(jcfg, jax.random.PRNGKey(seed))
    ds = build_dataset(jcfg.data)
    batch = make_batch(ds, [0, 1], jcfg.data, augment=False,
                       rng=np.random.default_rng(0))
    return jcfg, state, batch


def _port_model(cfg, params):
    model = build_model(cfg.model, seed=None, device="cpu")
    return load_flax_params(model, _np_tree(params)).train()


def _draws(rng, jcfg, batch):
    """The two uniforms jax's loss_fn draws from `rng`, as numpy."""
    rng_sel, rng_jit = jax.random.split(rng)
    b, n = batch["valid"].shape
    sel_u = np.asarray(jax.random.uniform(rng_sel, (b, n)))
    jit_u = np.asarray(jax.random.uniform(rng_jit, (b, jcfg.train.mask_train_rois, 4)))
    return torch.from_numpy(sel_u), torch.from_numpy(jit_u)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def test_focal_loss_matches_kgtpu():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (2, 16, 16, 5)).astype(np.float32)
    t = rng.uniform(0, 0.99, (2, 16, 16, 5)).astype(np.float32)
    t[0, 3, 4, 1] = t[1, 7, 2, 4] = t[1, 0, 0, 0] = 1.0
    want = float(jlosses.focal_loss(jnp.asarray(logits), jnp.asarray(t), 2.0, 4.0))
    got = float(losses.focal_loss(torch.from_numpy(logits), torch.from_numpy(t), 2.0, 4.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _kpt_inputs(seed, h=16, w=16, n=6):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 3, (2, h, w, 2)).astype(np.float32)
    x0 = rng.uniform(-2, w - 2, (2, n))
    y0 = rng.uniform(-2, h - 2, (2, n))
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.5, 8, (2, n)),
                      y0 + rng.uniform(0.5, 8, (2, n))], -1).astype(np.float32)
    valid = (rng.uniform(size=(2, n)) > 0.3).astype(np.float32)
    return pred, boxes, valid


def test_offset_and_wh_losses_match_kgtpu():
    pred, boxes, valid = _kpt_inputs(1)
    kpts = np.asarray(jax.vmap(lambda b: jnp.stack(
        [b[:, [0, 2, 0, 2]], b[:, [1, 1, 3, 3]]], -1))(jnp.asarray(boxes)))
    want = np.asarray(jax.vmap(jlosses.offset_loss)(
        jnp.asarray(pred), jnp.asarray(kpts), jnp.asarray(valid)))
    got = losses.offset_loss(torch.from_numpy(pred), torch.from_numpy(kpts),
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = np.asarray(jax.vmap(jlosses.wh_loss)(
        jnp.asarray(pred), jnp.asarray(boxes), jnp.asarray(valid)))
    got = losses.wh_loss(torch.from_numpy(pred), torch.from_numpy(boxes),
                         torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gather_at_matches_kgtpu():
    pred, boxes, _ = _kpt_inputs(2)
    xy = np.floor(boxes[..., :2]).astype(np.float32)
    want = np.asarray(jax.vmap(jlosses._gather_at)(jnp.asarray(pred), jnp.asarray(xy)))
    got = losses.gather_at(torch.from_numpy(pred), torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, want)


def test_mask_loss_matches_kgtpu():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 4, 16, 16)).astype(np.float32)
    t = (rng.uniform(size=(2, 4, 16, 16)) > 0.6).astype(np.float32)
    valid = np.array([[1, 1, 0, 1], [0, 0, 0, 0]], np.float32)
    want = np.asarray(jax.vmap(jlosses.mask_loss)(
        jnp.asarray(logits), jnp.asarray(t), jnp.asarray(valid)))
    got = losses.mask_loss(torch.from_numpy(logits), torch.from_numpy(t),
                           torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --------------------------------------------------------------------------
# ROI sampling
# --------------------------------------------------------------------------

def test_jitter_boxes_matches_kgtpu():
    rng = np.random.default_rng(4)
    x0 = rng.uniform(0, 100, (2, 5))
    boxes = np.stack([x0, x0 + 3, x0 + rng.uniform(0.5, 30, (2, 5)),
                      x0 + 40], -1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jtrain._jitter_boxes(jnp.asarray(boxes), None, key, 0.1))
    u = np.asarray(jax.random.uniform(key, boxes.shape))
    got = train_lib._jitter_boxes(torch.from_numpy(boxes), torch.from_numpy(u), 0.1)
    # 1e-6 abs + rel: XLA fuses boxes + noise * wh into one FMA, torch
    # rounds twice, and one f32 ulp at 100 px is 7.6e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 2, 4, 7])
def test_roi_selection_matches_top_k(n_valid):
    """Fewer valid instances than r: the zero keys tie, and top_k takes them
    by ascending index."""
    r, n = 5, 9
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(n_valid), (3, n)))
    valid = np.zeros((3, n), np.float32)
    valid[0, :n_valid] = 1
    valid[1, n - n_valid:] = 1
    valid[2, ::2][:n_valid] = 1
    _, want = jax.lax.top_k(jnp.asarray(u * valid), r)
    got = train_lib.select_rois(torch.from_numpy(u), torch.from_numpy(valid), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

def test_loss_fn_metrics_match_kgtpu():
    jcfg, state, batch = _setup()
    rng = jax.random.PRNGKey(7)
    _, (want, _) = jtrain.loss_fn(state.params, batch, rng, JaxKGNet(cfg=jcfg.model),
                                  jcfg, state.batch_stats)
    cfg = port_config(jcfg)
    model = _port_model(cfg, state.params)
    sel_u, jit_u = _draws(rng, jcfg, batch)
    _, got = train_lib.loss_fn(model, train_lib.batch_to_device(batch, "cpu"),
                               sel_u, jit_u, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def test_gradients_match_kgtpu():
    jcfg, state, batch = _setup(seed=1)
    rng = jax.random.PRNGKey(11)
    jmodel = JaxKGNet(cfg=jcfg.model)
    jgrads = jax.grad(lambda p: jtrain.loss_fn(p, batch, rng, jmodel, jcfg, None)[0])(
        state.params)
    cfg = port_config(jcfg)
    want = flax_to_state_dict(_np_tree(jgrads), cfg.model)
    model = _port_model(cfg, state.params)
    sel_u, jit_u = _draws(rng, jcfg, batch)
    total, _ = train_lib.loss_fn(model, train_lib.batch_to_device(batch, "cpu"),
                                 sel_u, jit_u, cfg)
    total.backward()
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-6 * gmax, err_msg=name)


# --------------------------------------------------------------------------
# optimizer, schedule, EMA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,clip,wd", [
    ("constant", 5.0, 0.0), ("constant", 0.05, 0.0),      # clip idle / triggered
    ("cosine", 5.0, 0.0), ("cosine", 0.05, 1e-2),
    ("constant", 0.05, 1e-2)])
def test_optimizer_matches_optax(schedule, clip, wd):
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=1e-2, lr_schedule=schedule, lr_warmup_steps=2, num_epochs=2,
        steps_per_epoch=3, grad_clip_norm=clip, weight_decay=wd))
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    tx = jtrain.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = train_lib.Optimizer(tp, port_config(jcfg))
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([torch.from_numpy(g[k].copy()) for k in ("a", "b")])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
    for k, t in zip(("a", "b"), tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_schedule_matches_optax(schedule):
    warmup, total = 10, 40
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=3e-4, lr_schedule=schedule, lr_warmup_steps=warmup,
        num_epochs=4, steps_per_epoch=10))
    # the schedule optax sees: the learning-rate scale of a unit update
    tx = jtrain.make_optimizer(jcfg)
    sched = train_lib.lr_schedule(port_config(jcfg))
    want_fn = (optax.warmup_cosine_decay_schedule(0.05 * 3e-4, 3e-4, warmup, total, 3e-6)
               if schedule == "cosine" else
               optax.warmup_constant_schedule(0.05 * 3e-4, 3e-4, warmup))
    assert tx is not None
    for step in (0, 1, warmup - 1, warmup, (warmup + total) // 2, total, total + 5):
        np.testing.assert_allclose(sched(step), float(want_fn(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def _ema_of(trajectory, decay):
    """The EMA rule, e <- e * d_t + p * (1 - d_t) with d_t = min(decay,
    (1 + t) / (10 + t)) and t the step count after the update, over a list
    of per-step param arrays (trajectory[0] = the initial params)."""
    e = trajectory[0].astype(np.float32)
    for t, p in enumerate(trajectory[1:], start=1):
        d = np.float32(min(decay, (1.0 + t) / (10.0 + t)))
        e = e * d + p * (np.float32(1) - d)
    return e


def test_ema_matches_kgtpu():
    """Three steps with ema_decay 0.999 in both packages.  Each package's EMA
    must equal the rule applied to its own param trajectory: Adam's first
    steps move a param by about +-lr whatever its gradient's size, so a
    near-zero gradient entry that differs in sign between the packages
    moves the params (not the EMA rule) apart."""
    jcfg, state, batch = _setup(ema_decay=0.999)
    jstep = jtrain.make_train_step(JaxKGNet(cfg=jcfg.model), jcfg)
    cfg = port_config(jcfg)
    pstate = train_lib.create_train_state(cfg, device="cpu")
    load_flax_params(pstate.model, _np_tree(state.params))
    pstate.ema = [p.detach().clone() for p in pstate.model.parameters()]
    tb = train_lib.batch_to_device(batch, "cpu")
    names = [n for n, _ in pstate.model.named_parameters()]
    jtraj = [flax_to_state_dict(_np_tree(state.params), cfg.model)]
    ptraj = [[p.detach().numpy().copy() for p in pstate.model.parameters()]]
    rng = jax.random.PRNGKey(3)
    for i in range(3):
        key = jax.random.fold_in(rng, i)
        state, _ = jstep(state, batch, key)
        jtraj.append(flax_to_state_dict(_np_tree(state.params), cfg.model))
        sel_u, jit_u = _draws(key, jcfg, batch)
        train_lib.train_step(pstate, tb, sel_u, jit_u, cfg)
        ptraj.append([p.detach().numpy().copy() for p in pstate.model.parameters()])
    assert pstate.step == 3
    jema = flax_to_state_dict(_np_tree(state.ema_params), cfg.model)
    for i, name in enumerate(names):
        np.testing.assert_allclose(
            jema[name].numpy(), _ema_of([t[name].numpy() for t in jtraj], 0.999),
            rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(
            pstate.ema[i].numpy(), _ema_of([t[i] for t in ptraj], 0.999),
            rtol=1e-6, atol=1e-7, err_msg=name)
        # and the two EMAs agree within Adam's +-lr per step
        np.testing.assert_allclose(pstate.ema[i].numpy(), jema[name].numpy(),
                                   rtol=0, atol=2 * 3 * jcfg.train.lr, err_msg=name)


# --------------------------------------------------------------------------
# whole steps
# --------------------------------------------------------------------------

def test_loss_decreases_over_steps():
    jcfg, state, batch = _setup()
    cfg = port_config(jcfg)
    pstate = train_lib.create_train_state(cfg, seed=0, device="cpu")
    assert pstate.model.training
    step = train_lib.make_train_step(cfg)
    tb = train_lib.batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    first = None
    for _ in range(10):
        metrics = step(pstate, tb, gen)
        first = float(metrics["loss"]) if first is None else first
    assert float(metrics["loss"]) < first


def test_grads_finite_with_empty_image():
    jcfg, state, batch = _setup()
    batch = dict(batch)
    batch["valid"] = np.zeros_like(batch["valid"])
    batch["label_map"] = np.zeros_like(batch["label_map"])
    cfg = port_config(jcfg)
    pstate = train_lib.create_train_state(cfg, seed=0, device="cpu")
    metrics = train_lib.make_train_step(cfg)(
        pstate, train_lib.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for name, p in pstate.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


# --------------------------------------------------------------------------
# the other backbones, norms and prediction feedback
# --------------------------------------------------------------------------

# each variant once in f64 (remat rides on hourglass_fast), and the unet
# once more in f32: name -> (kgtpu ModelConfig fields, compute dtype)
VARIANT_MODELS = {
    "unet": (dict(backbone="unet"), "float64"),
    "resnet_fpn": (dict(backbone="resnet_fpn"), "float64"),
    "hourglass_fast_remat": (dict(backbone="hourglass_fast", num_stacks=2, remat=True),
                             "float64"),
    "inter_inject": (dict(backbone="hourglass", num_stacks=2, inter_inject=True), "float64"),
    "batchnorm": (dict(backbone="hourglass", num_stacks=2, norm="batch"), "float64"),
    "unet_f32": (dict(backbone="unet"), "float32"),
}
# f32 gradients, held per tensor at this share of the tensor's own largest
# entry (rtol 1e-3 as everywhere): at these draws the port's f32 unet
# gradient strays from its f64 one by up to 1.4e-5 of that max, so the two
# packages may differ by about twice that (3.9e-6 is seen)
F32_GRAD_ATOL = 1e-4


@pytest.fixture
def one_torch_thread():
    """torch on one thread: its OpenMP pool beside XLA's CPU threads has
    crashed this test's process (a segfault in either package's code)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", sorted(VARIANT_MODELS))
def test_loss_and_gradients_match_kgtpu_per_variant(variant, one_torch_thread):
    """loss_fn's metrics (rtol 1e-4) and every gradient of one step on the
    same params (numpy draws, as in test_torch_backbones.py) and draws.
    The f64 cases run kgtpu under jax.enable_x64 with compute_dtype float64
    and the port with f64 parameters and activations (its norms compute in
    f32 as always): the gradients at the tolerance of
    test_gradients_match_kgtpu.  In f32 the convolutions' weight gradients
    are long cancelling sums that stray from f64 in both packages alike
    (at kgtpu's own init, with its zero biases and heatmap prior, by up to
    3.3e-4 of a tensor's largest entry), beyond that tree-wide tolerance:
    the f32 case holds each tensor at F32_GRAD_ATOL of its own max."""
    from test_torch_backbones import SIDE, draw_variables
    fields, dtype = VARIANT_MODELS[variant]
    f64 = dtype == "float64"
    base = jax_tiny_config()
    jcfg = base.replace(
        model=dataclasses.replace(base.model, base_channels=16, head_channels=16, hg_depth=2,
                                  **fields),
        data=dataclasses.replace(base.data, input_size=SIDE),
        train=dataclasses.replace(base.train, lr_warmup_steps=1))
    v = draw_variables(jcfg.model, seed=1)
    batch = make_batch(build_dataset(jcfg.data), [0, 1], jcfg.data, augment=False,
                       rng=np.random.default_rng(0))
    rng = jax.random.PRNGKey(13)
    with jax.enable_x64(f64):
        jd = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                                 compute_dtype=dtype))
        vd = jax.tree.map(lambda a: np.asarray(a, dtype), v)
        jmodel = JaxKGNet(cfg=jd.model)
        # XLA's CPU work runs asynchronously: it finishes before torch's
        # threads start (the two thread pools running side by side can crash)
        (_, (want, _)), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p: jtrain.loss_fn(p, batch, rng, jmodel, jd, vd.get("batch_stats")),
            has_aux=True))(vd["params"]))
        sel_u, jit_u = _draws(rng, jcfg, batch)
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    cfg = port_config(jcfg)
    model = build_model(cfg.model, seed=None, device="cpu")
    model = load_flax_params(model, v).train()
    if f64:
        model = model.double()
        model.compute_dtype = torch.float64
    total, got = train_lib.loss_fn(model, train_lib.batch_to_device(batch, "cpu"),
                                   sel_u, jit_u, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, err_msg=k)
    total.backward()
    wgrads = flax_to_state_dict(jgrads, cfg.model)
    named = dict(model.named_parameters())
    assert set(named) == set(wgrads)
    gmax = max(float(w.abs().max()) for w in wgrads.values())
    for name, p in named.items():
        assert p.grad is not None, name
        w = wgrads[name].numpy()
        atol = 1e-6 * gmax if f64 else F32_GRAD_ATOL * float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.float().numpy(), w, rtol=1e-3, atol=atol,
                                   err_msg=name)
