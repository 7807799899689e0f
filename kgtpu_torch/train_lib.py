"""The train step: counterpart of `kgtpu/train_lib.py`.

  batch (host arrays)  -> `batch_to_device`
  -> normalize + colour jitter -> Gaussian targets (kernel, no gradient)
  -> KGNet forward in training mode (all stacks' heads; BatchNorm moves its
     running stats here, and the mask head's in its own forward below)
  -> focal / offset / wh losses averaged over the stacks
  -> r random valid ROIs per image, jittered -> bilinear feature crops
     -> one mask-head call; nearest GT crops of the label map -> mask loss
  -> backward -> global-norm clip -> Adam(W) with the warmup schedule -> EMA

The JAX package draws its random numbers from `jax.random` keys inside the
jitted step.  Here `loss_fn` takes its two draws as tensors (the [B, N]
selection uniforms and the [B, r, 4] jitter uniforms), and the step draws
them from a `torch.Generator`; the tests feed both packages the same draws.
The optimizer writes optax's semantics out rather than relying on
`torch.optim`'s defaults (see `Optimizer`).

One step body serves every path (`_step_body`).  What changes from step to
step reaches it as device scalars the host fills before the call (the
learning rate, Adam's bias corrections, the EMA's decay): a CUDA graph
replays its kernels with whatever those tensors then hold, where a Python
float would be frozen at capture.  `make_train_multi_step` runs k such
bodies in one call, on CUDA as one captured graph per (k, batch shape)
replayed every dispatch, the counterpart of kgtpu's scanned multi-step.
With a `parallel.multihost.GlobalBatch`, each rank holds its rows of the
global batch and the body computes the global batch's update, as kgtpu's
sharded jit does: loss terms normalised by global counts, one flat
all-reduce (sum) of the gradients, BatchNorm over the global batch
(`models/blocks.BatchNorm`), metrics summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from kgtpu_torch import losses
from kgtpu_torch.config import Config
from kgtpu_torch.models import KGNet, build_model
from kgtpu_torch.ops import gaussian
from kgtpu_torch.ops.preprocess import normalize_images
from kgtpu_torch.ops.roi import crop_and_resize
from kgtpu_torch.ops.targets import keypoints_from_boxes

if TYPE_CHECKING:
    from kgtpu_torch.parallel.multihost import GlobalBatch

# The device scalars of one step, in this order (`step_scalars`).
_MU, _BC2, _WD, _EMA_D = range(4)


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate at optimizer step t (0-based), as
    `kgtpu.train_lib.make_optimizer` builds it with optax: a linear warmup
    from 5% of `lr` over max(lr_warmup_steps, 1) steps, then either constant
    or (cosine with steps_per_epoch > 0) a cosine decay to lr / 100 that ends
    at step max(num_epochs * steps_per_epoch, warmup + 1), counted from step
    0 with the warmup included.  Computed in f32 in optax's order of
    operations, as optax computes it."""
    t = cfg.train
    f32 = np.float32
    warmup = max(t.lr_warmup_steps, 1)
    init, peak = 0.05 * t.lr, t.lr

    def linear(step: int) -> float:          # optax.linear_schedule
        frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
        return float(f32(init - peak) * frac + f32(peak))

    if t.lr_schedule != "cosine" or t.steps_per_epoch <= 0:
        return linear
    total = max(t.num_epochs * t.steps_per_epoch, warmup + 1)
    alpha = 0.0 if peak == 0.0 else (t.lr / 100.0) / peak
    decay = total - warmup

    def cosine(step: int) -> float:          # optax.join_schedules at warmup
        if step < warmup:
            return linear(step)
        c = f32(min(step - warmup, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(peak) * (f32(1 - alpha) * cos + f32(alpha)))

    return cosine


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip_norm), adam | adamw(schedule))
    over a list of parameters, in f32 with foreach ops.

    * The clip scales by max_norm / g_norm only when g_norm >= max_norm, with
      nothing added to the norm (torch's `clip_grad_norm_` adds 1e-6).
    * Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
      correction by the step count after the increment.
    * AdamW when weight_decay > 0: the decay `weight_decay * param` is added
      to Adam's direction before the learning rate scales it.
    * Step t uses the learning rate `schedule(t)` (t counted before the
      update).
    The clip is applied to the `.grad` tensors in place.  `update` is the
    step with its changing scalars given as a device tensor (capturable in
    a CUDA graph); `step` fills them from `count` and advances it.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: list[torch.Tensor], cfg: Config):
        self.params = list(params)
        self.schedule = lr_schedule(cfg)
        self.max_norm = cfg.train.grad_clip_norm
        self.weight_decay = cfg.train.weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def scalars(self, count: int) -> tuple[float, float, float]:
        """(-lr / (1 - b1^t), 1 - b2^t, -lr * weight_decay) of the update
        made at `count` (t = count + 1, the count after it; lr the
        schedule's at `count`): the learning rate folded into the first
        moment's bias correction and into the decay, so that the update
        scales by it without an op of its own."""
        t = count + 1
        lr = self.schedule(count)
        return -lr / (1.0 - self.b1 ** t), 1.0 - self.b2 ** t, -lr * self.weight_decay

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """One update from `grads` (one per parameter) at the current count,
        which it advances; returns the global gradient norm before clipping
        (a 0-d tensor on the device)."""
        sc = torch.tensor(self.scalars(self.count), dtype=torch.float32,
                          device=self.params[0].device)
        self.count += 1
        return self.update(grads, sc)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], sc: torch.Tensor) -> torch.Tensor:
        """`step` with `sc` = `scalars(count)` as f32 on the device, leaving
        `count` alone: nothing here reads a host value that changes between
        steps."""
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        torch._foreach_div_(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))

        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, sc[_BC2])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_mul(self.mu, sc[_MU])
        torch._foreach_div_(upd, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, sc[_WD]))
        torch._foreach_add_(self.params, upd)
        return g_norm


@dataclasses.dataclass
class TrainState:
    """The model (in training mode), its optimizer, the number of steps taken,
    and the EMA of the parameters when ema_decay > 0 (in `model.parameters()`
    order)."""

    model: KGNet
    optimizer: Optimizer
    step: int = 0
    ema: list[torch.Tensor] | None = None


def create_train_state(cfg: Config, seed: int | None = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """A KGNet with random weights from `seed` (default cfg.train.seed), in
    training mode on `device` (CUDA unless the caller asks for the CPU; it
    raises without a GPU), with a fresh optimizer."""
    seed = cfg.train.seed if seed is None else seed
    model = build_model(cfg.model, seed=seed, device=device).train()
    params = list(model.parameters())
    ema = ([p.detach().clone() for p in params] if cfg.train.ema_decay > 0
           else None)
    return TrainState(model=model, optimizer=Optimizer(params, cfg), ema=ema)


def _host_tensor(name: str, a) -> torch.Tensor:
    """One leaf of a loader batch as a host tensor.  The label map is cast
    to int32 on the host first: torch has no uint16 arithmetic to rely on."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if name == "label_map":
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def broadcast_state(state: TrainState) -> None:
    """Rank 0's parameters, buffers, optimizer moments and EMA on every rank
    of the process group (once, at the start of a data-parallel run)."""
    from kgtpu_torch.parallel.multihost import broadcast_tensors
    tensors = _state_tensors(state)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        broadcast_tensors([t for t in tensors if t.dtype == dtype])


def batch_to_device(batch: dict, device: str | torch.device) -> dict:
    """The loader's host batch (NumPy: uint8 images, boxes, valid, img_gain,
    img_bias, uint16 label map; or k of them stacked on a leading axis) as
    tensors on `device`, the label map as int32."""
    return {k: _host_tensor(k, v).to(device) for k, v in batch.items()}


def _jitter_boxes(boxes: torch.Tensor, u: torch.Tensor, frac: float) -> torch.Tensor:
    """Move box corners by up to +-frac * (w, h), so the mask head trains on
    imperfect boxes.  u: uniforms in [0, 1) of boxes' shape, mapped to
    [-frac, frac) as jax.random.uniform(minval=-frac, maxval=frac) maps its
    bits."""
    wh = torch.stack([boxes[..., 2] - boxes[..., 0],
                      boxes[..., 3] - boxes[..., 1]], dim=-1)
    noise = torch.clamp(u * (frac - (-frac)) + (-frac), min=-frac)
    out = boxes + noise * torch.cat([wh, wh], dim=-1)
    # keep jittered boxes non-degenerate
    x0 = torch.minimum(out[..., 0], out[..., 2] - 1.0)
    y0 = torch.minimum(out[..., 1], out[..., 3] - 1.0)
    return torch.stack([x0, y0, out[..., 2], out[..., 3]], dim=-1)


def select_rois(sel_u: torch.Tensor, valid: torch.Tensor, r: int) -> torch.Tensor:
    """[B, r] indices of the r largest keys sel_u * valid: random valid
    instances first, then invalid slots by ascending index (the tie rule of
    jax.lax.top_k, hence a stable sort rather than torch.topk)."""
    key = sel_u * valid
    return torch.sort(key, dim=1, descending=True, stable=True)[1][:, :r]


def _per_image_mean(x: torch.Tensor, gb: GlobalBatch | None) -> torch.Tensor:
    """The mean of per-image values [B]; with `gb`, this rank's share of the
    global batch's mean (its sum over the global batch size), so the ranks'
    shares add up to the global mean."""
    return x.mean() if gb is None else x.sum() / gb.size(x.shape[0])


def loss_fn(model: KGNet, batch: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
            cfg: Config, render: Callable = gaussian.render_heatmaps,
            gb: GlobalBatch | None = None) -> tuple[torch.Tensor, dict]:
    """Total loss and its parts for one batch (tensors on the model's device).

    sel_u [B, N] and jit_u [B, r, 4] are uniforms in [0, 1): the ROI
    selection keys and the box jitter.  `render` makes the heatmap targets:
    the kernel's wrapper, or (for comparisons) its plain version.  With `gb`
    the batch is this rank's rows of the global batch, and every term is
    normalised by the global batch's counts (the focal loss by the global
    number of positives, per-image means by the global batch size): the sum
    of the ranks' losses is the global batch's loss.
    """
    s = cfg.data.stride
    tcfg = cfg.train
    images = normalize_images(batch["image"], cfg.data.mean, cfg.data.std,
                              batch.get("img_gain"), batch.get("img_bias"))
    b, h, w, _ = images.shape
    hs, ws = h // s, w // s

    boxes_px = batch["boxes"].float()                   # [B, N, 4] input pixels
    valid = batch["valid"].float()                      # [B, N]
    boxes_st = boxes_px / s
    kpts = keypoints_from_boxes(boxes_st)               # [B, N, 5, 2]
    # clamp keypoints into the heatmap: border-touching instances have
    # exclusive corners at exactly ws / hs, which would splat off the map
    kpts = torch.stack([torch.clamp(kpts[..., 0], 0.0, ws - 1e-3),
                        torch.clamp(kpts[..., 1], 0.0, hs - 1e-3)], dim=-1)
    sizes = torch.stack([boxes_st[..., 3] - boxes_st[..., 1],
                         boxes_st[..., 2] - boxes_st[..., 0]], dim=-1)
    with torch.no_grad():
        hm_t = render(kpts, sizes, valid, hs, ws)       # [B, hs, ws, 5]

    out = model(images)
    stacks = out["stacks"]
    count = None if gb is None else gb.sum
    l_hm = torch.stack([losses.focal_loss(st["hm"], hm_t, tcfg.focal_alpha,
                                          tcfg.focal_beta, count) for st in stacks]).mean()
    l_off = torch.stack([_per_image_mean(losses.offset_loss(st["reg"], kpts, valid), gb)
                         for st in stacks]).mean()
    total = tcfg.w_heatmap * l_hm + tcfg.w_offset * l_off
    metrics = {"loss_hm": l_hm, "loss_off": l_off}
    if cfg.model.use_wh_head:
        l_wh = torch.stack([_per_image_mean(losses.wh_loss(st["wh"], boxes_st, valid), gb)
                            for st in stacks]).mean()
        total = total + tcfg.w_wh * l_wh
        metrics["loss_wh"] = l_wh

    # stage-2 mask head on r random valid instances per image (slots are
    # area-ranked: the first r would train it on the largest cells only)
    r = tcfg.mask_train_rois
    sel = select_rois(sel_u, valid, r)                  # [B, r]
    roi_boxes = torch.gather(boxes_px, 1, sel[..., None].expand(-1, -1, 4))
    roi_valid = torch.gather(valid, 1, sel)
    roi_boxes_px = _jitter_boxes(roi_boxes, jit_u, tcfg.roi_jitter)
    m = cfg.model.mask_size
    crops = crop_and_resize(out["feat"], roi_boxes_px / s, cfg.model.roi_size)
    mask_logits = model.apply_mask_head(
        crops.reshape((b * r,) + crops.shape[2:])).reshape(b, r, m, m)
    with torch.no_grad():
        gt = crop_and_resize(batch["label_map"][..., None], roi_boxes_px, m,
                             method="nearest")[..., 0]              # [B, r, m, m]
        gt_masks = (gt == (sel + 1)[..., None, None]).float()
    l_mask = _per_image_mean(losses.mask_loss(mask_logits, gt_masks, roi_valid), gb)
    total = total + tcfg.w_mask * l_mask
    metrics["loss_mask"] = l_mask
    metrics["loss"] = total
    return total, metrics


def step_scalars(state: TrainState, cfg: Config, k: int) -> np.ndarray:
    """[k, 4] f32: for each of the next k steps, the optimizer's three
    (`Optimizer.scalars`) and the EMA's decay d = min(ema_decay, (1 + t) /
    (10 + t)), with t the step count after the update."""
    rows = []
    for j in range(k):
        t = float(state.step + j + 1)
        d = min(cfg.train.ema_decay, (1.0 + t) / (10.0 + t))
        rows.append((*state.optimizer.scalars(state.optimizer.count + j), d))
    return np.asarray(rows, dtype=np.float32)


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor], d: torch.Tensor) -> None:
    """ema <- d * ema + (1 - d) * params, with d a device scalar, written
    d * (ema - params) + params: three in-place ops, nothing allocated."""
    torch._foreach_sub_(ema, params)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _step_body(state: TrainState, batch: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
               cfg: Config, sc: torch.Tensor, gb: GlobalBatch | None) -> dict:
    """One optimization step with its changing scalars `sc` (one row of
    `step_scalars`, on the device): the body every path runs, eager or
    captured.  Touches no host state: the caller advances the counts."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    total, metrics = loss_fn(state.model, batch, sel_u, jit_u, cfg, gb=gb)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if gb is not None:
        grads = gb.sum_flat(grads)
        names = list(metrics)
        metrics = dict(zip(names, gb.sum(torch.stack([metrics[k] for k in names]))))
    metrics["grad_norm"] = state.optimizer.update(grads, sc[:_EMA_D])
    if state.ema is not None:
        ema_update(state.ema, params, sc[_EMA_D])
    return metrics


def _advance(state: TrainState, k: int) -> None:
    state.step += k
    state.optimizer.count += k


def train_step(state: TrainState, batch: dict, sel_u: torch.Tensor,
               jit_u: torch.Tensor, cfg: Config, gb: GlobalBatch | None = None) -> dict:
    """One optimization step on a batch from `batch_to_device`, with the
    draws of `loss_fn` given.  Returns the metrics (0-d tensors on the
    device); `grad_norm` is the global gradient norm before clipping.  The
    EMA, when kept, uses the decay min(ema_decay, (1 + t) / (10 + t)) with t
    the step count after the update.  With `gb`: the data-parallel step
    (module note), `batch` and the draws this rank's rows."""
    dev = state.optimizer.params[0].device
    sc = _to_device(step_scalars(state, cfg, 1), dev)[0]
    metrics = _step_body(state, batch, sel_u, jit_u, cfg, sc, gb)
    _advance(state, 1)
    return metrics


def step_draws(cfg: Config, generator: torch.Generator, b: int, n: int,
               device: torch.device, gb: GlobalBatch | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step's uniforms from its generator: the ROI selection keys [b, n]
    and the box jitter [b, r, 4], drawn on the generator's device and moved
    to `device`.  With `gb`, b is this rank's share: the global batch's
    draws are made and this rank's rows taken, so a data-parallel run
    consumes exactly the draws of a one-process run."""
    rows = b if gb is None else gb.size(b)
    sel_u = torch.rand((rows, n), generator=generator, device=generator.device)
    jit_u = torch.rand((rows, cfg.train.mask_train_rois, 4), generator=generator,
                       device=generator.device)
    if gb is not None:
        sel_u, jit_u = gb.rows(sel_u), gb.rows(jit_u)
    return sel_u.to(device), jit_u.to(device)


def make_train_step(cfg: Config, gb: GlobalBatch | None = None) -> Callable:
    """step(state, batch, generator) -> metrics: `train_step` with the ROI
    selection and jitter uniforms drawn from `generator` (`step_draws`)."""

    def step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        b, n = batch["valid"].shape
        sel_u, jit_u = step_draws(cfg, generator, b, n, batch["valid"].device, gb)
        return train_step(state, batch, sel_u, jit_u, cfg, gb)

    return step


def _run_bodies(state: TrainState, batches: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
                sc: torch.Tensor, cfg: Config, gb: GlobalBatch | None) -> dict:
    """k step bodies in order on [k, ...] stacks; metrics stacked [k]."""
    ms = [_step_body(state, {name: v[j] for name, v in batches.items()}, sel_u[j], jit_u[j],
                     cfg, sc[j], gb) for j in range(sc.shape[0])]
    return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step writes: parameters, Adam's moments, the model's
    buffers (BatchNorm's running stats) and the EMA."""
    opt = state.optimizer
    out = [*opt.params, *opt.mu, *opt.nu, *state.model.buffers()]
    return out + list(state.ema or [])


class _CapturedSteps:
    """k step bodies on one state, captured as one CUDA graph.

    The inputs live in static buffers on the device, filled before each
    replay: the batches with `copy_` from pinned host memory, the draws from
    the device, the step scalars from pinned host memory.  Capture needs the
    kernels built, cuDNN and cuBLAS set up and the communicator warm, so the
    k bodies first run once eagerly on a side stream; they move the state,
    which is saved before and restored after.  Gradients are set to None
    before capture, so the graph allocates them in its own pool.  A failed
    capture raises."""

    def __init__(self, state: TrainState, cfg: Config, batches: dict, sel_u: torch.Tensor,
                 jit_u: torch.Tensor, sc: np.ndarray, gb: GlobalBatch | None):
        dev = state.optimizer.params[0].device
        self.state = state
        self.batches = {name: torch.empty(tuple(np.shape(v)), device=dev,
                                          dtype=_host_tensor(name, v[:1]).dtype)
                        for name, v in batches.items()}
        self.sel_u = torch.empty(sel_u.shape, dtype=torch.float32, device=dev)
        self.jit_u = torch.empty(jit_u.shape, dtype=torch.float32, device=dev)
        self.sc = torch.empty(sc.shape, dtype=torch.float32, device=dev)
        self.fill(batches, sel_u, jit_u, sc)
        args = (state, self.batches, self.sel_u, self.jit_u, self.sc, cfg, gb)

        tensors = _state_tensors(state)
        saved = [t.detach().clone() for t in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _run_bodies(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        del saved
        for p in state.optimizer.params:
            p.grad = None

        self.graph = torch.cuda.CUDAGraph()
        before = gaussian.launches
        with torch.cuda.graph(self.graph):
            self.out = _run_bodies(*args)
        # capture records the kernel's launches without running them; each
        # replay runs them (`__call__`)
        self.gauss_launches = gaussian.launches - before
        gaussian.launches = before

    def fill(self, batches: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
             sc: np.ndarray) -> None:
        for name, dst in self.batches.items():
            src = _host_tensor(name, batches[name])
            dst.copy_(src.pin_memory() if src.device.type == "cpu" else src, non_blocking=True)
        self.sel_u.copy_(sel_u)
        self.jit_u.copy_(jit_u)
        self.sc.copy_(torch.from_numpy(sc).pin_memory(), non_blocking=True)

    def __call__(self, batches: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
                 sc: np.ndarray) -> dict:
        self.fill(batches, sel_u, jit_u, sc)
        self.graph.replay()
        gaussian.launches += self.gauss_launches
        return {k: v.clone() for k, v in self.out.items()}


def make_train_multi_step(cfg: Config, n_steps: int, gb: GlobalBatch | None = None,
                          capture: bool = True) -> Callable:
    """`n_steps` optimization steps in one call: the counterpart of
    `kgtpu.train_lib.make_train_multi_step`.

    Call as `multi(state, batches, sel_u, jit_u)`, where every leaf of
    `batches` is stacked on a leading [k] axis (host NumPy from
    `data.loader.stack_batches`, or tensors), and sel_u [k, B, N] and jit_u
    [k, B, r, 4] are the k steps' draws, step j's from step j's own
    generator (`step_draws`), so the k steps consume the draws of k single
    steps in their order.  Returns the metrics stacked [k]; `state.step` and
    the optimizer's count advance by k.

    On CUDA, with `capture`, the k step bodies are one CUDA graph per
    (state, batch shape), captured at first use and replayed every call
    (`_CapturedSteps`); the Gaussian kernel's launches count on every
    replay.  On the CPU, or without `capture` (`--debug_nans`, whose checks
    sync with the host after every op), the same k bodies run one after
    another.  Either way they are the bodies of k `train_step` calls, with
    the same scalars.  With `gb`, each body is the data-parallel step, its
    all-reduces inside the graph (NCCL can be captured; gloo cannot, and
    runs on the CPU).
    """
    graphs: dict = {}

    def multi(state: TrainState, batches: dict, sel_u: torch.Tensor,
              jit_u: torch.Tensor) -> dict:
        dev = state.optimizer.params[0].device
        if len(sel_u) != n_steps:
            raise ValueError(f"expected draws for {n_steps} steps, got {len(sel_u)}")
        sc = step_scalars(state, cfg, n_steps)
        if dev.type == "cuda" and capture:
            key = (id(state),) + tuple((k, tuple(np.shape(v))) for k, v in sorted(batches.items()))
            steps = graphs.get(key)
            if steps is None:
                steps = graphs[key] = _CapturedSteps(state, cfg, batches, sel_u, jit_u, sc, gb)
            out = steps(batches, sel_u, jit_u, sc)
        else:
            out = _run_bodies(state, batch_to_device(batches, dev), sel_u.to(dev),
                              jit_u.to(dev), _to_device(sc, dev), cfg, gb)
        _advance(state, n_steps)
        return out

    return multi
