"""The train step: counterpart of `kgtpu/train_lib.py` (one device, eager).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from kgtpu_torch import losses
from kgtpu_torch.config import Config
from kgtpu_torch.models import KGNet, build_model
from kgtpu_torch.ops import gaussian
from kgtpu_torch.ops.preprocess import normalize_images
from kgtpu_torch.ops.roi import crop_and_resize
from kgtpu_torch.ops.targets import keypoints_from_boxes


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
    The clip is applied to the `.grad` tensors in place.
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

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """One update from `grads` (one per parameter); returns the global
        gradient norm before clipping (a 0-d tensor on the device)."""
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        torch._foreach_div_(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))

        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
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


def batch_to_device(batch: dict, device: str | torch.device) -> dict:
    """The loader's host batch (NumPy: uint8 images, boxes, valid, img_gain,
    img_bias, uint16 label map) as tensors on `device`.  The label map is cast
    to int32 on the host first: torch has no uint16 arithmetic to rely on."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if k == "label_map":
            a = a.astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


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


def loss_fn(model: KGNet, batch: dict, sel_u: torch.Tensor, jit_u: torch.Tensor,
            cfg: Config, render: Callable = gaussian.render_heatmaps
            ) -> tuple[torch.Tensor, dict]:
    """Total loss and its parts for one batch (tensors on the model's device).

    sel_u [B, N] and jit_u [B, r, 4] are uniforms in [0, 1): the ROI
    selection keys and the box jitter.  `render` makes the heatmap targets:
    the kernel's wrapper, or (for comparisons) its plain version.
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
    l_hm = torch.stack([losses.focal_loss(st["hm"], hm_t, tcfg.focal_alpha,
                                          tcfg.focal_beta) for st in stacks]).mean()
    l_off = torch.stack([losses.offset_loss(st["reg"], kpts, valid).mean()
                         for st in stacks]).mean()
    total = tcfg.w_heatmap * l_hm + tcfg.w_offset * l_off
    metrics = {"loss_hm": l_hm, "loss_off": l_off}
    if cfg.model.use_wh_head:
        l_wh = torch.stack([losses.wh_loss(st["wh"], boxes_st, valid).mean()
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
    l_mask = losses.mask_loss(mask_logits, gt_masks, roi_valid).mean()
    total = total + tcfg.w_mask * l_mask
    metrics["loss_mask"] = l_mask
    metrics["loss"] = total
    return total, metrics


def train_step(state: TrainState, batch: dict, sel_u: torch.Tensor,
               jit_u: torch.Tensor, cfg: Config) -> dict:
    """One optimization step on a batch from `batch_to_device`, with the
    draws of `loss_fn` given.  Returns the metrics (0-d tensors on the
    device); `grad_norm` is the global gradient norm before clipping.  The
    EMA, when kept, uses the decay min(ema_decay, (1 + t) / (10 + t)) with t
    the step count after the update."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    total, metrics = loss_fn(state.model, batch, sel_u, jit_u, cfg)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    metrics["grad_norm"] = state.optimizer.step(grads)
    state.step += 1
    if state.ema is not None:
        t = float(state.step)
        d = min(cfg.train.ema_decay, (1.0 + t) / (10.0 + t))
        with torch.no_grad():
            torch._foreach_mul_(state.ema, d)
            torch._foreach_add_(state.ema, params, alpha=1.0 - d)
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: Config) -> Callable:
    """step(state, batch, generator) -> metrics: `train_step` with the ROI
    selection and jitter uniforms drawn from `generator` (on its own device,
    then moved to the batch's)."""

    def step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        dev = batch["valid"].device
        b, n = batch["valid"].shape
        sel_u = torch.rand((b, n), generator=generator, device=generator.device)
        jit_u = torch.rand((b, cfg.train.mask_train_rois, 4), generator=generator,
                           device=generator.device)
        return train_step(state, batch, sel_u.to(dev), jit_u.to(dev), cfg)

    return step
