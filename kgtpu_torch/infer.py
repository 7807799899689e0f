"""Two-stage inference: counterpart of `kgtpu/infer.py` (`build_infer_fn`,
`build_detect_fn`, `build_ensemble_fn`, `build_multiscale_fn`,
`build_tiled_infer_fn` and the stages under them).

  images [B, H, W, 3] raw pixels
    -> normalize -> KGNet backbone + heads          (detect_batch)
    -> decode_peaks -> group_keypoints -> box_nms   (stride coords; with
       group.method "centernet": decode_center_wh -> box_nms)
    -> crop_and_resize(features, boxes) -> mask head, in chunks of
       mask_chunk detection slots, skipping chunks with no valid slot
    -> paste_masks_batch -> per-image instance label maps   (mask_batch)

Multi-scale and flip TTA, and checkpoint ensembles, run the detector once
per (member, scale, flip) variant, map every variant's boxes to the base
scale's stride grid, merge them per image (`ops/nms.merge_scales`), and run
the mask stage once on the mask member's base-scale features.  Whole-slide
inference runs the detector over fixed tiles, keeps each tile's owned
detections, pastes per tile with globally unique ids and stitches
(`ops/tiling.py`).

JAX's jit and vmap have no counterpart here: PyTorch runs eagerly, and every
op carries the batch axis.  A skipped chunk is found by one host-side count
of valid slots per batch, where JAX used lax.cond per chunk, and the
grouper's and NMS's rounds stop on a host check.  `traced=True` gives every
builder the forms `torch.export` can trace (`kgtpu_torch/export.py`): a
cond per slot chunk and while_loop rounds (`ops/control.py`), and the
pipeline's body without `torch.inference_mode` (the caller traces under
no_grad).  They compute the same outputs, a skipped chunk's logits 0
included.

Data-parallel serving (`devices=` on `build_infer_fn` and
`build_tiled_infer_fn`, the counterpart of kgtpu's `mesh=`) puts one replica
of the model on each device, its weights copied once, and runs each
device's shard of the batch (or of a chunk's tiles) in a host thread of its
own, since the round loops sync with the host; the outputs are gathered in
batch order on the first device.  Every stage is per image (or per tile),
so the label maps, boxes, scores and validity equal the unsharded call's.
Only the mask probabilities of invalid slots may differ: a slot chunk is
skipped when no image of the shard has a valid detection in it, where the
whole batch decides unsharded.  Each replica's GroupNorm runs the kernel;
kgtpu turns its fused norm off under a mesh for want of an SPMD rule.
"""

from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import torch

from kgtpu_torch.config import Config
from kgtpu_torch.device import resolve_device
from kgtpu_torch.models import KGNet
from kgtpu_torch.ops.control import cond
from kgtpu_torch.ops.decode import decode_center_wh, decode_peaks, gather_at
from kgtpu_torch.ops.group import Boxes, group_keypoints
from kgtpu_torch.ops.nms import box_nms, merge_scales
from kgtpu_torch.ops.preprocess import normalize_images
from kgtpu_torch.ops.roi import crop_and_resize, paste_masks_batch
from kgtpu_torch.ops.tiling import (extract_tiles, ownership_mask, ownership_rects,
                                    stitch_tiles, tile_grid)
from kgtpu_torch.parallel.mesh import gather_batch, shard_batch


def _check_cfg(cfg: Config) -> None:
    if cfg.group.method not in ("kg", "centernet"):
        raise ValueError(f"unknown group.method {cfg.group.method!r}")
    if cfg.group.method == "centernet" and not cfg.model.use_wh_head:
        raise ValueError('group.method="centernet" needs model.use_wh_head=True')


def decode_batch(cfg: Config, stack: dict, traced: bool = False) -> Boxes:
    """Last-stack head maps (NHWC f32) -> NMS'd Boxes [B, D] (stride coords)."""
    if cfg.group.method == "centernet":
        if "wh" not in stack:
            raise ValueError('group.method="centernet" needs model.use_wh_head=True')
        cand = decode_center_wh(stack["hm"], stack["reg"], stack["wh"],
                                cfg.group.max_detections, cfg.group.score_thresh)
        return box_nms(cand, cfg.group.nms_iou, traced=traced)
    peaks = decode_peaks(stack["hm"], stack["reg"], cfg.group.max_peaks_per_class)
    kp_wh = None
    if cfg.group.size_prune > 0 and "wh" in stack:
        kp_wh = gather_at(stack["wh"], peaks.indices)     # [B, 5, K, 2]
    cand = group_keypoints(peaks, cfg.group, kp_wh=kp_wh, traced=traced)
    return box_nms(cand, cfg.group.nms_iou, traced=traced)


def detect_batch(model: KGNet, cfg: Config, images: torch.Tensor,
                 traced: bool = False) -> tuple[Boxes, torch.Tensor]:
    """Normalized images [B, H, W, 3] -> (Boxes [B, D], features NHWC)."""
    out = model(images, last_stack_only=True)
    return decode_batch(cfg, out["stacks"][-1], traced), out["feat"]


def mask_probs(model: KGNet, cfg: Config, feats: torch.Tensor,
               dets: Boxes, traced: bool = False) -> torch.Tensor:
    """ROI crop + mask head -> mask probabilities [B, D, m, m].  Slot chunks
    with no valid detection in any image are skipped: their logits are 0
    (probability 0.5), as kgtpu's are."""
    b, d = dets.boxes.shape[:2]
    m = cfg.model.mask_size
    ch = cfg.infer.mask_chunk
    dense = not 0 < ch < d                  # dense: every slot, no skipping
    if dense:
        ch, pad, boxes = d, 0, dets.boxes
    else:
        pad = (-d) % ch
        boxes = torch.nn.functional.pad(dets.boxes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(dets.valid, (0, pad))
        live = valid.reshape(b, -1, ch).any(dim=2).any(dim=0)

    # a traced branch reads its operands only: the mask head's state goes in
    state = dict(model.mask_head.named_parameters()) | dict(model.mask_head.named_buffers())

    def head(feats, bx, *tensors) -> torch.Tensor:
        crops = crop_and_resize(feats, bx, cfg.model.roi_size)
        flat = crops.reshape((b * ch,) + crops.shape[2:])
        named = dict(zip(state, tensors)) if tensors else None
        return model.apply_mask_head(flat, named).reshape(b, ch, m, m)

    if dense:
        return torch.sigmoid(head(feats, boxes))
    if traced:
        skip = lambda *_: torch.zeros((b, ch, m, m), dtype=torch.float32, device=feats.device)
        logits = torch.cat([cond(live[ci], head, skip,
                                 (feats, boxes[:, ci * ch:(ci + 1) * ch], *state.values()))
                            for ci in range((d + pad) // ch)], dim=1)
    else:
        logits = torch.zeros((b, d + pad, m, m), dtype=torch.float32, device=feats.device)
        for ci in torch.nonzero(live).flatten().tolist():
            logits[:, ci * ch:(ci + 1) * ch] = head(feats, boxes[:, ci * ch:(ci + 1) * ch])
    return torch.sigmoid(logits[:, :d])


def rescore_by_maskness(cfg: Config, probs: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor, gate: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """score *= maskness ** w (w = infer.mask_rescore; 0 is off), then the
    score gate re-applies at `gate` (None: group.score_thresh).  maskness =
    mean mask prob over the head's own foreground."""
    w = cfg.infer.mask_rescore
    if w <= 0:
        return scores, valid
    fg = (probs > cfg.group.mask_thresh).to(probs.dtype)
    maskness = (probs * fg).sum((-2, -1)) / torch.clamp(fg.sum((-2, -1)), min=1.0)
    scores = scores * torch.where(valid, maskness, torch.ones_like(maskness)) ** w
    if gate is None:
        gate = cfg.group.score_thresh
    return scores, valid & (scores >= gate)


def mask_batch(model: KGNet, cfg: Config, feats: torch.Tensor, dets: Boxes,
               height: int, width: int, gate: float | None = None,
               traced: bool = False) -> dict:
    """Stage 2: masks for the detection slots, pasted into label maps, with
    the rescore gate at `gate` (see rescore_by_maskness).  Boxes come back
    in image pixels."""
    probs = mask_probs(model, cfg, feats, dets, traced)
    scores, valid = rescore_by_maskness(cfg, probs, dets.scores, dets.valid, gate)
    boxes = dets.boxes
    if cfg.infer.mask_rescore > 0:
        # restore kept-first order: valid slots first, by rescored score
        key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
        _, order = torch.sort(key, dim=1, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, order)
        valid = torch.gather(valid, 1, order)
        probs = torch.gather(probs, 1, order[..., None, None].expand_as(probs))
    boxes_px = boxes * cfg.data.stride
    d = boxes.shape[1]
    ch = cfg.infer.mask_chunk
    label, score_map = paste_masks_batch(
        probs, boxes_px, scores, valid, height, width,
        thresh=cfg.group.mask_thresh, box_chunk=ch if 0 < ch < d else 32, traced=traced)
    return {"boxes": boxes_px, "scores": scores, "valid": valid,
            "masks": probs, "label_map": label, "score_map": score_map}


def _serving(model: KGNet, device) -> torch.device:
    """Move `model` to the device in channels-last layout, in eval mode."""
    dev = resolve_device(device)
    model.to(device=dev, memory_format=torch.channels_last).eval()
    return dev


def _replicas(model: KGNet, devices: list, traced: bool) -> tuple[list, list]:
    """(devices, models): `model` served on the first device, a copy of it
    on each other one."""
    if traced:
        raise ValueError("devices= serves eagerly: a traced program runs on one device")
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= needs at least one device")
    _serving(model, devs[0])
    models = [model]
    for d in devs[1:]:
        models.append(copy.deepcopy(model))
        _serving(models[-1], d)
    return devs, models


def _parallel(calls: list[Callable]) -> list:
    """Run the calls, one host thread each (one call: in this thread)."""
    if len(calls) == 1:
        return [calls[0]()]
    with ThreadPoolExecutor(len(calls)) as ex:
        futures = [ex.submit(c) for c in calls]
        return [f.result() for f in futures]


def _entry(body: Callable, traced: bool) -> Callable:
    """A builder's pipeline: its body under torch.inference_mode, or the
    bare body for tracing."""
    return body if traced else torch.inference_mode()(body)


def build_infer_fn(model: KGNet, cfg: Config,
                   device: str | torch.device = "cuda", traced: bool = False,
                   devices: list | None = None) -> Callable:
    """(images [B, H, W, 3] raw pixels, uint8 or float 0-255) -> dict of
    boxes [B, D, 4] (pixels), scores [B, D], valid [B, D], masks
    [B, D, m, m], label_map [B, H, W] int32, score_map [B, H, W].

    Moves `model` to `device` (CUDA unless the caller asks for the CPU) and
    puts it in eval mode.  Inputs are moved to that device.  traced: the
    forms `torch.export` traces (module note).  devices: data-parallel
    serving over these devices (`parallel.make_mesh`; module note), the
    batch divisible by their number, the outputs on the first; `device` is
    then not read.
    """
    _check_cfg(cfg)
    if devices is not None:
        devs, models = _replicas(model, devices, traced)
        fns = [build_infer_fn(m, cfg, d) for m, d in zip(models, devs)]

        def infer_sharded(images) -> dict:
            shards = shard_batch(torch.as_tensor(images), len(fns))
            return gather_batch(_parallel([lambda f=f, x=x: f(x) for f, x in zip(fns, shards)]),
                                devs[0])

        return infer_sharded
    dev = _serving(model, device)

    def infer(images) -> dict:
        images = torch.as_tensor(images).to(dev)
        x = normalize_images(images, cfg.data.mean, cfg.data.std)
        dets, feats = detect_batch(model, cfg, x, traced)
        return mask_batch(model, cfg, feats, dets, images.shape[1],
                          images.shape[2], traced=traced)

    return _entry(infer, traced)


def build_detect_fn(model: KGNet, cfg: Config,
                    device: str | torch.device = "cuda") -> Callable:
    """The detector alone, as one TTA variant runs it: (images [B, H, W, 3]
    raw pixels) -> Boxes [B, D] in that scale's stride coords."""
    _check_cfg(cfg)
    dev = _serving(model, device)

    @torch.inference_mode()
    def detect(images) -> Boxes:
        x = normalize_images(torch.as_tensor(images).to(dev), cfg.data.mean, cfg.data.std)
        return detect_batch(model, cfg, x)[0]

    return detect


def _cfg_at(cfg: Config, side: int) -> Config:
    """cfg for a TTA scale of side `side`: the grouper's size cap (base
    canvas stride units) follows that scale's stride grid."""
    base = cfg.infer.input_size
    if cfg.group.max_box_size <= 0 or side == base:
        return cfg
    return dataclasses.replace(cfg, group=dataclasses.replace(
        cfg.group, max_box_size=cfg.group.max_box_size * side / base))


def build_ensemble_fn(models: list[KGNet], cfg: Config, mask_member: int = 0,
                      device: str | torch.device = "cuda", traced: bool = False) -> Callable:
    """Checkpoint ensemble with multi-scale and flip TTA: every (member,
    scale, flip) variant's detections, in base-scale stride coords, go
    through one `merge_scales` per image (cfg.infer's tta_vote, tta_vote_iou
    and tta_vote_thresh); the mask stage runs once on
    `models[mask_member]`'s scale-1.0 features.

    Returns fn({f"{scale:g}": images [B, side, side, 3] raw pixels}) with
    one stack per cfg.infer.test_scales (or [side, side, 3] stacks for one
    image), and the outputs of `build_infer_fn` with label maps at
    cfg.infer.input_size.  Members may differ in architecture; cfg.model is
    the mask member's (the stage-2 crop geometry), and every side must be
    divisible by every member's required divisor.  Each member moves to the
    device in channels-last layout and eval mode.  traced: as
    `build_infer_fn`'s."""
    _check_cfg(cfg)
    dev = [_serving(m, device) for m in models][0]
    scales = cfg.infer.test_scales
    base = cfg.infer.input_size
    stride = cfg.data.stride
    if 1.0 not in scales:
        raise ValueError("test_scales must include 1.0")
    # the mean vote keeps boxes whose voted score lies in [tta_vote_thresh,
    # score_thresh): the rescore gate must not drop them again
    gate = (min(cfg.group.score_thresh, cfg.infer.tta_vote_thresh)
            if cfg.infer.tta_vote == "mean" else None)

    def infer_ens(images_by_scale: dict) -> dict:
        stacks = {k: torch.as_tensor(v).to(dev) for k, v in images_by_scale.items()}
        single = next(iter(stacks.values())).ndim == 3
        if single:
            stacks = {k: v[None] for k, v in stacks.items()}
        variants, base_feat = [], None
        for sc in scales:
            x = normalize_images(stacks[f"{sc:g}"], cfg.data.mean, cfg.data.std)
            cfg_sc = _cfg_at(cfg, x.shape[1])
            factor = base / float(x.shape[1])    # this scale's grid -> base grid
            ws = x.shape[2] / stride
            flipped = torch.flip(x, dims=[2]) if cfg.infer.test_flip else None
            for mi, member in enumerate(models):
                dets, feat = detect_batch(member, cfg_sc, x, traced)
                if sc == 1.0 and mi == mask_member:
                    base_feat = feat
                variants.append(Boxes(boxes=dets.boxes * factor, scores=dets.scores,
                                      valid=dets.valid))
                if flipped is not None:
                    # detect on the mirrored batch, un-mirror: x' = W - x, swapped
                    fd, _ = detect_batch(member, cfg_sc, flipped, traced)
                    fb = fd.boxes
                    unflipped = torch.stack([ws - fb[..., 2], fb[..., 1], ws - fb[..., 0],
                                             fb[..., 3]], dim=-1)
                    variants.append(Boxes(boxes=unflipped * factor, scores=fd.scores,
                                          valid=fd.valid))
        merged = merge_scales(variants, cfg.group.nms_iou, cfg.group.max_detections,
                              vote=cfg.infer.tta_vote, vote_iou=cfg.infer.tta_vote_iou,
                              vote_thresh=cfg.infer.tta_vote_thresh, traced=traced)
        out = mask_batch(models[mask_member], cfg, base_feat, merged, base, base, gate,
                         traced=traced)
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    return _entry(infer_ens, traced)


def build_multiscale_fn(model: KGNet, cfg: Config,
                        device: str | torch.device = "cuda", traced: bool = False) -> Callable:
    """Multi-scale and flip TTA: the one-member `build_ensemble_fn`.
    fn({f"{scale:g}": images [B, side, side, 3]}) with side =
    round(scale * input_size) to the model's divisor."""
    return build_ensemble_fn([model], cfg, mask_member=0, device=device, traced=traced)


def build_tiled_infer_fn(model: KGNet, cfg: Config, image_hw: tuple[int, int],
                         device: str | torch.device = "cuda",
                         tile_batch: int = 8, traced: bool = False,
                         devices: list | None = None) -> Callable:
    """Whole-slide inference.  Returns fn(image [H, W, 3] raw pixels) ->
    {"label_map" [H, W] int32, "score_map" [H, W], "boxes" [T * D, 4]
    (slide pixels), "scores" [T * D], "valid" [T * D]}: slot d of tile t
    is label id t * D + d + 1, and `valid` holds the owned detections after
    rescoring.

    The fixed tile grid (cfg.infer.tile_size, tile_overlap) runs through
    the detector `tile_batch` tiles at a time (the last chunk may be
    short); each tile keeps the detections centered in its owned region,
    the mask stage and paste run over the chunk's tiles as a batch (slot
    chunks with no owned detection skip), and the tile canvases stitch by
    score.  The grid is fixed, so the tile origins are Python ints on every
    path.  traced: as `build_infer_fn`'s.  devices: each chunk's tiles split
    over these devices in contiguous runs of tile_batch / n (tile_batch a
    multiple of their number; module note), the stitch on the first.
    """
    _check_cfg(cfg)
    if devices is None:
        devs, models = [_serving(model, device)], [model]
    else:
        devs, models = _replicas(model, devices, traced)
        if tile_batch % len(devs):
            raise ValueError(f"tile_batch {tile_batch} must be a multiple of the "
                             f"{len(devs)} devices")
    h, w = image_hw
    ts = cfg.infer.tile_size
    s = cfg.data.stride
    d = cfg.group.max_detections
    origins_np = tile_grid(h, w, ts, cfg.infer.tile_overlap)
    origins_list = origins_np.tolist()
    n_tiles = len(origins_np)
    origins = [torch.from_numpy(origins_np).to(dv) for dv in devs]
    rects = [torch.from_numpy(ownership_rects(origins_np, ts)).to(dv) for dv in devs]
    ch = cfg.infer.mask_chunk
    box_chunk = ch if 0 < ch < d else 32
    per_dev = tile_batch // len(devs)

    def tiles(di: int, x: torch.Tensor, sl: slice) -> tuple:
        """Tiles `sl` of the slide on device di: (labels, scores maps, slide
        boxes, rescored scores, owned)."""
        mdl, dev = models[di], devs[di]
        org = origins[di][sl]
        dets, feats = detect_batch(mdl, cfg, extract_tiles(x, origins_list[sl], ts), traced)
        boxes_px = dets.boxes * s
        own = ownership_mask(Boxes(boxes=boxes_px, scores=dets.scores, valid=dets.valid),
                             org, rects[di][sl])
        gboxes = boxes_px + org[:, None, [1, 0, 1, 0]].to(torch.float32)
        probs = mask_probs(mdl, cfg, feats, Boxes(dets.boxes, dets.scores, own), traced)
        scores, own = rescore_by_maskness(cfg, probs, dets.scores, own)
        tid = torch.arange(sl.start, sl.stop, dtype=torch.int32, device=dev)
        label, score = paste_masks_batch(probs, boxes_px, scores, own, ts, ts,
                                         thresh=cfg.group.mask_thresh,
                                         box_chunk=box_chunk, id_base=tid * d,
                                         traced=traced)
        return label, score, gboxes, scores, own

    tiles_entry = _entry(tiles, traced)

    def infer_tiled(image) -> dict:
        image = torch.as_tensor(image)
        xs = [normalize_images(image.to(dv), cfg.data.mean, cfg.data.std) for dv in devs]
        parts = []
        for start in range(0, n_tiles, tile_batch):
            stop = min(start + tile_batch, n_tiles)
            runs = [(di, slice(lo, min(lo + per_dev, stop)))
                    for di, lo in enumerate(range(start, stop, per_dev))]
            outs = _parallel([lambda di=di, sl=sl: tiles_entry(di, xs[di], sl)
                              for di, sl in runs])
            parts.extend(tuple(t.to(devs[0]) for t in o) for o in outs)
        label, score, gboxes, scores, own = (torch.cat(p) for p in zip(*parts))
        g_label, g_score = stitch_tiles(label, score, origins_list, h, w)
        return {"label_map": g_label, "score_map": g_score,
                "boxes": gboxes.reshape(n_tiles * d, 4),
                "scores": scores.reshape(n_tiles * d),
                "valid": own.reshape(n_tiles * d)}

    return _entry(infer_tiled, traced)
