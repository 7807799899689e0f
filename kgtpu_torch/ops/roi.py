"""ROI crop and mask paste as separable-matmul resampling.  Counterpart of
`kgtpu/ops/roi.py::crop_and_resize` (bilinear and nearest),
`paste_masks_batch` and `paste_masks`.

Bilinear resampling is separable, so a crop or a paste is two matrix
products with banded tent-weight matrices:

    crop[j, i]  = sum_y sum_x  Wy[j, y] * img[y, x] * Wx[i, x]
    paste[y, x] = sum_j sum_i  Py[y, j] * mask[j, i] * Px[x, i]

Half-pixel centers: pixel i spans [i, i+1).  Crop output pixel j of R
samples the source at x0 + (j + 0.5) * (x1 - x0) / R, edge-clamped; paste
inverts that mapping.  The nearest crop (GT label maps in the train step)
selects source pixel floor(x0 + (j + 0.5) * (x1 - x0) / R), clamped: a
gather, exact for any dtype, where the JAX package multiplies by one-hot
rows.
"""

from __future__ import annotations

import torch

from kgtpu_torch.ops.control import cond


def crop_weights(start: torch.Tensor, extent: torch.Tensor, r: int,
                 n_src: int) -> torch.Tensor:
    """[..., r, n_src] bilinear weights: crop texel j <- source pixels."""
    j = torch.arange(r, dtype=torch.float32, device=start.device)
    pos = start[..., None] + (j + 0.5) * extent[..., None] / r - 0.5
    pos = torch.clamp(pos, 0.0, n_src - 1.0)
    src = torch.arange(n_src, dtype=torch.float32, device=start.device)
    return torch.clamp(1.0 - torch.abs(pos[..., None] - src), min=0.0)


def paste_weights(start: torch.Tensor, extent: torch.Tensor, r: int,
                  n_out: int) -> torch.Tensor:
    """[..., n_out, r] bilinear weights: image pixel y <- mask texels; rows of
    pixel centers outside the box are zero."""
    y = torch.arange(n_out, dtype=torch.float32, device=start.device) + 0.5
    mx = (y - start[..., None]) / torch.clamp(extent[..., None], min=1e-6) * r
    inside = (mx >= 0.0) & (mx <= r)
    pos = torch.clamp(mx - 0.5, 0.0, r - 1.0)
    tex = torch.arange(r, dtype=torch.float32, device=start.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - tex), min=0.0)
    return w * inside[..., None]


def nearest_index(start: torch.Tensor, extent: torch.Tensor, r: int,
                  n_src: int) -> torch.Tensor:
    """[..., r] source index of each nearest-neighbour crop texel."""
    j = torch.arange(r, dtype=torch.float32, device=start.device)
    pos = start[..., None] + (j + 0.5) * extent[..., None] / r
    return torch.clamp(torch.floor(pos), 0.0, n_src - 1.0).long()


def crop_and_resize(img: torch.Tensor, boxes: torch.Tensor,
                    out_size: int, method: str = "bilinear") -> torch.Tensor:
    """Crop each box, resized to out_size x out_size.

    img [B, H, W, C], boxes [B, D, 4] (x0, y0, x1, y1) in img's pixel coords
    -> [B, D, R, R, C] in img's dtype.  "bilinear": bf16 sources keep bf16
    operands (with f32 accumulation), others compute in f32; differentiable
    in `img`.  "nearest": an exact gather (label maps: ids are never
    blended).
    """
    b, h, w, c = img.shape
    d = boxes.shape[1]
    r = out_size
    if method == "nearest":
        boxes = boxes.float()
        iy = nearest_index(boxes[..., 1], boxes[..., 3] - boxes[..., 1], r, h)
        ix = nearest_index(boxes[..., 0], boxes[..., 2] - boxes[..., 0], r, w)
        bi = torch.arange(b, device=img.device)[:, None, None, None]
        return img[bi, iy[:, :, :, None], ix[:, :, None, :]]    # [B, D, R, R, C]
    if method != "bilinear":
        raise ValueError(f"unknown method {method!r}")
    cd = torch.bfloat16 if img.dtype == torch.bfloat16 else torch.float32
    boxes = boxes.float()
    wy = crop_weights(boxes[..., 1], boxes[..., 3] - boxes[..., 1], r, h).to(cd)
    wx = crop_weights(boxes[..., 0], boxes[..., 2] - boxes[..., 0], r, w).to(cd)
    tmp = torch.bmm(wy.reshape(b, d * r, h), img.to(cd).reshape(b, h, w * c))
    tmp = tmp.reshape(b, d, r, w, c)
    out = torch.einsum("bdix,bdjxc->bdjic", wx, tmp)
    return out.to(img.dtype)


def paste_masks_batch(masks: torch.Tensor, boxes: torch.Tensor,
                      scores: torch.Tensor, valid: torch.Tensor, height: int,
                      width: int, thresh: float = 0.5,
                      box_chunk: int = 32, id_base: int | torch.Tensor = 0,
                      traced: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Paste per-box mask probabilities into per-image instance maps.

    masks [B, D, r, r], boxes [B, D, 4] (image pixel coords), scores and
    valid [B, D].  Each pixel goes to the highest-scoring valid instance
    whose mask exceeds `thresh` there (ties: the lowest slot).  Slots run in
    chunks of `box_chunk`; a chunk with no valid slot in any image is
    skipped: by one host-side check for the whole batch, or with `traced`
    by a cond per chunk (kgtpu's lax.cond; `ops/control.cond`), which
    `torch.export` can trace.  A skipped chunk would change nothing.  `id_base` is an int
    or a per-image [B] int tensor (the tiled path passes tile index x D).

    Returns (label_map [B, H, W] int32, 0 = background, id_base[i] + d + 1
    = slot d of image i; score_map [B, H, W] float32).
    """
    b, d, r, _ = masks.shape
    dev = masks.device
    pad = (-d) % box_chunk
    if pad:
        masks = torch.nn.functional.pad(masks, (0, 0, 0, 0, 0, pad))
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    n_chunks = masks.shape[1] // box_chunk
    live_chunks = valid.reshape(b, n_chunks, box_chunk).any(dim=2).any(dim=0)
    base = torch.as_tensor(id_base, dtype=torch.int32, device=dev).expand(b)
    base = base[:, None, None] + 1
    label = torch.zeros((b, height, width), dtype=torch.int32, device=dev)
    best = torch.zeros((b, height, width), dtype=torch.float32, device=dev)

    def paste(ci, label, best, masks, boxes, scores, valid, base):
        sl = slice(ci * box_chunk, (ci + 1) * box_chunk)
        box = boxes[:, sl].float()
        py = paste_weights(box[..., 1], box[..., 3] - box[..., 1], r, height)
        px = paste_weights(box[..., 0], box[..., 2] - box[..., 0], r, width)
        vals = torch.matmul(torch.matmul(py, masks[:, sl].float()),
                            px.transpose(-1, -2))          # [B, ch, H, W]
        fg = (vals > thresh) & valid[:, sl, None, None]
        cand = torch.where(fg, scores[:, sl, None, None].float(),
                           torch.full_like(vals, -1.0))
        win_score, winner = cand.max(dim=1)               # first occurrence
        win_id = (ci * box_chunk + winner).to(torch.int32) + base
        better = (win_score > 0) & (win_score > best)
        return torch.where(better, win_id, label), torch.where(better, win_score, best)

    operands = (masks, boxes, scores, valid, base)
    if traced:
        for ci in range(n_chunks):
            label, best = cond(live_chunks[ci], lambda *a, ci=ci: paste(ci, *a),
                               lambda lb, bs, *_: (lb.clone(), bs.clone()),
                               (label, best, *operands))
        return label, best
    for ci in torch.nonzero(live_chunks).flatten().tolist():
        label, best = paste(ci, label, best, *operands)
    return label, best


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, height: int, width: int, thresh: float = 0.5,
                box_chunk: int = 8, id_base: int | torch.Tensor = 0,
                init: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One image: masks [D, r, r], boxes [D, 4], scores and valid [D] ->
    (label_map [H, W] int32, score_map [H, W] float32), instance d written
    as id_base + d + 1.  With `init` = (label_map, score_map), pasting starts
    from that carry: a pixel takes a new instance only where the instance's
    score is above 0 and above the carried score (ties keep the carry)."""
    label, best = paste_masks_batch(masks[None], boxes[None], scores[None],
                                    valid[None], height, width, thresh,
                                    box_chunk, id_base)
    label, best = label[0], best[0]
    if init is None:
        return label, best
    init_label, init_best = init
    init_best = init_best.to(torch.float32)
    better = (best > 0) & (best > init_best)
    return (torch.where(better, label, init_label.to(torch.int32)),
            torch.where(better, best, init_best))
