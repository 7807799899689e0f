"""Fixed-shape batching and background prefetch: counterpart of
`kgtpu/data/loader.py`.

The host assembles images and instance geometry into fixed-shape NumPy
arrays; the train step renders the dense targets on the device.  A small
thread pool overlaps the host's decoding and augmentation with the device's
steps: the warps are torch ops on CPU tensors, which release the
interpreter lock.  A batch is

  image      uint8   [B, S, S, 3]
  img_gain   float32 [B, 3]     colour jitter, applied on the device
  img_bias   float32 [B, 3]
  boxes      float32 [B, N, 4]  (x0, y0, x1, y1) input pixels, area-ranked
  valid      float32 [B, N]
  label_map  uint16  [B, S, S]  id k + 1 <-> slot k, 0 background
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator

import numpy as np

from kgtpu_torch.config import DataConfig
from kgtpu_torch.data import transforms

Batch = dict


def prepare_sample(sample: dict, cfg: DataConfig, augment: bool = False,
                   image_only: bool = True,
                   rng: np.random.Generator | None = None) -> dict:
    """One sample on the cfg.input_size² canvas: {"image" uint8 [S, S, 3],
    "img_gain", "img_bias" (3,) f32, "label_map"}; with image_only=False also
    the slot contract ("boxes", "valid" and the renumbered label map).

    Without augment, the letterbox-free resize (`transforms.resize_sample`),
    gain ones and bias zeros.  With augment, `rng` draws, in kgtpu's order:
    the affine (scale, rotation, flip, crop jitter), the elastic field when
    cfg.elastic_alpha > 0, then the colour jitter's gain and bias when
    cfg.color_jitter > 0."""
    if augment:
        if rng is None:
            raise ValueError("augment=True needs an rng")
        m = transforms.random_affine_params(
            rng, cfg.input_size, sample["label_map"].shape,
            scale_range=cfg.scale_range, rotate_deg=cfg.rotate_deg,
            flip_prob=cfg.flip_prob)
        s = transforms.apply_affine(sample, m, cfg.input_size)
        if cfg.elastic_alpha > 0:
            field = transforms.random_elastic_field(
                rng, cfg.input_size, cfg.elastic_alpha, cfg.elastic_sigma)
            s = transforms.apply_elastic(s, field)
    else:
        s = transforms.resize_sample(sample, cfg.input_size)
    gain = np.ones(3, np.float32)
    bias = np.zeros(3, np.float32)
    if augment and cfg.color_jitter > 0:
        cj = cfg.color_jitter
        gain = rng.uniform(1 - cj, 1 + cj, 3).astype(np.float32)
        bias = (rng.uniform(-cj, cj, 3) * 30).astype(np.float32)
    out = {"image": np.ascontiguousarray(s["image"]), "img_gain": gain,
           "img_bias": bias, "label_map": s["label_map"]}
    if not image_only:
        boxes, valid, remap = transforms.boxes_from_label_map(
            s["label_map"], cfg.max_instances)
        out.update(boxes=boxes, valid=valid,
                   label_map=transforms.renumber_label_map(s["label_map"], remap))
    return out


def make_batch(dataset, indices, cfg: DataConfig, augment: bool,
               rng: np.random.Generator | None = None,
               rngs: list[np.random.Generator] | None = None) -> Batch:
    """The batch of `indices`: either one shared `rng` (sequential
    per-sample draws) or one generator per sample (`rngs`, the iterator's
    mode: each sample's augmentation then depends on its position alone).
    The label map is cast to uint16 (ids <= max_instances)."""
    if rngs is None:
        rngs = [rng] * len(indices)
    samples = [prepare_sample(dataset[i], cfg, augment, image_only=False, rng=r)
               for i, r in zip(indices, rngs)]
    out = {k: np.stack([s[k] for s in samples]) for k in
           ("image", "img_gain", "img_bias", "boxes", "valid", "label_map")}
    out["label_map"] = out["label_map"].astype(np.uint16)
    return out


def stack_batches(batches: list[Batch]) -> Batch:
    """Stack k batches on a leading steps axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def batch_iterator(dataset, cfg: DataConfig, batch_size: int, *,
                   augment: bool = True, shuffle: bool = True, seed: int = 0,
                   steps: int | None = None, prefetch: int = 8,
                   num_workers: int = 4, process_id: int = 0,
                   num_processes: int = 1) -> Iterator[Batch]:
    """Infinite (or `steps`-bounded) iterator of fixed-shape batches, equal
    to kgtpu's for the same arguments.

    Each epoch walks a permutation of the dataset drawn from
    default_rng(seed) (full batches only).  Batches are built on a pool of
    `num_workers` threads, at most `prefetch` ahead, and come out in order;
    sample j of batch b draws from default_rng(((seed + 1) * 1_000_003 + b)
    * 8191 + j), so a batch does not depend on the number of workers.  With
    (process_id, num_processes) each process builds its batch_size /
    num_processes rows of the global batch; the rows of all processes, in
    order, make the single-process batch."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} samples < batch_size {batch_size}; "
            "the iterator would produce no batches")
    if batch_size % num_processes:
        raise ValueError(f"batch_size {batch_size} must divide by "
                         f"num_processes {num_processes}")
    local_bs = batch_size // num_processes
    lo = process_id * local_bs

    def index_stream():
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield order[i:i + batch_size]

    stream = index_stream()

    def build(batch_idx: int, indices) -> Batch:
        base = ((seed + 1) * 1_000_003 + batch_idx) * 8191
        rngs = [np.random.default_rng(base + lo + j) for j in range(local_bs)]
        return make_batch(dataset, indices[lo:lo + local_bs], cfg, augment,
                          rngs=rngs)

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=num_workers)
    pending: collections.deque = collections.deque()
    try:
        bi = 0
        while steps is None or bi < steps:
            while len(pending) < prefetch and (steps is None or bi < steps):
                pending.append(ex.submit(build, bi, next(stream)))
                bi += 1
            if not pending:
                return
            yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=False, cancel_futures=True)
