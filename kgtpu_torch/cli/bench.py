"""Headline benchmark of the port: end-to-end two-stage inference img/s.

    python -m kgtpu_torch.cli.bench [--device cuda]

The protocol of kgtpu's `bench.py`, re-run in torch: the default `Config`
(2-stack hourglass, 128 channels) with seeded random weights, raw uint8
[32, 512, 512, 3] on the card, and 24 valid detections pinned per image
(`seeded_dets`): an untrained net finds next to nothing, and the mask stage
skips slot chunks without a valid detection, so an unpinned run would skip
it.  One timed call is normalize -> backbone + heads -> decode/group/NMS ->
mask stage on the pinned detections -> paste, reduced to a scalar that the
host reads.  A repeat times `iters` back-to-back calls with the host clock
and ends on that read; the JSON line gives the median of REPEATS repeats
with their min and max.

`gflops_per_img` counts the floating-point operations of one timed call with
`torch.utils.flop_counter.FlopCounterMode` (convolutions and matmuls, the
operators it has formulas for), `mfu` sets them against the card's dense
bf16 peak.  `decode_group_ms_per_img` follows kgtpu's
`benchmarks/bench_decode_group.py`: [16, 128, 128, 5] heatmap logits of low
background with 64 planted peaks per image, decode -> group -> NMS.

No TPU number is a baseline for the port: `vs_baseline` is null.  A run on
the CPU (`--device cpu`) says so in "backend" and "device".
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kgtpu_torch.config import Config
from kgtpu_torch.device import resolve_device
from kgtpu_torch.infer import detect_batch, mask_batch
from kgtpu_torch.ops.decode import decode_peaks
from kgtpu_torch.ops.group import Boxes, group_keypoints
from kgtpu_torch.ops.nms import box_nms
from kgtpu_torch.ops.preprocess import normalize_images

BATCH = 32
PINNED_DETS = 24
REPEATS = 5                        # timed runs; the line gives their median, min and max
ITERS = 10                         # timed calls per repeat
DECODE_GROUP_BATCH = 16            # bench_decode_group.py's batch
BF16_DENSE_FLOPS = 989e12          # H100 SXM, dense bf16 tensor-core peak


def seeded_dets(cfg: Config, batch: int, seed: int, ndets: int = PINNED_DETS,
                device: str | torch.device = "cuda") -> Boxes:
    """Detections pinned like kgtpu's bench (`benchmarks/common.py::
    pin_valid_dets`): the first `ndets` slots of every image valid.  The
    boxes come from a seed: sides of 1/16 to 1/3.2 of the stride-4 map (8-40
    stride px at 512x512), inside the map, scores descending."""
    rng = np.random.default_rng(seed)
    d = cfg.group.max_detections
    side = cfg.infer.input_size / cfg.data.stride
    wh = rng.uniform(side / 16, side / 3.2, (batch, d, 2))
    xy = rng.uniform(0, side - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.2, 1.0, (batch, d)), axis=1)[:, ::-1].astype(np.float32)
    valid = np.zeros((batch, d), bool)
    valid[:, :ndets] = True
    scores[~valid] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Boxes(boxes=t(boxes), scores=t(scores), valid=t(valid))


@torch.inference_mode()
def pinned_call(model, cfg: Config, images: torch.Tensor, dets: Boxes) -> tuple:
    """Detect on `images` (raw uint8 on the model's device), then run the
    mask stage on the pinned `dets`.  Returns (detections, mask output)."""
    x = normalize_images(images, cfg.data.mean, cfg.data.std)
    found, feats = detect_batch(model, cfg, x)
    return found, mask_batch(model, cfg, feats, dets, images.shape[1], images.shape[2])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _repeat(call, device, iters: int) -> list[float]:
    """Seconds per call of `call` (which returns a 0-d tensor) in each of
    REPEATS runs of `iters` back-to-back calls, each ended by reading the
    results on the host."""
    call().item()
    call().item()
    out = []
    for _ in range(REPEATS):
        _sync(device)
        t = time.perf_counter()
        vals = [call() for _ in range(iters)]
        sum(v.item() for v in vals)
        out.append((time.perf_counter() - t) / iters)
    return out


def e2e_bench(model, cfg: Config, batch: int = BATCH, ndets: int = PINNED_DETS,
              iters: int = ITERS, seed: int = 0) -> dict:
    """img/s of the pinned two-stage call (median, min, max over REPEATS),
    and its floating-point operations per image."""
    from torch.utils.flop_counter import FlopCounterMode
    device = next(model.parameters()).device
    size = cfg.infer.input_size
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3),
                                           dtype=np.uint8)).to(device)
    dets = seeded_dets(cfg, batch, seed=seed + 2, ndets=ndets, device=device)

    def call():
        _, out = pinned_call(model, cfg, images, dets)
        return out["label_map"].sum() + out["scores"].sum()

    with FlopCounterMode(display=False) as counter:
        call()
    flops_img = counter.get_total_flops() / batch
    rates = [batch / s for s in _repeat(call, device, iters)]
    return {"img_per_s": statistics.median(rates), "img_per_s_min": min(rates),
            "img_per_s_max": max(rates), "img_per_s_all": rates,
            "flops_per_img": flops_img, "batch": batch, "pinned_dets_per_img": ndets,
            "repeats": REPEATS, "iters": iters}


def decode_group_bench(cfg: Config, device: str | torch.device,
                       batch: int = DECODE_GROUP_BATCH, iters: int = ITERS,
                       seed: int = 0) -> dict:
    """ms/img of decode -> group -> NMS on kgtpu's decode+group bench maps
    (median, min, max over REPEATS)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    hm = rng.normal(-4.0, 0.5, size=(batch, 128, 128, 5)).astype(np.float32)
    for b in range(batch):
        for _ in range(64):
            y, x = rng.integers(2, 126, 2)
            hm[b, y, x, :] = rng.normal(2.0, 1.0, 5)
    reg = rng.uniform(-0.5, 0.5, size=(batch, 128, 128, 2)).astype(np.float32)
    hm_t, reg_t = torch.from_numpy(hm).to(device), torch.from_numpy(reg).to(device)

    @torch.inference_mode()
    def call():
        peaks = decode_peaks(hm_t, reg_t, cfg.group.max_peaks_per_class)
        d = box_nms(group_keypoints(peaks, cfg.group), cfg.group.nms_iou)
        return d.boxes.sum() + d.scores.sum() + d.valid.sum()

    ms = [1e3 * s / batch for s in _repeat(call, device, iters)]
    return {"ms_per_img": statistics.median(ms), "ms_per_img_min": min(ms),
            "ms_per_img_max": max(ms), "batch": batch}


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", f"--id={device.index or 0}"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def run(device: str) -> dict:
    from kgtpu_torch.models import build_model
    device = resolve_device(device)
    cfg = Config()
    model = build_model(cfg.model, seed=0, device=device)
    e2e = e2e_bench(model, cfg, batch=BATCH, ndets=PINNED_DETS, iters=ITERS)
    dg = decode_group_bench(cfg, device, batch=DECODE_GROUP_BATCH, iters=ITERS)
    mfu = (e2e["flops_per_img"] * e2e["img_per_s"] / BF16_DENSE_FLOPS
           if device.type == "cuda" else None)
    return {
        "metric": f"e2e_images_per_sec_{cfg.infer.input_size}",
        "value": e2e["img_per_s"], "unit": "img/s",
        "value_min": e2e["img_per_s_min"], "value_max": e2e["img_per_s_max"],
        "repeats": e2e["repeats"], "iters_per_repeat": e2e["iters"],
        "vs_baseline": None, "batch": e2e["batch"],
        "pinned_dets_per_img": e2e["pinned_dets_per_img"],
        "gflops_per_img": e2e["flops_per_img"] / 1e9, "mfu": mfu,
        "decode_group_ms_per_img": dg["ms_per_img"],
        "decode_group_ms_per_img_min": dg["ms_per_img_min"],
        "decode_group_ms_per_img_max": dg["ms_per_img_max"],
        "decode_group_batch": dg["batch"],
        "backend": device.type, "device": card_name(device),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m kgtpu_torch.cli.bench",
                                description="e2e img/s of the port (bench.py protocol)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
