#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (kgtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

[1] Builds both kernels of kgtpu_torch/csrc with nvcc, in parallel.
[2] Holds the GroupNorm(+ReLU) kernel against its plain PyTorch version at
    every shape the serving path gives it, at batch 1, 8 and 32, at the
    unet's and resnet_fpn's shapes (C = 256 and 512 at batch 1, 8 and 32),
    at the shapes of the 0.75 and 1.25 TTA scales (384x384 and 640x640
    inputs, the hourglass's and the unet's), and
    at odd shapes (an H*W no part size divides, C = 48, C = 100 and a misaligned
    pointer, which take its one-element path); three calls on one input
    must give bitwise-equal outputs and count three launches, and the
    profiler must see one launch per call.
[3] Serves the default Config at full width (2-stack hourglass, 128
    channels, 512x512, seeded random weights) through `build_infer_fn` and
    `Predictor`, and checks that the kernel served the backbone and the mask
    head.
[4] Compares the whole serving path against the plain GroupNorm, and times
    the kernel and the end-to-end path (and its stages; `--profile` adds a
    torch.profiler table of the e2e call's kernels and the device's idle
    share, and one of a train step in [6]).  Times the GroupNorm kernel at
    every shape of the batch-32 e2e call: CUDA-event and device ms, HBM
    bound, launches per call and the wrapper's host enqueue time.
[5] Holds the Gaussian target kernel against its plain version on hard
    cases (empty and full images, border-touching and tiny boxes, two
    instances on one pixel, a ragged height and width, sizes whose radius
    lies just below or above an integer) and times it.
[6] Trains the default Config at full width (batch 8, 512x512) for 20 steps
    on one seeded batch: the loss with kernel targets equals the loss with
    plain targets, each step launches the Gaussian kernel once and the
    GroupNorm kernel never, every parameter gets a finite gradient, and the
    loss falls.  Times train img/s and peak memory.
[7] Serves from the trained model, through the GroupNorm kernel again.
[8] Serves the trained flagship through the port's own entry points:
    `Predictor.from_checkpoint` on the committed EMA weights
    (assets_torch/flagship_ema), then `python -m kgtpu_torch.cli.test
    --dataset folder` (called in-process) on the 16 committed synthetic_hard
    images at 512x512, batch 16, once in the stored bf16 and once in f32, and
    scores both with the port's evaluate against the committed ground truth:
    mAP_dsb2018 within 0.01 (f32) and 0.02 (bf16) of kgtpu's committed
    reference run; in f32 also every image's instance count equal to
    kgtpu's and at most 16 label-map pixels off its map (a bf16 run is
    thousands off).  The bf16 run must launch the GroupNorm kernel.
[9] Trains from the command line: `python -m kgtpu_torch.cli.train`, called
    in-process, at full width (the default Config, batch 8, 512x512, EMA,
    lr 1e-3 after 50 warmup steps) on `synthetic` (64 generated images,
    rotation up to 15 degrees) for CLI_EPOCHS epochs of CLI_STEPS steps,
    evaluated on the 16 val images at the last one, then `--resume` for one
    more epoch.  Requires: the EMA weights' val mAP_dsb2018 and AP50 above
    their floors; a Gaussian launch every step; at least 58 GroupNorm
    launches per eval batch of 8 (raw and EMA weights) and none in
    training; best.json naming a checkpoint that exists; exactly
    --keep_last checkpoint directories; one metrics.jsonl line per epoch;
    the resumed run starting at the saved epoch and step; and `cli.test`
    on the best checkpoint, serving the 16 val images, giving the label
    maps of the in-training eval.  Times the CLI's steady img/s (eval and
    saves excluded), its wait for batches per step, and the host's ms per
    augmented 512x512 sample.
[10] TTA, ensemble and tiling with the flagship, through `cli.test` called
    in-process, in f32 and in bf16: `--test_scales 0.75,1.0,1.25
    --test_flip` (mean vote, batch 8) on the 16 committed images;
    `--ensemble` of the EMA weights (mask member) and the raw weights
    (assets_torch/flagship_raw) at scale 1.0; `--tiled --input_size 1024`
    (tiles of 512, overlap 64: 9 a slide) on four 1024x1024 slides, each a
    2x2 mosaic of four of the images in id order.  Held against kgtpu's
    committed f32 runs (assets_torch/kgtpu_reference_tta.npz): in f32 every
    instance count equal, at most 16 label-map pixels off per 512x512 image
    and 64 per slide, mAP_dsb2018 within 0.01; in bf16 mAP_dsb2018 within
    0.02.  Every run must launch the GroupNorm kernel.  Times TTA img/s (3
    scales + flip, batch 8, bf16: median of 5 repeats with min and max) and
    s per 2048x2048 slide (a 4x4 mosaic of the 16 images, 25 tiles), bf16.
[11] The other backbones, norms and decoders.  (a) The unet quality flagship
    (assets_torch/unet_ema: 128 channels, hg_depth 4, GroupNorm) through
    `cli.test` on the 16 images in f32 and bf16, and (b) the heterogeneous
    ensemble (--weights the unet, --ensemble the hourglass flagship, mean
    vote) likewise, held against kgtpu's committed runs
    (assets_torch/kgtpu_reference_unet.npz) with [8]'s gates.  (c) The
    unet's batch-32 512x512 e2e call with random weights: label maps against
    the plain GroupNorm (>= 0.98 of pixels equal), img/s as the median of 5
    repeats with min and max, and the GroupNorm kernel at every shape of the
    call (C up to 512).  (d) resnet_fpn, hourglass_fast, inter_inject,
    norm=batch and --decode centernet at full width, batch 8, 512x512, random
    weights: served with the kernel and with the plain GroupNorm (>= 0.98 of
    label pixels equal; norm=batch runs no GroupNorm and is served twice,
    bitwise equal), then 5 train steps with a finite loss that falls.  (e)
    remat on the default hourglass: 3 steps with and without it give the
    same losses (rtol 1e-5) at a lower peak memory, and with norm=batch the
    same running stats.

[12] Users' own files.  (a) Decodes every fixture of assets_torch/formats
    (baseline JPEG at 512x512; progressive JPEG, tiled deflate+predictor
    TIFF, LZW strip TIFF, 16-bit RGB TIFF and 24-bit BMP at 256x256; the
    neural-cells tree's TIFF images and PNG/BMP/TIFF masks) in every mode
    with the port's readers and requires the sha256, shape and dtype of
    cv2's decode (assets_torch/kgtpu_reference_formats.npz); times each
    format (median of 3 reads, ms per image and per 512x512 of pixels,
    beside the committed PNGs); prints whether cv2 or PIL is importable
    here, for the record (the port uses neither).  (b) `cli.test --dataset
    folder` over the 16 baseline JPEGs with the flagship in f32 and bf16,
    held against kgtpu's committed run on those JPEGs with [8]'s gates, the
    GroupNorm kernel launched; the CLI's img/s beside [8]'s PNG folder; one
    more `cli.test` over the mixed folder, which must serve every file (the
    16-bit and the tiled TIFFs too).  (c) `cli.train` at the default Config
    (full width, 512x512, batch 8) for 10 steps on `--dataset coco` and 5 on
    `--dataset neural_cells`, the datasets built in a temporary directory
    from the fixtures: every sample's image and label map equal to kgtpu's
    readers' (by sha256), a finite loss, one Gaussian launch per step.  (d)
    The host-RSS watchdog in a subprocess (`os.execv` would replace this
    script): `python -m kgtpu_torch.cli.train` at a small size for 2 epochs
    with --rss_limit_gb 0.001 re-execs exactly once, resumes at epoch 1,
    writes two metrics.jsonl lines and exits 0.  Budget FORMATS_PHASE_S.

The e2e img/s of [4] is the headline bench's (`kgtpu_torch.cli.bench`): the
median of 5 repeats of 10 calls, with their min and max.  The metrics line's
`decode_group_ms_per_img` is the decode+group+NMS stage of the batch-32 e2e
call, per image, as in earlier runs; the bench's own protocol (batch 16,
planted peaks) is `decode_group_bench_ms_per_img_b16`.

Exits non-zero without a result line when CUDA is missing or any check
fails.  Builds into kgtpu_torch/_build/; the CLI outputs of [8] go to a
temporary directory that is removed.

The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.  TF32 is off for every phase (cuDNN and matmul), so
f32 comparisons are full f32; the model itself computes in bf16.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 900            # the run's limit is 1200 s
TOL = {"bfloat16": 0.05, "float32": 2e-4}   # tests/test_pallas.py's tolerances
LABEL_AGREEMENT_FLOOR = 0.98
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# expf goes through the special-function units: 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
GAUSS_F32_OPS = 8           # f32 operations beside the expf per (pixel, class, instance)
GAUSS_TOL = 1e-6
TRAIN_STEPS = 20
TRAIN_LOSS_RTOL = 1e-5
PINNED_DETS = 24
E2E_BATCH = 32
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets_torch")
# phase [8]: the flagship's mAP_dsb2018 on the card against kgtpu's reference
MAP_TOL = {"float32": 0.01, "bfloat16": 0.02}
COUNT_TOL = 1               # instances on one image, from_checkpoint (bf16)
PIXELS_OFF_TOL = 16         # label-map pixels per image off kgtpu's, f32 CLI run
# phase [9]: the training CLI.  Floors at about 70% of the EMA val metrics
# this run reached on an H100 80GB HBM3 at 700 W (mAP_dsb2018 0.6437, AP50
# 0.8143 after 240 steps), as tests/test_e2e.py sets its floors
CLI_STEPS, CLI_EPOCHS, CLI_KEEP = 40, 6, 2
GN_PER_FORWARD = 58         # GroupNorm launches of one full-width forward
CLI_MAP_FLOOR, CLI_AP50_FLOOR = 0.45, 0.57
CLI_PHASE_S = 300           # phase [9]'s budget
# GroupNorm shapes of the main path at 512x512, NCHW (B = 8; the mask head
# sees batch x mask_chunk crops)
GN_SHAPES = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 128, 64, 64),
             (8, 128, 32, 32), (8, 128, 16, 16), (8, 128, 8, 8),
             (8 * 32, 64, 32, 32)]
GN_LEVELS = [(64, 256, 256), (128, 128, 128), (128, 64, 64), (128, 32, 32),
             (128, 16, 16), (128, 8, 8)]
# batch 1 and 32 at every level, and shapes that take the kernel's other
# paths: an H*W no part size divides, C = 48 (G = 24), C = 100 (vec = 1 in
# bf16); the last flag misaligns x by one element (vec = 1 in f32 too)
GN_MORE = ([((1, *lvl), False) for lvl in GN_LEVELS]
           + [((32, *lvl), False) for lvl in GN_LEVELS]
           + [((3, 128, 37, 41), False), ((4, 48, 24, 40), False),
              ((2, 100, 20, 30), False), ((2, 128, 33, 17), True)])
# the GroupNorm shapes the 0.75 and 1.25 TTA scales add (384x384 and 640x640
# inputs, B = 8): the backbone's first and second levels and its deepest
GN_TTA_SHAPES = [(8, 64, 192, 192), (8, 128, 96, 96), (8, 128, 6, 6),
                 (8, 64, 320, 320), (8, 128, 160, 160), (8, 128, 10, 10)]
# the unet's levels at 512x512 beyond the hourglass's (C = 256 at 64x64, 512
# at 32, 16 and 8), resnet_fpn's stride-2 Residual at 128x128, and the unet's
# levels at the 0.75 and 1.25 TTA scales
GN_UNET_LEVELS = [(256, 64, 64), (512, 32, 32), (512, 16, 16), (512, 8, 8)]
GN_BACKBONE_SHAPES = ([(b, *lvl) for b in (1, 8, 32) for lvl in GN_UNET_LEVELS]
                      + [(8, 64, 128, 128)]
                      + [(8, 256, 48, 48), (8, 512, 24, 24), (8, 512, 12, 12), (8, 512, 6, 6),
                         (8, 256, 80, 80), (8, 512, 40, 40), (8, 512, 20, 20),
                         (8, 512, 10, 10)])
TIMED_SHAPE = (32, 128, 128, 128)
# phase [10]: TTA, ensemble and tiling with the flagship
TTA_RUNS = {   # name: (data, test.py's flags beside --weights and the data dir, side)
    "tta": ("images", ["--use_ema", "--test_scales", "0.75,1.0,1.25", "--test_flip",
                       "--batch_size", "8"], 512),
    "ensemble": ("images", ["--use_ema", "--ensemble", os.path.join(ASSETS, "flagship_raw"),
                            "--test_scales", "1.0", "--batch_size", "8"], 512),
    "tiled": ("slides", ["--use_ema", "--tiled", "--input_size", "1024"], 1024),
}
SLIDE_PIXELS_OFF_TOL = 64   # label-map pixels per 1024x1024 slide, f32 CLI run
TTA_REPEATS = 5
TTA_PHASE_S = 180           # phase [10]'s budget
# phase [11]: the other backbones, norms and decoders
UNET_RUNS = {   # name: test.py's flags beside --weights unet_ema and the data dir
    "unet": ["--use_ema", "--batch_size", "8"],
    "ensemble": ["--use_ema", "--ensemble", os.path.join(ASSETS, "flagship_ema"),
                 "--tta_vote", "mean", "--test_scales", "1.0", "--batch_size", "8"],
}
VARIANTS = {    # name: (ModelConfig fields, GroupConfig fields)
    "resnet_fpn": ({"backbone": "resnet_fpn"}, {}),
    "hourglass_fast": ({"backbone": "hourglass_fast"}, {}),
    "inter_inject": ({"inter_inject": True}, {}),
    "norm_batch": ({"norm": "batch"}, {}),
    "centernet": ({}, {"method": "centernet"}),
}
VARIANT_STEPS = 5
REMAT_STEPS = 3
BACKBONES_PHASE_S = 150     # phase [11]'s budget
# phase [12]: users' own files
FORMATS = os.path.join(ASSETS, "formats")
FORMAT_KINDS = {   # timed kind: (folder, file-name suffix)
    "baseline JPEG": (os.path.join(FORMATS, "jpeg"), ".jpg"),
    "progressive JPEG": (os.path.join(FORMATS, "mixed"), "_progressive.jpg"),
    "tiled deflate+predictor TIFF": (os.path.join(FORMATS, "mixed"), "_tiled.tif"),
    "LZW strip TIFF": (os.path.join(FORMATS, "mixed"), "_lzw.tif"),
    "16-bit RGB TIFF": (os.path.join(FORMATS, "mixed"), "_rgb16.tif"),
    "24-bit BMP": (os.path.join(FORMATS, "mixed"), ".bmp"),
    "PNG (committed synthetic_hard)": (os.path.join(ASSETS, "synthetic_hard", "images"), ".png")}
TRAIN_FORMAT_STEPS = {"coco": 10, "neural_cells": 5}
WATCHDOG_FLAGS = ["--dataset", "synthetic", "--synthetic_n", "8", "--input_size", "64",
                  "--batch_size", "2", "--steps_per_epoch", "2", "--num_epochs", "2",
                  "--backbone", "hourglass_lite", "--num_stacks", "1", "--roi_size", "8",
                  "--mask_size", "16", "--K", "32", "--max_detections", "32",
                  "--rss_limit_gb", "0.001"]
FORMATS_PHASE_S = 150       # phase [12]'s budget


def require(cond, msg: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(torch, fn, names, launches_per_call: int, launched,
                     iters: int = 20) -> float:
    """Device time per call of `fn` spent in the kernels whose names hold
    one of `names`, from torch.profiler over `iters` calls.  In every
    window the wrapper's own count (`launched()`) must rise by
    `launches_per_call` a call, or this fails at once: a kernel that skips
    a launch is never measured again.  The profiler then has to see as many
    kernel records.  It has been seen to keep too few (2 of 20 missing in
    two windows in a row; after [10]'s profiled call, the first window of
    each later measurement keeps 0 or 4 device records of any kind) while
    the wrapper's count was whole, so a shortfall that is the profiler's
    alone is measured up to four more times before it fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want, attempts = iters * launches_per_call, 5
    for attempt in range(attempts):
        before = launched()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        made = launched() - before
        require(made == want, f"the wrapper launched {names} {made} times in {iters} calls, "
                f"want {want}")
        device = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU]
        rows = [e for e in device if any(n in e.key for n in names)]
        count = sum(e.count for e in rows)
        if count == want:
            return sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / iters / 1e3
        log(f"  profiler saw {count} launches of {names} in {iters} calls, want {want}; "
            f"the wrapper launched all {made}; device records of any kind in the window: "
            f"{sum(e.count for e in device)}"
            + ("; measuring again" if attempt < attempts - 1 else ""))
    require(False, f"profiler saw {count} launches of {names} in {iters} calls")


def gn_input(torch, src, dtype, misalign: bool):
    """`src` [B, H, W, C] as an NCHW tensor of `dtype` laid out channels-last;
    with `misalign`, it starts one element past a 16-byte boundary."""
    n, m = src.numel(), int(misalign)
    base = torch.empty(n + 1, device="cuda", dtype=dtype)
    nhwc = base[m:m + n].view(src.shape)
    nhwc.copy_(src)
    return nhwc.permute(0, 3, 1, 2)


def phase_kernel_vs_plain(torch, gn) -> dict:
    """Kernel vs plain at every main-path shape (batch 8), at batch 1 and 32
    and at odd shapes, relu on/off, bf16 and f32, each called three times:
    the outputs must be bitwise equal.  Then kernel, plain and library times
    at TIMED_SHAPE."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for shape, misalign in ([(s, False) for s in GN_SHAPES + GN_TTA_SHAPES + GN_BACKBONE_SHAPES]
                            + GN_MORE):
        c = shape[1]
        groups = gn.num_groups(c)
        w = torch.randn(c, device="cuda", generator=g) * 0.2 + 1.0
        b = torch.randn(c, device="cuda", generator=g) * 0.5
        bs, _, h, wd = shape
        src = torch.randn((bs, h, wd, c), device="cuda", generator=g) * 3.0 + 2.0
        for dtype in ("bfloat16", "float32"):
            x = gn_input(torch, src, getattr(torch, dtype), misalign)
            require(x.is_contiguous(memory_format=torch.channels_last)
                    and (x.data_ptr() % 16 != 0) == misalign, "test input layout")
            errs = []
            for relu in (False, True):
                before = gn.launches
                runs = [gn.group_norm_relu(x, w, b, groups, relu) for _ in range(3)]
                want = gn.group_norm_relu_reference(x, w, b, groups, relu)
                torch.cuda.synchronize()
                require(gn.launches == before + 3, f"{gn.launches - before} launches in 3 "
                        f"calls at {shape} {dtype}")
                got = runs[0]
                require(got.dtype == x.dtype and got.shape == x.shape, "kernel output dtype/shape")
                require(got.is_contiguous(memory_format=torch.channels_last),
                        "kernel output is not channels_last")
                require(all(torch.equal(got, r) for r in runs[1:]),
                        f"three calls at {shape} {dtype} relu={relu} are not bitwise equal")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                excess = float((diff - TOL[dtype] * (1 + want.float().abs())).max())
                require(excess <= 0, f"kernel disagrees with plain at {shape} {dtype} "
                        f"relu={relu}: max_abs_err {err}")
                errs.append(err)
                max_err = max(max_err, err)
            log(f"  gn {str(list(shape)):20s} {dtype:8s}{' misaligned' if misalign else ''} "
                f"max_abs_err relu=0 {errs[0]:.3g}, relu=1 {errs[1]:.3g} (tol {TOL[dtype]} "
                f"abs+rel); 3 calls bitwise equal")
            del x
        del src
    log("  every case within tolerance, every repeat bitwise equal")

    c = TIMED_SHAPE[1]
    x = torch.randn(TIMED_SHAPE, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(c, device="cuda", generator=g) * 0.2 + 1.0
    b = torch.randn(c, device="cuda", generator=g) * 0.5
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ms = cuda_time_ms(lambda: gn.group_norm_relu(x, w, b, 32, True))
    device_ms = kernel_device_ms(torch, lambda: gn.group_norm_relu(x, w, b, 32, True),
                                 ("group_norm_kernel",), 1, lambda: gn.launches)
    plain_ms = cuda_time_ms(lambda: gn.group_norm_relu_reference(x, w, b, 32, True))
    lib_ms = cuda_time_ms(lambda: torch.relu(F.group_norm(x, 32, wl, bl, eps=gn.EPS)))
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    log(f"  timed shape {list(TIMED_SHAPE)} bf16 relu: kernel {ms:.4f} ms (device time "
        f"{device_ms:.4f} ms, torch.profiler, one launch per call), plain "
        f"{plain_ms:.4f} ms, library F.group_norm+relu {lib_ms:.4f} ms, HBM bound "
        f"{bound_ms:.4f} ms (2 * numel * 2 B at 3.35 TB/s)")
    return {"max_abs_err": max_err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms}


def gn_shape_counts(call) -> dict:
    """{shape: launches} of the GroupNorm kernel in one `call` (a pinned e2e
    call)."""
    from kgtpu_torch.models import blocks
    counts, wrapped = {}, blocks.group_norm_relu

    def counting(x, *args):
        counts[tuple(x.shape)] = counts.get(tuple(x.shape), 0) + 1
        return wrapped(x, *args)

    blocks.group_norm_relu = counting
    try:
        call()
    finally:
        blocks.group_norm_relu = wrapped
    return counts


def gn_per_shape(torch, gn, counts: dict) -> list:
    """The kernel at every shape of the e2e call (bf16, ReLU): CUDA-event ms
    over back-to-back calls, device ms from torch.profiler (one launch per
    call), the HBM bound and the wrapper's host time per call (enqueue
    only: host clock over 50 calls, no synchronize inside)."""
    rows = []
    for shape, n in sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][2] * kv[0][3]):
        c = shape[1]
        x = torch.randn(shape, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        call = lambda: gn.group_norm_relu(x, w, b, gn.num_groups(c), True)
        ms = cuda_time_ms(call)
        dev = kernel_device_ms(torch, call, ("group_norm_kernel",), 1, lambda: gn.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            call()
        host_us = (time.perf_counter() - t) / 50 * 1e6
        torch.cuda.synchronize()
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": list(shape), "launches": n, "ms": ms, "device_ms": dev,
                     "bound_ms": bound, "host_us": host_us})
        log(f"  gn {str(list(shape)):20s} x{n:<3d} {ms:.4f} ms, device {dev:.4f} ms, bound "
            f"{bound:.4f} ms ({bound / dev:.2f} of it), host {host_us:.1f} us/call")
        del x
    tot = lambda k: sum(r["launches"] * r[k] for r in rows)
    log(f"  e2e call's GroupNorm: {sum(r['launches'] for r in rows)} launches, device "
        f"{tot('device_ms'):.3f} ms against a bound of {tot('bound_ms'):.3f} ms")
    return rows


def stage_times(torch, infer, model, cfg, images, dets) -> dict:
    """CUDA-event times (ms per call, host gaps included) of the stages of
    the pinned path on one batch."""
    from kgtpu_torch.ops.preprocess import normalize_images
    from kgtpu_torch.ops.roi import paste_masks_batch
    with torch.inference_mode():
        x = normalize_images(images, cfg.data.mean, cfg.data.std)
        out = model(x, last_stack_only=True)
        probs = infer.mask_probs(model, cfg, out["feat"], dets)
        t = {"backbone_heads": cuda_time_ms(
                 lambda: model(normalize_images(images, cfg.data.mean, cfg.data.std),
                               last_stack_only=True), iters=3, warmup=1),
             "decode_group_nms": cuda_time_ms(
                 lambda: infer.decode_batch(cfg, out["stacks"][-1]), iters=3, warmup=1),
             "crop_mask_head": cuda_time_ms(
                 lambda: infer.mask_probs(model, cfg, out["feat"], dets), iters=3, warmup=1),
             "paste": cuda_time_ms(
                 lambda: paste_masks_batch(probs, dets.boxes * cfg.data.stride, dets.scores,
                                           dets.valid, images.shape[1], images.shape[2],
                                           cfg.group.mask_thresh, cfg.infer.mask_chunk),
                 iters=3, warmup=1)}
    return t


def profile_e2e(torch, fn, top: int = 20) -> None:
    """torch.profiler over one call of `fn` (a pinned e2e call, or a train
    step): kernels by device time, and the device's idle share of the call's
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(4):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    bare_us = sorted(walls[1:])[1] * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = lambda e: getattr(e, "self_device_time_total", 0.0)
    # device-side entries only (kernels, copies); CPU ops carry their
    # kernels' time too and would count it twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU and dev(e) > 0),
                  key=dev, reverse=True)
    busy_us = sum(dev(e) for e in rows)
    log(f"  profile: wall {wall_us / 1e3:.2f} ms under the profiler, {bare_us / 1e3:.2f} ms "
        f"without (median of 3), device busy {busy_us / 1e3:.2f} ms; idle share "
        f"{1 - busy_us / wall_us:.3f} of the profiled call, {1 - busy_us / bare_us:.3f} of "
        f"the unprofiled one")
    for e in rows[:top]:
        log(f"    {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": bare_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / bare_us}


def check_infer_output(torch, out, b, cfg, h, w):
    d, m = cfg.group.max_detections, cfg.model.mask_size
    want = {"boxes": ((b, d, 4), torch.float32), "scores": ((b, d), torch.float32),
            "valid": ((b, d), torch.bool), "masks": ((b, d, m, m), torch.float32),
            "label_map": ((b, h, w), torch.int32), "score_map": ((b, h, w), torch.float32)}
    for k, (shape, dtype) in want.items():
        require(tuple(out[k].shape) == shape and out[k].dtype == dtype,
                f"{k}: {tuple(out[k].shape)} {out[k].dtype}, want {shape} {dtype}")
        if dtype == torch.float32:
            require(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    lab = out["label_map"]
    require(int(lab.min()) >= 0 and int(lab.max()) <= d, "label ids outside [0, D]")


def gaussian_scene(np, torch, b, n, hs, ws, n_valid, seed):
    """Keypoints, sizes and validity in stride coords as the train step
    hands them to the renderer (keypoints clamped to [0, ws - 1e-3]), with
    n_valid[i] valid instances in image i.  Every image also holds
    border-touching boxes (clamped corners at exactly ws - 1e-3), tiny boxes
    (radius < 1, sigma 1/6) and two instances on one pixel."""
    from kgtpu_torch.ops.targets import keypoints_from_boxes
    rng = np.random.default_rng(seed)
    wh = rng.uniform(1.5, 16, (b, n, 2))
    xy = rng.uniform(0, [ws, hs] - wh)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 0:3, 2] = ws                              # touch the right edge
    boxes[:, 2:5, 3] = hs                              # and the bottom
    boxes[:, 5, :2] = 0.0
    boxes[:, 6:9, 2:] = boxes[:, 6:9, :2] + rng.uniform(0.2, 1.5, (b, 3, 2))   # tiny
    boxes[:, 10] = boxes[:, 9]                         # two instances on one pixel
    valid = (np.arange(n)[None] < np.asarray(n_valid)[:, None]).astype(np.float32)
    bt = torch.from_numpy(boxes.astype(np.float32)).cuda()
    kpts = keypoints_from_boxes(bt)
    kpts = torch.stack([torch.clamp(kpts[..., 0], 0.0, ws - 1e-3),
                        torch.clamp(kpts[..., 1], 0.0, hs - 1e-3)], -1)
    sizes = torch.stack([bt[..., 3] - bt[..., 1], bt[..., 2] - bt[..., 0]], -1)
    return kpts.contiguous(), sizes.contiguous(), torch.from_numpy(valid).cuda()


def gaussian_bound_ms(torch, kpts, sizes, valid, hs, ws):
    """The least time for the render on these inputs: the larger of its
    bytes (inputs read once, the f32 output written once) over HBM and its
    operations over their peak rates.  The operations count what the data
    needs: an expf and GAUSS_F32_OPS f32 operations for every (pixel, class,
    valid instance) whose squared distance to that class's floored keypoint
    gives d^2 * coef < 14 (the cutoff below which the targets' f32
    resolution ends), counted with the renderer's own f32 arithmetic."""
    from kgtpu_torch.ops.targets import splat_coef
    k = torch.floor(kpts.float())
    coef = splat_coef(sizes, valid)                              # [B, N]
    ys = torch.arange(hs, device=kpts.device, dtype=torch.float32)[:, None]
    xs = torch.arange(ws, device=kpts.device, dtype=torch.float32)[None, :]
    exps = 0
    for s in range(0, k.shape[1], 8):
        dx = xs - k[:, s:s + 8, :, 0, None, None]               # [B, m, 5, 1, W]
        dy = ys - k[:, s:s + 8, :, 1, None, None]               # [B, m, 5, H, 1]
        cf = coef[:, s:s + 8, None, None, None]
        exps += int(((dx * dx + dy * dy) * cf < 14.0).logical_and_(cf > 0).sum())
    nbytes = (kpts.numel() + sizes.numel() + valid.numel()) * 4 + kpts.shape[0] * hs * ws * 5 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(exps / SFU_OPS_PER_S, exps * GAUSS_F32_OPS / F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), exps


def phase_gaussian(np, torch, gauss) -> dict:
    """Kernel vs plain on the hard cases, then kernel / plain / bound at the
    train step's shape ([8, 128, 128, 5], N = 128) with about 40 valid
    instances per image."""
    from kgtpu_torch.ops.targets import render_heatmaps_batch
    max_err = 0.0
    cases = [("n_valid 0/1/40/128", 128, 128, [0, 1, 40, 128, 40, 128, 1, 40]),
             ("all 128 valid", 128, 128, [128] * 8),
             ("ragged H=100", 100, 128, [40, 0, 128, 1, 40, 40, 40, 40]),
             ("ragged H=100 W=77", 100, 77, [40, 128, 1, 0, 40, 40, 40, 40])]
    for i, (name, hs, ws, n_valid) in enumerate(cases):
        kpts, sizes, valid = gaussian_scene(np, torch, 8, 128, hs, ws, n_valid, seed=10 + i)
        before = gauss.launches
        got = gauss.render_heatmaps(kpts, sizes, valid, hs, ws)
        torch.cuda.synchronize()
        require(gauss.launches == before + 1, "the Gaussian wrapper did not launch once")
        want = render_heatmaps_batch(kpts, sizes, valid, hs, ws)
        require(got.shape == (8, hs, ws, 5) and got.dtype == torch.float32,
                "Gaussian kernel output shape/dtype")
        err = float((got - want).abs().max())
        pos_k, pos_p = got >= 1.0, want >= 1.0
        same_pos = bool(torch.equal(pos_k, pos_p))
        log(f"  gauss {name:20s} [8,{hs},{ws},5] max_abs_err={err:.3g} (tol {GAUSS_TOL}); "
            f"positives kernel {int(pos_k.sum())} plain {int(pos_p.sum())}, equal {same_pos}")
        require(err <= GAUSS_TOL, f"Gaussian kernel disagrees with plain ({name})")
        require(same_pos, f"Gaussian kernel positive mask differs ({name})")
        for j, nv in enumerate(n_valid):
            require((int(pos_k[j].sum()) == 0) == (nv == 0),
                    f"image {j} with {nv} valid instances has {int(pos_k[j].sum())} positives")
        max_err = max(max_err, err)

    max_err = max(max_err, gaussian_radius_sweep(np, torch, gauss))

    kpts, sizes, valid = gaussian_scene(np, torch, 8, 128, 128, 128, [40] * 8, seed=20)
    call = lambda: gauss.render_heatmaps(kpts, sizes, valid, 128, 128)
    ms = cuda_time_ms(call, iters=50)
    device_ms = kernel_device_ms(torch, call, ("render_kernel",), 1, lambda: gauss.launches)
    plain_ms = cuda_time_ms(lambda: render_heatmaps_batch(kpts, sizes, valid, 128, 128))
    bound_ms, bound_by, exps = gaussian_bound_ms(torch, kpts, sizes, valid, 128, 128)
    log(f"  timed [8,128,128,5], N=128, 40 valid/img: wrapper {ms:.4f} ms, kernel device "
        f"time {device_ms:.5f} ms (torch.profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}; {exps} exps within reach); no single PyTorch "
        f"call computes it (library_ms null)")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t) / 50 * 1e6
    torch.cuda.synchronize()
    log(f"  wrapper host time {host_us:.1f} us per call (enqueue only, 50 calls)")
    return {"max_abs_err": max_err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "exps_within_reach": exps,
            "host_us": host_us}


def gaussian_radius_sweep(np, torch, gauss) -> float:
    """Sizes whose CornerNet radius lies just below or just above an
    integer (floor(r) picks sigma): the sizes on either side of each step of
    floor(r) on a 1e-3 grid, and their f32 neighbours, square and 1:1.3.
    The kernel's own prep must pick the plain version's sigma: positives
    exactly equal and every value within GAUSS_TOL."""
    from kgtpu_torch.ops.targets import gaussian_radius, render_heatmaps_batch
    side = torch.arange(1.0, 80.0, 1e-3, device="cuda")
    worst = 0.0
    for aspect in (1.0, 1.3):
        fl = torch.floor(gaussian_radius(torch.stack([side, side * aspect], -1)))
        step = torch.nonzero(fl[1:] != fl[:-1]).flatten()
        edge = torch.cat([side[step], side[step + 1]])
        edge = torch.cat([torch.nextafter(edge, torch.zeros_like(edge)), edge,
                          torch.nextafter(edge, torch.full_like(edge, 1e4))])
        n = 128
        b = -(-edge.numel() // n)
        h = torch.full((b * n,), 5.0, device="cuda")
        h[:edge.numel()] = edge
        sizes = torch.stack([h, h * aspect], -1).view(b, n, 2)
        rng = np.random.default_rng(int(aspect * 10))
        kpts = torch.from_numpy(rng.uniform(0, 127.99, (b, n, 5, 2)).astype(np.float32)).cuda()
        valid = torch.ones((b, n), device="cuda")
        got = gauss.render_heatmaps(kpts, sizes, valid, 128, 128)
        want = render_heatmaps_batch(kpts, sizes, valid, 128, 128)
        err = float((got - want).abs().max())
        same_pos = bool(torch.equal(got >= 1.0, want >= 1.0))
        log(f"  gauss radius sweep 1:{aspect} ({edge.numel()} sizes at {step.numel()} steps "
            f"of floor(r)) max_abs_err={err:.3g}; positives equal {same_pos}")
        require(err <= GAUSS_TOL and same_pos, "Gaussian kernel disagrees near a radius step")
        worst = max(worst, err)
    return worst


def train_batch(np, cfg, b: int, seed: int) -> dict:
    """A host batch in the loader's contract (kgtpu/data/loader.py): uint8
    images, colour-jitter gain and bias, area-ranked boxes and validity from
    the label map, and the renumbered uint16 label map.  Each image holds
    20-60 filled ellipses ("cells") drawn with NumPy."""
    from kgtpu_torch.data.transforms import boxes_from_label_map, renumber_label_map
    rng = np.random.default_rng(seed)
    size = cfg.data.input_size
    out = {k: [] for k in ("image", "img_gain", "img_bias", "boxes", "valid", "label_map")}
    for _ in range(b):
        label = np.zeros((size, size), np.uint16)
        img = rng.normal(40, 10, (size, size, 3))
        for cell in range(1, int(rng.integers(20, 61)) + 1):
            a, c = rng.uniform(6, 28, 2)
            cx, cy = rng.uniform(0, size, 2)
            th = rng.uniform(0, np.pi)
            r = int(max(a, c)) + 1
            y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, size)
            x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, size)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            inside = (u / a) ** 2 + (v / c) ** 2 <= 1.0
            label[y0:y1, x0:x1][inside] = cell
            img[y0:y1, x0:x1][inside] = rng.normal(170, 25, 3)
        boxes, valid, remap = boxes_from_label_map(label, cfg.data.max_instances)
        out["image"].append(np.clip(img, 0, 255).astype(np.uint8))
        out["img_gain"].append(rng.uniform(0.8, 1.2, 3).astype(np.float32))
        out["img_bias"].append((rng.uniform(-0.2, 0.2, 3) * 30).astype(np.float32))
        out["boxes"].append(boxes)
        out["valid"].append(valid)
        out["label_map"].append(renumber_label_map(label, remap))
    return {k: np.stack(v) for k, v in out.items()}


def phase_train(np, torch, gn, gauss, cfg) -> tuple:
    """[6]: the loss with kernel vs plain targets, then TRAIN_STEPS steps on
    one batch.  Returns (state, device batch, stats)."""
    from kgtpu_torch import train_lib
    from kgtpu_torch.ops.targets import render_heatmaps_batch
    host = train_batch(np, cfg, cfg.train.batch_size, seed=3)
    nv = host["valid"].sum(1)
    log(f"  batch: {host['image'].shape} uint8, valid instances per image "
        f"{[int(v) for v in nv]}, label map {host['label_map'].dtype}")
    require(host["label_map"].dtype == np.uint16 and nv.min() >= 15, "batch contract")
    batch = train_lib.batch_to_device(host, "cuda")
    require(batch["label_map"].dtype == torch.int32, "label map not cast to int32")
    state = train_lib.create_train_state(cfg, seed=0)
    require(state.model.training, "the train state's model is not in training mode")
    n_params = sum(p.numel() for p in state.model.parameters())

    g = torch.Generator(device="cuda").manual_seed(1)
    b, n = batch["valid"].shape
    sel_u = torch.rand((b, n), generator=g, device="cuda")
    jit_u = torch.rand((b, cfg.train.mask_train_rois, 4), generator=g, device="cuda")
    with torch.no_grad():
        _, m_kernel = train_lib.loss_fn(state.model, batch, sel_u, jit_u, cfg)
        _, m_plain = train_lib.loss_fn(state.model, batch, sel_u, jit_u, cfg,
                                       render=render_heatmaps_batch)
    for k in m_kernel:
        a, p = float(m_kernel[k]), float(m_plain[k])
        require(abs(a - p) <= TRAIN_LOSS_RTOL * abs(p), f"{k}: kernel targets {a} vs plain {p}")
    log("  loss with kernel vs plain targets (rtol %g): %s" % (TRAIN_LOSS_RTOL, ", ".join(
        f"{k} {float(m_kernel[k]):.6f}/{float(m_plain[k]):.6f}" for k in m_kernel)))
    # ROI selection with fewer valid instances than r: the zero keys tie, and
    # the card's stable sort must take them by ascending index as the CPU's
    # (and jax.lax.top_k) do
    r = cfg.train.mask_train_rois
    few = (torch.arange(n, device="cuda")[None] <
           torch.tensor([0, 1, 5, r - 1, r, r + 1, 40, n], device="cuda")[:b, None]).float()
    sel_card = train_lib.select_rois(sel_u, few, r).cpu()
    require(torch.equal(sel_card, train_lib.select_rois(sel_u.cpu(), few.cpu(), r)),
            "ROI selection on the card differs from the CPU's")

    step = train_lib.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gn.launches = gauss.launches = 0                  # the training path's run
    history, times = [], []
    for i in range(TRAIN_STEPS):
        g0, k0 = gauss.launches, gn.launches
        t = time.perf_counter()
        metrics = step(state, batch, g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        require(gauss.launches - g0 == 1, f"step {i}: Gaussian kernel launched "
                f"{gauss.launches - g0} times, want 1")
        require(gn.launches == k0, f"step {i}: the GroupNorm kernel ran in training")
        vals = {k: float(v) for k, v in metrics.items()}
        require(all(np.isfinite(v) for v in vals.values()), f"step {i}: {vals}")
        history.append(vals)
    gauss_launches, gn_launches = gauss.launches, gn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, p in state.model.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"{name}: no finite gradient")
    first, last = history[0]["loss"], history[-1]["loss"]
    log("  step loss: " + " ".join(f"{h['loss']:.4f}" for h in history))
    log(f"  first {history[0]}")
    log(f"  last  {history[-1]}")
    require(last < first, f"loss did not fall: {first} -> {last}")
    steady = times[1:]
    img_s = b * len(steady) / sum(steady)
    size = cfg.data.input_size
    if "--profile" in sys.argv[1:]:
        profile_e2e(torch, lambda: step(state, batch, g))
    log(f"  {TRAIN_STEPS} steps at batch {b}, {size}x{size}: first step {times[0] * 1e3:.1f} ms, "
        f"then {img_s:.2f} img/s ({sum(steady) / len(steady) * 1e3:.1f} ms/step), peak "
        f"{peak_gb:.2f} GB, {n_params} params; launches: Gaussian {gauss_launches}, "
        f"GroupNorm {gn_launches}")

    x = torch.randn((2, 64, 8, 8), device="cuda").contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    w, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    before = gn.launches
    try:
        gn.group_norm_relu(x, w, bias, 32, True)
        raised = False
    except RuntimeError:
        raised = True
    require(raised and gn.launches == before,
            "group_norm_relu accepted a grad-requiring CUDA input")
    log("  group_norm_relu on a grad-requiring CUDA tensor raises, as it must")
    return state, batch, {"train_img_per_s": img_s, "train_first_step_ms": times[0] * 1e3,
                          "train_peak_mem_gb": peak_gb, "train_steps": TRAIN_STEPS,
                          "train_loss_first": first, "train_loss_last": last,
                          "gauss_launches": gauss_launches, "gn_launches_train": gn_launches,
                          "params": n_params}


def phase_flagship(np, torch, gn, gauss) -> dict:
    """[8]: the committed EMA weights through `Predictor.from_checkpoint` on
    one image, then the test CLI over the 16 committed images in bf16 and in
    f32 (TF32 is off), each scored against the committed ground truth and
    held against kgtpu's committed reference run."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.data.png import read_png
    from kgtpu_torch.predictor import Predictor
    weights = os.path.join(ASSETS, "flagship_ema")
    images = os.path.join(ASSETS, "synthetic_hard", "images")
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference.npz"))
    ids = [str(i) for i in ref["ids"]]
    ref_metrics = json.loads(str(ref["metrics_json"]))
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}

    gn.launches = 0
    predictor = Predictor.from_checkpoint(weights, use_ema=True)
    one = predictor.predict(read_png(os.path.join(images, f"{ids[0]}.png"), "color"))
    n_ref = int(ref["counts_bfloat16"][0])
    log(f"  Predictor.from_checkpoint: {ids[0]} has {one['num_instances']} instances "
        f"(kgtpu bf16: {n_ref}); GroupNorm kernel launches {gn.launches}")
    require(gn.launches > 0 and abs(one["num_instances"] - n_ref) <= COUNT_TOL,
            "from_checkpoint did not serve the flagship through the kernel")
    del predictor

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("bfloat16", "float32"):
            save = os.path.join(tmp, dtype)
            gn.launches = gauss.launches = 0          # this path's run
            t = time.perf_counter()
            rc = test_cli.main(["--dataset", "folder", "--data_dir", images,
                                "--weights", weights, "--use_ema", "--input_size", "512",
                                "--batch_size", "16", "--compute_dtype", dtype,
                                "--save_dir", save])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = gn.launches
            require(rc == 0 and gauss.launches == 0, f"cli.test {dtype} failed")
            with open(os.path.join(save, "detections.json")) as f:
                det = {r["id"]: r for r in json.load(f)["images"]}
            require(sorted(det) == sorted(ids), f"cli.test {dtype} served {sorted(det)}")
            m = eval_metrics(records(save, gt, 512))
            counts = np.array([det[i]["num_instances"] for i in ids])
            dcount = counts - ref[f"counts_{dtype}"]
            pixels = [int((read_png(os.path.join(save, f"{i}_label.png"), "unchanged")
                           != ref[f"labels_{dtype}"][k]).sum()) for k, i in enumerate(ids)]
            dmap = m["mAP_dsb2018"] - ref_metrics[dtype]["mAP_dsb2018"]
            log(f"  {dtype}: mAP_dsb2018 {m['mAP_dsb2018']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['mAP_dsb2018']:.6f}, diff {dmap:+.6f}, tol "
                f"{MAP_TOL[dtype]}); AP_coco {m['AP_coco']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['AP_coco']:.6f}), AJI {m['AJI']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['AJI']:.6f}), PQ {m['PQ']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['PQ']:.6f})")
            log(f"    instances per image {counts.tolist()}, largest count diff "
                f"{int(np.abs(dcount).max())}, label-map pixels off kgtpu's: max "
                f"{max(pixels)} of {512 * 512}, images equal {pixels.count(0)}/16; "
                f"GroupNorm kernel launches {launches}; CLI wall {wall:.2f} s")
            require(m["num_images"] == 16 and abs(dmap) <= MAP_TOL[dtype],
                    f"{dtype} mAP_dsb2018 {m['mAP_dsb2018']} is off kgtpu's by {dmap}")
            if dtype == "float32":
                require(not dcount.any(), f"f32 instance counts off kgtpu's: {dcount.tolist()}")
                require(max(pixels) <= PIXELS_OFF_TOL, f"f32 label maps off kgtpu's by "
                        f"{pixels} pixels (at most {PIXELS_OFF_TOL} an image)")
            else:
                require(launches > 0, "the bf16 flagship run did not launch the GroupNorm "
                        "kernel")
            out.update({f"flagship_mAP_dsb2018_{dtype}": m["mAP_dsb2018"],
                        f"flagship_cli_wall_s_{dtype}": wall,
                        f"flagship_mAP_diff_{dtype}": dmap,
                        f"flagship_metrics_{dtype}": m,
                        f"flagship_count_diff_max_{dtype}": int(np.abs(dcount).max()),
                        f"flagship_pixels_off_max_{dtype}": max(pixels),
                        f"flagship_gn_launches_{'bf16' if dtype == 'bfloat16' else 'f32'}":
                            launches})
    return out


def host_sample_ms(np, torch, cfg) -> dict:
    """Host time per augmented sample of the CLI's data path at full size:
    one thread, the CLI's pinned torch threads, and the 4-worker iterator
    (wall time per sample over 8 batches of 8)."""
    from kgtpu_torch.data.loader import batch_iterator, prepare_sample
    from kgtpu_torch.data.registry import build_dataset
    ds = build_dataset(cfg.data, split="train")
    for i in range(len(ds)):                   # generated once, outside the timing
        ds[i]
    threads = torch.get_num_threads()
    out = {}
    try:
        for name, n in (("serial_1thread", 1), ("serial_cli_threads", max(os.cpu_count() // 4, 1))):
            torch.set_num_threads(n)
            rng = np.random.default_rng(0)
            t = time.perf_counter()
            for i in range(8):
                prepare_sample(ds[i], cfg.data, augment=True, image_only=False, rng=rng)
            out[name] = (time.perf_counter() - t) / 8 * 1e3
        t = time.perf_counter()
        for _ in batch_iterator(ds, cfg.data, 8, seed=0, steps=8):
            pass
        out["iterator_4_workers"] = (time.perf_counter() - t) / 64 * 1e3
    finally:
        torch.set_num_threads(threads)
    return out


def phase_train_cli(np, torch, gn, gauss) -> dict:
    """[9]: the training CLI at full width, resumed once, then cli.test on
    its best checkpoint."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli import train as train_cli
    from kgtpu_torch.config import Config, config_to_json
    from kgtpu_torch.data.png import read_png, write_png
    from kgtpu_torch.data.registry import build_dataset
    t_phase = time.perf_counter()
    base = Config()
    base = base.replace(train=dataclasses.replace(base.train, lr_warmup_steps=50))
    flags = ["--dataset", "synthetic", "--synthetic_n", "64", "--aug_rotate", "15",
             "--ema_decay", "0.99", "--lr", "1e-3", "--steps_per_epoch", str(CLI_STEPS),
             "--save_every", "3", "--keep_last", str(CLI_KEEP),
             "--eval_every", str(CLI_EPOCHS)]
    threads = torch.get_num_threads()      # the CLI pins the host's threads
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, save = os.path.join(tmp, "config.json"), os.path.join(tmp, "run")
        with open(cfg_path, "w") as f:
            f.write(config_to_json(base))
        flags += ["--config", cfg_path, "--save_dir", save]
        gn.launches = gauss.launches = 0                  # the training CLI's run
        t = time.perf_counter()
        first = train_cli.run(flags + ["--num_epochs", str(CLI_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        gauss_1, gn_1 = gauss.launches, gn.launches
        torch.set_num_threads(threads)
        steps = CLI_EPOCHS * CLI_STEPS
        ev = first["eval"]
        m = ev["metrics"]
        eval_batches = 2 * -(-16 // 8)                    # raw and EMA, chunks of 8
        log(f"  {CLI_EPOCHS} epochs of {CLI_STEPS} steps in {wall:.1f} s; launches: Gaussian "
            f"{gauss_1} ({steps} steps), GroupNorm {gn_1} ({eval_batches} eval batches of 8)")
        log("  epochs: " + ", ".join(f"{e['train_s']:.2f} s (wait {e['wait_s']:.2f})"
                                      for e in first["epochs"]))
        log(f"  epoch {ev['epoch']} held-out eval: {m}")
        require(gauss_1 >= steps, f"the Gaussian kernel ran {gauss_1} times in {steps} steps")
        require(gn_1 >= GN_PER_FORWARD * eval_batches, f"GroupNorm launched {gn_1} times "
                f"in {eval_batches} eval batches, want >= {GN_PER_FORWARD} each")
        require(m["val_mAP_dsb_ema"] > CLI_MAP_FLOOR and m["val_AP50_ema"] > CLI_AP50_FLOOR,
                f"val mAP_dsb2018 {m['val_mAP_dsb_ema']} / AP50 {m['val_AP50_ema']} (EMA) "
                f"not above the floors {CLI_MAP_FLOOR} / {CLI_AP50_FLOOR}")

        gn.launches = gauss.launches = 0                  # the resumed run
        second = train_cli.run(flags + ["--num_epochs", str(CLI_EPOCHS + 1), "--resume"])
        torch.cuda.synchronize()
        torch.set_num_threads(threads)
        log(f"  resumed at epoch {second['start_epoch']} step {second['start_step']}, ended at "
            f"step {second['end_step']}; launches: Gaussian {gauss.launches}, GroupNorm "
            f"{gn.launches}")
        require(second["start_epoch"] == CLI_EPOCHS and second["start_step"] == first["end_step"]
                == steps and second["end_step"] == steps + CLI_STEPS,
                "the resumed run did not continue from the saved epoch and step")
        require(gauss.launches >= CLI_STEPS and gn.launches == 0,
                "the resumed epoch's launches are off")
        with open(os.path.join(save, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(save, "best.json")) as f:
            best = json.load(f)
        dirs = sorted(d for d in os.listdir(save) if d.startswith("model_"))
        log(f"  run dir: {sorted(os.listdir(save))}; best {best}")
        require([r["epoch"] for r in rows] == list(range(CLI_EPOCHS + 1)),
                "metrics.jsonl does not hold one line per epoch")
        require(len(dirs) == CLI_KEEP, f"{dirs} left, want --keep_last {CLI_KEEP}")
        require(os.path.isdir(os.path.join(save, f"model_{best['epoch']}")),
                "best.json names a checkpoint that is not there")

        # cli.test on the best checkpoint over the same 16 val images
        val = build_dataset(base.data, split="val")       # synthetic, 512x512
        folder = os.path.join(tmp, "val")
        os.makedirs(folder)
        for i in range(len(val)):
            write_png(os.path.join(folder, f"val_{i:02d}.png"), val[i]["image"])
        gn.launches = 0
        rc = test_cli.main(["--dataset", "folder", "--data_dir", folder, "--weights",
                            os.path.join(save, "best"), "--use_ema", "--batch_size", "8",
                            "--save_dir", os.path.join(tmp, "served")])
        served = np.stack([read_png(os.path.join(tmp, "served", f"val_{i:02d}_label.png"),
                                    "unchanged") for i in range(len(val))]).astype(np.int32)
        want = ev["label_maps"]["ema"]
        off = int((served != want).sum())
        log(f"  cli.test on {best}: label maps vs the in-training eval's: {off} pixels off; "
            f"GroupNorm launches {gn.launches}")
        require(rc == 0 and gn.launches > 0 and off == 0,
                "cli.test on the best checkpoint does not serve the in-training eval's maps")

    steady = first["epochs"][1:]
    img_s = 8 * sum(e["steps"] for e in steady) / sum(e["train_s"] for e in steady)
    wait_ms = sum(e["wait_s"] for e in steady) / sum(e["steps"] for e in steady) * 1e3
    step_ms = sum(e["train_s"] for e in steady) / sum(e["steps"] for e in steady) * 1e3
    host = host_sample_ms(np, torch, base)
    phase_s = time.perf_counter() - t_phase
    log(f"  steady state (epochs 1-{CLI_EPOCHS - 1}): {img_s:.2f} img/s, {step_ms:.1f} ms per "
        f"step, of which {wait_ms:.1f} ms waiting for the batch; host ms per augmented 512x512 "
        f"sample: {', '.join(f'{k} {v:.1f}' for k, v in host.items())}")
    log(f"  phase [9]: {phase_s:.1f} s (budget {CLI_PHASE_S} s)")
    require(phase_s <= CLI_PHASE_S, f"phase [9] took {phase_s:.0f} s")
    return {"train_cli_img_per_s": img_s, "train_cli_step_ms": step_ms,
            "train_cli_wait_ms_per_step": wait_ms, "train_cli_first_wall_s": wall,
            "train_cli_val": m, "train_cli_steps": steps + CLI_STEPS,
            "train_cli_gauss_launches": gauss_1, "train_cli_gn_launches": gn_1,
            "train_cli_eval_batches": eval_batches, "host_ms_per_sample": host,
            "train_cli_phase_s": phase_s, "train_cli_map_floor": CLI_MAP_FLOOR,
            "train_cli_ap50_floor": CLI_AP50_FLOOR}


def mosaic(np, tiles: list, rows: int):
    """rows x rows mosaic of equal [H, W, ...] arrays, row-major."""
    return np.concatenate([np.concatenate(tiles[r * rows:(r + 1) * rows], axis=1)
                           for r in range(rows)], axis=0)


def load_flagship(torch, tta: bool):
    """(cfg, model) of the committed EMA weights in their stored bf16, on the
    card, with cfg.infer set for 3-scale + flip TTA when `tta`."""
    from kgtpu_torch import checkpoint
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import KGNet
    state_dict, extra = checkpoint.restore_bundle(os.path.join(ASSETS, "flagship_ema"),
                                                  use_ema=True)
    cfg = Config(model=checkpoint.decode_config(extra).model)
    if tta:
        cfg = cfg.replace(infer=dataclasses.replace(cfg.infer, test_scales=(0.75, 1.0, 1.25),
                                                    test_flip=True))
    model = KGNet(cfg.model)
    model.load_state_dict(state_dict)
    return cfg, model


def timed_repeats(torch, call, repeats: int) -> list:
    """Wall seconds of `repeats` calls, each ended by a synchronize, after
    one warm-up call."""
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def recorded_call(module, name: str, call):
    """(result of `call`, the arguments of the first call it made to
    module.<name>)."""
    seen, wrapped = [], getattr(module, name)

    def recording(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return wrapped(*args, **kwargs)

    setattr(module, name, recording)
    try:
        out = call()
    finally:
        setattr(module, name, wrapped)
    return out, seen[0]


def tta_stage_times(torch, model, cfg, fn, stacks) -> dict:
    """ms per TTA batch (CUDA events, host gaps included): the whole call,
    the backbone passes (normalize, every scale and its flip), the
    cross-variant merge and the mask stage; decode+group+NMS of the six
    variants is what remains."""
    from kgtpu_torch import infer
    from kgtpu_torch.ops.preprocess import normalize_images
    with torch.inference_mode():
        _, merge_args = recorded_call(infer, "merge_scales", lambda: fn(stacks))
        _, mask_args = recorded_call(infer, "mask_batch", lambda: fn(stacks))

        def backbones():
            for v in stacks.values():
                x = normalize_images(v, cfg.data.mean, cfg.data.std)
                model(x, last_stack_only=True)
                model(torch.flip(x, dims=[2]), last_stack_only=True)

        t = {"call": cuda_time_ms(lambda: fn(stacks), iters=3, warmup=1),
             "backbone_x6": cuda_time_ms(backbones, iters=3, warmup=1),
             "merge": cuda_time_ms(lambda: infer.merge_scales(*merge_args[0], **merge_args[1]),
                                   iters=3, warmup=1),
             "mask_stage": cuda_time_ms(lambda: infer.mask_batch(*mask_args[0], **mask_args[1]),
                                        iters=3, warmup=1)}
    t["decode_group_nms_x6"] = t["call"] - t["backbone_x6"] - t["merge"] - t["mask_stage"]
    return t


def phase_tta(np, torch, gn, smi: str) -> dict:
    """[10]: the three configurations through cli.test in f32 and bf16, held
    against kgtpu's committed f32 runs, then the TTA and whole-slide
    timings."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.config import required_divisor
    from kgtpu_torch.data.loader import prepare_sample
    from kgtpu_torch.data.png import read_png, write_png
    from kgtpu_torch.infer import build_multiscale_fn, build_tiled_infer_fn
    t_phase = time.perf_counter()
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_tta.npz"))
    ref_metrics = json.loads(str(ref["metrics_json"]))
    images = os.path.join(ASSETS, "synthetic_hard", "images")
    ids = [str(i) for i in ref["ids_tta"]]
    pixels = [read_png(os.path.join(images, f"{i}.png"), "color") for i in ids]
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"images": images, "slides": os.path.join(tmp, "slides")}
        os.makedirs(dirs["slides"])
        gts = {"images": gt, "slides": {}}
        for k in range(len(ids) // 4):
            quad = ids[4 * k:4 * k + 4]
            write_png(os.path.join(dirs["slides"], f"slide_{k}.png"),
                      mosaic(np, pixels[4 * k:4 * k + 4], 2))
            labs, off = [], 0
            for i in quad:
                labs.append(np.where(gt[i] > 0, gt[i] + off, 0))
                off += int(gt[i].max())
            gts["slides"][f"slide_{k}"] = mosaic(np, labs, 2)
        for dtype in ("float32", "bfloat16"):
            short = "f32" if dtype == "float32" else "bf16"
            for name, (data, flags, side) in TTA_RUNS.items():
                save = os.path.join(tmp, f"{name}_{dtype}")
                gn.launches = 0                           # this path's run
                t = time.perf_counter()
                rc = test_cli.main(["--dataset", "folder", "--data_dir", dirs[data],
                                    "--weights", os.path.join(ASSETS, "flagship_ema"),
                                    "--compute_dtype", dtype, "--save_dir", save] + flags)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = gn.launches
                with open(os.path.join(save, "detections.json")) as f:
                    det = json.load(f)
                run_ids = [str(i) for i in ref[f"ids_{name}"]]
                got = {r["id"]: r for r in det["images"]}
                require(rc == 0 and sorted(got) == sorted(run_ids),
                        f"cli.test {name} {dtype} served {sorted(got)}")
                require(det["ensemble"] == (flags[flags.index("--ensemble") + 1:][:1]
                                            if "--ensemble" in flags else []),
                        f"{name} {dtype}: detections.json's ensemble is {det['ensemble']}")
                m = eval_metrics(records(save, gts[data], side))
                want = ref_metrics[name]
                counts = np.array([got[i]["num_instances"] for i in run_ids])
                dcount = counts - ref[f"counts_{name}"]
                off = [int((read_png(os.path.join(save, f"{i}_label.png"), "unchanged")
                            != ref[f"labels_{name}"][k]).sum()) for k, i in enumerate(run_ids)]
                dmap = m["mAP_dsb2018"] - want["mAP_dsb2018"]
                log(f"  {name} {dtype}: mAP_dsb2018 {m['mAP_dsb2018']:.6f} (kgtpu f32 "
                    f"{want['mAP_dsb2018']:.6f}, diff {dmap:+.6f}, tol {MAP_TOL[dtype]}); "
                    f"AP_coco {m['AP_coco']:.6f} (kgtpu {want['AP_coco']:.6f}), AJI "
                    f"{m['AJI']:.6f}, PQ {m['PQ']:.6f}")
                log(f"    instances {counts.tolist()}, largest count diff "
                    f"{int(np.abs(dcount).max())}, label-map pixels off kgtpu's f32: max "
                    f"{max(off)} of {side * side}, equal {off.count(0)}/{len(off)}; GroupNorm "
                    f"launches {launches}; CLI wall {wall:.2f} s")
                require(launches > 0, f"{name} {dtype} did not launch the GroupNorm kernel")
                require(abs(dmap) <= MAP_TOL[dtype], f"{name} {dtype} mAP_dsb2018 "
                        f"{m['mAP_dsb2018']} is off kgtpu's by {dmap}")
                if dtype == "float32":
                    tol = PIXELS_OFF_TOL if side == 512 else SLIDE_PIXELS_OFF_TOL
                    require(not dcount.any(), f"{name} f32 instance counts off kgtpu's: "
                            f"{dcount.tolist()}")
                    require(max(off) <= tol, f"{name} f32 label maps off kgtpu's by {off} "
                            f"pixels (at most {tol} each)")
                out.update({f"{name}_mAP_dsb2018_{short}": m["mAP_dsb2018"],
                            f"{name}_mAP_diff_{short}": dmap,
                            f"{name}_metrics_{short}": m,
                            f"{name}_count_diff_max_{short}": int(np.abs(dcount).max()),
                            f"{name}_pixels_off_max_{short}": max(off),
                            f"{name}_cli_wall_s_{short}": wall,
                            f"{name}_gn_launches_{short}": launches})

    # TTA throughput: 3 scales + flip, batch 8, stored bf16, the 16 images
    cfg, model = load_flagship(torch, tta=True)
    fn = build_multiscale_fn(model, cfg)
    div = required_divisor(cfg.model)
    batches = []
    for start in range(0, len(ids), 8):
        stacks = {}
        for sc in cfg.infer.test_scales:
            dcfg = dataclasses.replace(cfg.data, input_size=round(512 * sc / div) * div)
            stacks[f"{sc:g}"] = torch.from_numpy(np.stack(
                [prepare_sample({"image": im, "label_map": gt[i]}, dcfg)["image"]
                 for im, i in zip(pixels[start:start + 8], ids[start:start + 8])])).cuda()
        batches.append(stacks)
    gn.launches = 0
    fn(batches[0])
    torch.cuda.synchronize()
    tta_launches = gn.launches
    walls = timed_repeats(torch, lambda: [fn(b) for b in batches], TTA_REPEATS)
    rates = sorted(len(ids) / w for w in walls)
    stages = tta_stage_times(torch, model, cfg, fn, batches[0])
    log("  TTA stages, ms per batch of 8: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    prof = profile_e2e(torch, lambda: fn(batches[0]), top=8)
    # whole slide: 2048x2048 (4x4 mosaic of the 16 images), 25 tiles of 512
    slide = torch.from_numpy(mosaic(np, pixels, 4)).cuda()
    tiled = build_tiled_infer_fn(model, cfg, (2048, 2048))
    gn.launches = 0
    found = tiled(slide)
    torch.cuda.synchronize()
    slide_launches = gn.launches
    n_found = int(found["valid"].sum())
    slide_s = sorted(timed_repeats(torch, lambda: tiled(slide), TTA_REPEATS))
    from kgtpu_torch import infer
    _, stitch_args = recorded_call(infer, "stitch_tiles", lambda: tiled(slide))
    stitch_ms = cuda_time_ms(lambda: infer.stitch_tiles(*stitch_args[0], **stitch_args[1]),
                             iters=3, warmup=1)
    phase_s = time.perf_counter() - t_phase
    log(f"  TTA (3 scales + flip, batch 8, bf16): {rates[len(rates) // 2]:.2f} img/s, median of "
        f"{TTA_REPEATS} repeats over the 16 images (min {rates[0]:.2f}, max {rates[-1]:.2f}); "
        f"GroupNorm launches per batch {tta_launches}; {smi}")
    mid = slide_s[len(slide_s) // 2]
    log(f"  whole slide 2048x2048 (25 tiles of 512, overlap 64, bf16): {mid:.4f} s (min "
        f"{slide_s[0]:.4f}, max {slide_s[-1]:.4f}), {25 / mid:.2f} tiles/s; stitch "
        f"{stitch_ms:.2f} ms; {n_found} instances; GroupNorm launches {slide_launches}; {smi}")
    log(f"  phase [10]: {phase_s:.1f} s (budget {TTA_PHASE_S} s)")
    require(tta_launches > 0 and slide_launches > 0 and n_found > 0,
            "the timed TTA or slide call did not run through the kernel")
    require(phase_s <= TTA_PHASE_S, f"phase [10] took {phase_s:.0f} s")
    return {**out, "tta_img_per_s": rates[len(rates) // 2], "tta_img_per_s_min": rates[0],
            "tta_img_per_s_max": rates[-1], "tta_repeats": TTA_REPEATS,
            "tta_gn_launches_per_batch": tta_launches, "tta_stage_ms_b8": stages,
            "tta_profile_b8": prof, "slide_2048_stitch_ms": stitch_ms,
            "slide_2048_s": slide_s[len(slide_s) // 2], "slide_2048_s_min": slide_s[0],
            "slide_2048_s_max": slide_s[-1],
            "slide_2048_tiles_per_s": 25 / slide_s[len(slide_s) // 2],
            "slide_2048_instances": n_found, "slide_2048_gn_launches": slide_launches,
            "tta_phase_s": phase_s}


def unet_cli_runs(np, torch, gn) -> dict:
    """[11] (a) and (b): the unet flagship alone and in the heterogeneous
    ensemble through cli.test, f32 and bf16, against kgtpu's committed runs."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.data.png import read_png
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_unet.npz"))
    ref_metrics = json.loads(str(ref["metrics_json"]))
    ids = [str(i) for i in ref["ids"]]
    images = os.path.join(ASSETS, "synthetic_hard", "images")
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in UNET_RUNS.items():
            for dtype in ("float32", "bfloat16"):
                short = "f32" if dtype == "float32" else "bf16"
                save = os.path.join(tmp, f"{name}_{dtype}")
                gn.launches = 0                           # this path's run
                t = time.perf_counter()
                rc = test_cli.main(["--dataset", "folder", "--data_dir", images, "--weights",
                                    os.path.join(ASSETS, "unet_ema"), "--compute_dtype", dtype,
                                    "--save_dir", save] + flags)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = gn.launches
                with open(os.path.join(save, "detections.json")) as f:
                    det = {r["id"]: r for r in json.load(f)["images"]}
                require(rc == 0 and sorted(det) == sorted(ids), f"cli.test {name} {dtype} failed")
                m = eval_metrics(records(save, gt, 512))
                want = ref_metrics[f"{name}_{dtype}"]
                counts = np.array([det[i]["num_instances"] for i in ids])
                dcount = counts - ref[f"counts_{name}_{dtype}"]
                off = [int((read_png(os.path.join(save, f"{i}_label.png"), "unchanged")
                            != ref[f"labels_{name}_{dtype}"][k]).sum()) for k, i in enumerate(ids)]
                dmap = m["mAP_dsb2018"] - want["mAP_dsb2018"]
                log(f"  {name} {dtype}: mAP_dsb2018 {m['mAP_dsb2018']:.6f} (kgtpu "
                    f"{want['mAP_dsb2018']:.6f}, diff {dmap:+.6f}, tol {MAP_TOL[dtype]}); AP_coco "
                    f"{m['AP_coco']:.6f} (kgtpu {want['AP_coco']:.6f}), AJI {m['AJI']:.6f}, PQ "
                    f"{m['PQ']:.6f}")
                log(f"    instances {counts.tolist()}, largest count diff "
                    f"{int(np.abs(dcount).max())}, label-map pixels off kgtpu's: max {max(off)} "
                    f"of {512 * 512}, equal {off.count(0)}/16; GroupNorm launches {launches}; "
                    f"CLI wall {wall:.2f} s")
                require(launches > 0, f"{name} {dtype} did not launch the GroupNorm kernel")
                require(abs(dmap) <= MAP_TOL[dtype], f"{name} {dtype} mAP_dsb2018 "
                        f"{m['mAP_dsb2018']} is off kgtpu's by {dmap}")
                if dtype == "float32":
                    require(not dcount.any(), f"{name} f32 instance counts off kgtpu's: "
                            f"{dcount.tolist()}")
                    require(max(off) <= PIXELS_OFF_TOL, f"{name} f32 label maps off kgtpu's "
                            f"by {off} pixels (at most {PIXELS_OFF_TOL} each)")
                out.update({f"{name}_mAP_dsb2018_{short}": m["mAP_dsb2018"],
                            f"{name}_mAP_diff_{short}": dmap, f"{name}_metrics_{short}": m,
                            f"{name}_count_diff_max_{short}": int(np.abs(dcount).max()),
                            f"{name}_pixels_off_max_{short}": max(off),
                            f"{name}_cli_wall_s_{short}": wall,
                            f"{name}_gn_launches_{short}": launches})
    return out


def unet_e2e(np, torch, gn) -> dict:
    """[11] (c): the unet flagship's architecture with seeded random weights
    on the bench's pinned batch-32 512x512 call: kernel vs plain GroupNorm,
    e2e img/s, and the kernel at every shape of the call."""
    from kgtpu_torch import checkpoint
    from kgtpu_torch.cli.bench import e2e_bench, pinned_call, seeded_dets
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import build_model
    stored = checkpoint.decode_config(checkpoint.restore_extra(os.path.join(ASSETS, "unet_ema")))
    cfg = Config(model=stored.model)
    model = build_model(cfg.model, seed=0, device="cuda")
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (E2E_BATCH, 512, 512, 3), dtype=np.uint8)).cuda()
    dets = seeded_dets(cfg, E2E_BATCH, seed=12)
    gn.launches = 0                                    # the unet's e2e call
    found, out = pinned_call(model, cfg, imgs, dets)
    torch.cuda.synchronize()
    launches = gn.launches
    model.use_plain_norm(True)
    found_p, plain = pinned_call(model, cfg, imgs, dets)
    model.use_plain_norm(False)
    require(gn.launches == launches, "the plain run launched the kernel")
    check_infer_output(torch, out, E2E_BATCH, cfg, 512, 512)
    same = float((plain["label_map"] == out["label_map"]).float().mean())
    log(f"  unet ({sum(p.numel() for p in model.parameters())} params, {cfg.model.compute_dtype}) "
        f"batch {E2E_BATCH}: GroupNorm launches {launches}; label-map pixels equal to the plain "
        f"GroupNorm run {same:.5f} (floor {LABEL_AGREEMENT_FLOOR}); same detector valid slots "
        f"{bool(torch.equal(found.valid, found_p.valid))}")
    require(launches >= 23 and same >= LABEL_AGREEMENT_FLOOR,
            "the unet's e2e call disagrees with the plain GroupNorm or skipped the kernel")
    e2e = e2e_bench(model, cfg, batch=E2E_BATCH, ndets=PINNED_DETS)
    log(f"  unet e2e {e2e['img_per_s']:.2f} img/s, median of {len(e2e['img_per_s_all'])} repeats "
        f"(min {e2e['img_per_s_min']:.2f}, max {e2e['img_per_s_max']:.2f}), "
        f"{e2e['flops_per_img'] / 1e9:.2f} GFLOP/img")
    log("  GroupNorm kernel at the shapes of one unet e2e call (bf16, ReLU):")
    rows = gn_per_shape(torch, gn, gn_shape_counts(lambda: pinned_call(model, cfg, imgs, dets)))
    return {"unet_e2e_img_s": e2e["img_per_s"], "unet_e2e_img_s_min": e2e["img_per_s_min"],
            "unet_e2e_img_s_max": e2e["img_per_s_max"], "unet_e2e_img_s_all": e2e["img_per_s_all"],
            "unet_gflops_per_img": e2e["flops_per_img"] / 1e9,
            "unet_label_agreement_vs_plain": same, "unet_e2e_gn_launches": launches,
            "gn_per_shape_unet_b32": rows}


def variant_runs(np, torch, gn, gauss) -> dict:
    """[11] (d): each variant at full width served with the kernel and with
    the plain GroupNorm on a pinned batch of 8, then VARIANT_STEPS train
    steps on one batch."""
    from kgtpu_torch import infer, train_lib
    from kgtpu_torch.cli.bench import pinned_call, seeded_dets
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import build_model
    base = Config()
    host = train_batch(np, base, 8, seed=21)
    batch = train_lib.batch_to_device(host, "cuda")
    out = {}
    for name, (mfields, gfields) in VARIANTS.items():
        cfg = base.replace(model=dataclasses.replace(base.model, **mfields),
                           group=dataclasses.replace(base.group, **gfields),
                           train=dataclasses.replace(base.train, lr_warmup_steps=1))
        model = build_model(cfg.model, seed=0, device="cuda")
        dets = seeded_dets(cfg, 8, seed=22)
        gn.launches = gauss.launches = 0                  # this variant's serving
        served = infer.build_infer_fn(model, cfg)(batch["image"])
        found, pinned = pinned_call(model, cfg, batch["image"], dets)
        torch.cuda.synchronize()
        launches = gn.launches
        check_infer_output(torch, served, 8, cfg, 512, 512)
        check_infer_output(torch, pinned, 8, cfg, 512, 512)
        if cfg.model.norm == "batch":
            found2, again = pinned_call(model, cfg, batch["image"], dets)
            agree = float((again["label_map"] == pinned["label_map"]).float().mean())
            require(launches == 0 and torch.equal(again["label_map"], pinned["label_map"])
                    and torch.equal(found2.valid, found.valid),
                    f"{name}: two serving runs differ, or a GroupNorm ran")
        else:
            model.use_plain_norm(True)
            _, plain = pinned_call(model, cfg, batch["image"], dets)
            model.use_plain_norm(False)
            agree = float((plain["label_map"] == pinned["label_map"]).float().mean())
            require(launches > 0 and agree >= LABEL_AGREEMENT_FLOOR,
                    f"{name}: kernel vs plain label maps {agree} or no launch ({launches})")
        del model
        state = train_lib.create_train_state(cfg, seed=0)
        step = train_lib.make_train_step(cfg)
        g = torch.Generator(device="cuda").manual_seed(1)
        gn.launches = gauss.launches = 0                  # this variant's training
        losses = [float(step(state, batch, g)["loss"]) for _ in range(VARIANT_STEPS)]
        torch.cuda.synchronize()
        log(f"  {name}: served (GroupNorm launches {launches}, label pixels equal to the "
            f"{'second run' if cfg.model.norm == 'batch' else 'plain GroupNorm'} {agree:.5f}, "
            f"detections {int(served['valid'].sum())}); {VARIANT_STEPS} train steps, loss "
            + " ".join(f"{v:.4f}" for v in losses)
            + f"; Gaussian launches {gauss.launches}, GroupNorm {gn.launches}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{name}: the loss did not fall: {losses}")
        require(gauss.launches == VARIANT_STEPS and gn.launches == 0,
                f"{name}: training launched Gaussian {gauss.launches}, GroupNorm {gn.launches}")
        out[name] = {"gn_launches_serving": launches, "label_agreement": agree,
                     "losses": losses, "gauss_launches_train": gauss.launches}
        del state
        torch.cuda.empty_cache()
    return out


def remat_runs(np, torch) -> dict:
    """[11] (e): REMAT_STEPS steps of the default hourglass (batch 8) with and
    without remat from one init, with GroupNorm and with BatchNorm."""
    from kgtpu_torch import train_lib
    from kgtpu_torch.config import Config
    base = Config()
    base = base.replace(train=dataclasses.replace(base.train, lr_warmup_steps=1))
    batch = train_lib.batch_to_device(train_batch(np, base, 8, seed=23), "cuda")
    out = {}
    for norm in ("group", "batch"):
        runs = {}
        for remat in (False, True):
            cfg = base.replace(model=dataclasses.replace(base.model, norm=norm, remat=remat))
            state = train_lib.create_train_state(cfg, seed=0)
            step = train_lib.make_train_step(cfg)
            g = torch.Generator(device="cuda").manual_seed(2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = [float(step(state, batch, g)["loss"]) for _ in range(REMAT_STEPS)]
            torch.cuda.synchronize()
            runs[remat] = (losses, torch.cuda.max_memory_allocated() / 1e9,
                           [b.clone() for b in state.model.buffers()])
            del state
            torch.cuda.empty_cache()
        (l0, p0, s0), (l1, p1, s1) = runs[False], runs[True]
        stats_err = max([float((a - b).abs().max()) for a, b in zip(s0, s1)] or [0.0])
        log(f"  remat, norm={norm}: losses {[round(v, 6) for v in l1]} vs without "
            f"{[round(v, 6) for v in l0]}; peak {p1:.3f} GB vs {p0:.3f} GB; running stats "
            f"{len(s0)} buffers, max diff {stats_err:.3g}")
        require(np.allclose(l1, l0, rtol=TRAIN_LOSS_RTOL, atol=0),
                f"remat ({norm}) changed the losses: {l1} vs {l0}")
        require(p1 < p0, f"remat ({norm}) did not lower the peak memory: {p1} vs {p0} GB")
        require(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in zip(s0, s1)),
                f"remat ({norm}) moved the running stats differently")
        require((norm == "batch") == bool(s0), "BatchNorm buffers missing or unexpected")
        out[norm] = {"losses": l1, "losses_no_remat": l0, "peak_gb": p1,
                     "peak_gb_no_remat": p0, "stats_max_diff": stats_err}
    return out


def phase_backbones(np, torch, gn, gauss) -> dict:
    """[11]: (a)-(e) of the module docstring."""
    t_phase = time.perf_counter()
    out = unet_cli_runs(np, torch, gn)
    torch.cuda.empty_cache()
    out.update(unet_e2e(np, torch, gn))
    torch.cuda.empty_cache()
    out["variants"] = variant_runs(np, torch, gn, gauss)
    out["remat"] = remat_runs(np, torch)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase [11]: {phase_s:.1f} s (budget {BACKBONES_PHASE_S} s)")
    require(phase_s <= BACKBONES_PHASE_S, f"phase [11] took {phase_s:.0f} s")
    out["backbones_phase_s"] = phase_s
    return out


def decode_checks(np) -> dict:
    """[12] (a): every committed fixture in every mode against cv2's hash;
    the decode time of each format."""
    import importlib.util

    from kgtpu_torch.data.imread import read_image
    from tools.make_torch_format_assets import sha
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_formats.npz"))
    decodes = json.loads(str(ref["decode_json"]))
    t = time.perf_counter()
    bad = []
    for d in decodes:
        got = read_image(os.path.join(FORMATS, d["path"]), d["mode"])
        if (sha(got), list(got.shape), str(got.dtype)) != (d["sha256"], d["shape"], d["dtype"]):
            bad.append((d["path"], d["mode"], list(got.shape)))
    check_s = time.perf_counter() - t
    log(f"  {len(decodes) - len(bad)}/{len(decodes)} decodes equal cv2's (sha256, shape, "
        f"dtype) in {check_s:.1f} s")
    require(not bad, f"decodes off cv2's: {bad[:5]}")
    timed = {}
    for kind, (folder, suffix) in FORMAT_KINDS.items():
        files = sorted(f for f in os.listdir(folder) if f.endswith(suffix))[:4]
        per_file = []
        for f in files:
            reads = []
            for _ in range(3):
                t = time.perf_counter()
                img = read_image(os.path.join(folder, f), "color")
                reads.append((time.perf_counter() - t) * 1e3)
            per_file.append((sorted(reads)[1], img.shape[0] * img.shape[1]))
        ms = float(np.median([m for m, _ in per_file]))
        pixels = per_file[0][1]
        timed[kind] = {"ms_per_image": ms, "pixels": pixels,
                       "ms_per_512x512": ms * 512 * 512 / pixels, "files": len(files)}
        log(f"  decode {kind}: {ms:.1f} ms per {int(pixels ** 0.5)}x{int(pixels ** 0.5)} image "
            f"(median of {len(files)} files, each the median of 3 reads), "
            f"{timed[kind]['ms_per_512x512']:.1f} ms per 512x512 of pixels")
    present = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL")}
    log(f"  importable on this host (for the record; the port uses neither): {present}")
    return {"decode_checks": len(decodes), "decode_check_s": check_s, "decode_ms": timed,
            "host_has": present}


def format_serving(np, torch, gn, gauss, fstats: dict) -> dict:
    """[12] (b): the flagship over the baseline JPEGs (f32, bf16) against
    kgtpu's run on them, and over the mixed folder."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.data.png import read_png
    weights = os.path.join(ASSETS, "flagship_ema")
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_formats.npz"))
    ref_metrics = json.loads(str(ref["metrics_json"]))
    ids = [str(i) for i in ref["ids"]]
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            short = "f32" if dtype == "float32" else "bf16"
            save = os.path.join(tmp, dtype)
            gn.launches = gauss.launches = 0              # this path's run
            t = time.perf_counter()
            rc = test_cli.main(["--dataset", "folder", "--data_dir", os.path.join(FORMATS, "jpeg"),
                                "--weights", weights, "--use_ema", "--input_size", "512",
                                "--batch_size", "16", "--compute_dtype", dtype,
                                "--save_dir", save])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = gn.launches
            with open(os.path.join(save, "detections.json")) as f:
                det = {r["id"]: r for r in json.load(f)["images"]}
            require(rc == 0 and sorted(det) == sorted(ids), f"cli.test JPEG {dtype} failed")
            m = eval_metrics(records(save, gt, 512))
            counts = np.array([det[i]["num_instances"] for i in ids])
            dcount = counts - ref[f"counts_{dtype}"]
            off = [int((read_png(os.path.join(save, f"{i}_label.png"), "unchanged")
                        != ref[f"labels_{dtype}"][k]).sum()) for k, i in enumerate(ids)]
            dmap = m["mAP_dsb2018"] - ref_metrics[dtype]["mAP_dsb2018"]
            png_wall = fstats[f"flagship_cli_wall_s_{dtype}"]
            log(f"  JPEG folder {dtype}: mAP_dsb2018 {m['mAP_dsb2018']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['mAP_dsb2018']:.6f}, diff {dmap:+.6f}, tol "
                f"{MAP_TOL[dtype]}); instances {counts.tolist()}, largest count diff "
                f"{int(np.abs(dcount).max())}, label-map pixels off kgtpu's: max {max(off)}, "
                f"equal {off.count(0)}/16; GroupNorm launches {launches}; CLI {16 / wall:.2f} "
                f"img/s ({wall:.2f} s; the PNG folder of [8]: {16 / png_wall:.2f} img/s)")
            require(launches > 0, f"the JPEG folder {dtype} did not launch the GroupNorm kernel")
            require(abs(dmap) <= MAP_TOL[dtype], f"JPEG {dtype} mAP_dsb2018 {m['mAP_dsb2018']} "
                    f"is off kgtpu's by {dmap}")
            if dtype == "float32":
                require(not dcount.any(), f"JPEG f32 instance counts off kgtpu's: "
                        f"{dcount.tolist()}")
                require(max(off) <= PIXELS_OFF_TOL, f"JPEG f32 label maps off kgtpu's by {off}")
            out.update({f"jpeg_mAP_dsb2018_{short}": m["mAP_dsb2018"],
                        f"jpeg_mAP_diff_{short}": dmap,
                        f"jpeg_count_diff_max_{short}": int(np.abs(dcount).max()),
                        f"jpeg_pixels_off_max_{short}": max(off),
                        f"jpeg_cli_img_per_s_{short}": 16 / wall,
                        f"png_cli_img_per_s_{short}": 16 / png_wall,
                        f"jpeg_gn_launches_{short}": launches})
        save = os.path.join(tmp, "mixed")
        gn.launches = 0
        rc = test_cli.main(["--dataset", "folder", "--data_dir", os.path.join(FORMATS, "mixed"),
                            "--weights", weights, "--use_ema", "--batch_size", "8",
                            "--save_dir", save])
        with open(os.path.join(save, "detections.json")) as f:
            served = sorted(r["id"] for r in json.load(f)["images"])
        files = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(FORMATS, "mixed")))
        log(f"  mixed folder: served {len(served)} of {len(files)} files "
            f"(progressive JPEG, tiled / LZW / 16-bit TIFF, BMP); GroupNorm launches {gn.launches}")
        require(rc == 0 and served == files and gn.launches > 0
                and any(i.endswith("_rgb16") for i in served)
                and any(i.endswith("_tiled") for i in served), "the mixed folder did not serve")
        out["mixed_gn_launches"] = gn.launches
    return out


def format_training(np, torch, gauss) -> dict:
    """[12] (c): cli.train on coco and neural_cells built from the fixtures."""
    from kgtpu_torch.cli import train as train_cli
    from kgtpu_torch.config import DataConfig
    from kgtpu_torch.data.registry import build_dataset
    from tools.make_torch_format_assets import dataset_layout, sha
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_formats.npz"))
    want = json.loads(str(ref["datasets_json"]))
    threads = torch.get_num_threads()      # the CLI pins the host's threads
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps in TRAIN_FORMAT_STEPS.items():
            root = dataset_layout(FORMATS, tmp, name)
            for split in ("train", "val"):
                ds = build_dataset(DataConfig(dataset=name, data_dir=root), split)
                got = [{"id": x["id"], "image": sha(x["image"]),
                        "label_map": sha(x["label_map"].astype(np.int32)),
                        "shape": list(x["label_map"].shape)}
                       for x in (ds[k] for k in range(len(ds)))]
                require(got == want[f"{name}/{split}"], f"{name} {split}: samples off kgtpu's "
                        "readers")
            save = os.path.join(tmp, f"run_{name}")
            gauss.launches = 0                              # this path's run
            t = time.perf_counter()
            summary = train_cli.run(["--dataset", name, "--data_dir", root, "--batch_size", "8",
                                     "--input_size", "512", "--num_epochs", "1",
                                     "--steps_per_epoch", str(steps), "--save_dir", save])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            torch.set_num_threads(threads)
            with open(os.path.join(save, "metrics.jsonl")) as f:
                row = json.loads(f.readline())
            losses = {k: v for k, v in row.items() if "loss" in k}
            n = len(want[f"{name}/train"])
            log(f"  {name}: {n} train samples equal kgtpu's by hash; {steps} steps in "
                f"{wall:.1f} s (train {summary['epochs'][0]['train_s']:.1f} s, waiting for "
                f"batches {summary['epochs'][0]['wait_s']:.1f} s); Gaussian launches "
                f"{gauss.launches}; last losses {losses}")
            require(losses and all(np.isfinite(v) for v in losses.values()),
                    f"{name}: the loss is not finite")
            require(gauss.launches == steps, f"{name}: {gauss.launches} Gaussian launches in "
                    f"{steps} steps")
            out.update({f"train_{name}_gauss_launches": gauss.launches,
                        f"train_{name}_losses": losses, f"train_{name}_wall_s": wall,
                        f"train_{name}_samples": n})
    return out


def watchdog_run() -> dict:
    """[12] (d): a real watchdog restart, in a subprocess."""
    from kgtpu_torch.config import config_to_json, tiny_test_config
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "tiny.json")
        with open(cfg, "w") as f:
            f.write(config_to_json(tiny_test_config()))
        save = os.path.join(tmp, "run")
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "kgtpu_torch.cli.train", "--config", cfg,
                            "--save_dir", save] + WATCHDOG_FLAGS,
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=240)
        wall = time.perf_counter() - t
        restarts = r.stderr.count("re-exec'ing with --resume")
        resumed = r.stderr.split("re-exec'ing")[-1] if restarts else ""
        rows = []
        if os.path.exists(os.path.join(save, "metrics.jsonl")):
            with open(os.path.join(save, "metrics.jsonl")) as f:
                rows = [json.loads(line)["epoch"] for line in f]
        log(f"  watchdog subprocess: exit {r.returncode}, {restarts} re-exec, resumed at "
            f"epoch 1: {'at epoch 1' in resumed}, metrics.jsonl epochs {rows}, {wall:.1f} s")
        require(r.returncode == 0 and restarts == 1 and "at epoch 1" in resumed
                and rows == [0, 1], "the watchdog did not restart once and resume: "
                + r.stderr[-2000:])
    return {"watchdog_restarts": restarts, "watchdog_wall_s": wall}


def phase_formats(np, torch, gn, gauss, fstats: dict) -> dict:
    """[12]: (a)-(d) of the module docstring."""
    t_phase = time.perf_counter()
    out = decode_checks(np)
    out.update(format_serving(np, torch, gn, gauss, fstats))
    torch.cuda.empty_cache()
    out.update(format_training(np, torch, gauss))
    torch.cuda.empty_cache()
    out.update(watchdog_run())
    phase_s = time.perf_counter() - t_phase
    log(f"  phase [12]: {phase_s:.1f} s (budget {FORMATS_PHASE_S} s)")
    require(phase_s <= FORMATS_PHASE_S, f"phase [12] took {phase_s:.0f} s")
    out["formats_phase_s"] = phase_s
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN and matmul in every phase")

    import numpy as np
    from kgtpu_torch import infer
    from kgtpu_torch.cli.bench import (REPEATS, decode_group_bench, e2e_bench, pinned_call,
                                       seeded_dets)
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import build_model
    from kgtpu_torch.ops import gaussian as gauss
    from kgtpu_torch.ops import groupnorm as gn
    from kgtpu_torch.predictor import Predictor

    # 1. build both kernels, one nvcc each, in parallel
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        libs = list(ex.map(lambda m: m.build(), (gn, gauss)))
    log(f"[1] built {', '.join(libs)} with nvcc in {time.perf_counter() - t:.1f} s")

    # 2. kernel vs plain
    log("[2] GroupNorm kernel vs plain PyTorch version")
    kstats = phase_kernel_vs_plain(torch, gn)

    # 3. serve the default Config at full width
    log("[3] serving the default Config (2-stack hourglass, 128 ch, 512x512)")
    cfg = Config()
    model = build_model(cfg.model, seed=0, device="cuda")
    infer_fn = infer.build_infer_fn(model, cfg)
    predictor = Predictor(cfg, model.state_dict())
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8))
               for _ in range(3)]
    singles = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((400, 600, 3), (512, 512, 3))]
    pinned_imgs = torch.from_numpy(
        rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)).cuda()
    pinned = seeded_dets(cfg, 8, seed=1)
    torch.cuda.synchronize()

    gn.launches = gauss.launches = 0                  # the serving path's run
    t = time.perf_counter()
    outs = [infer_fn(b) for b in batches]
    preds = [predictor.predict(im) for im in singles]
    n0 = gn.launches
    found, pinned_out = pinned_call(model, cfg, pinned_imgs, pinned)
    n1 = gn.launches
    torch.cuda.synchronize()
    with torch.inference_mode():
        model(torch.zeros((1, 512, 512, 3), device="cuda"))
    backbone_per_forward = gn.launches - n1
    main_launches = n1
    serve_s = time.perf_counter() - t
    mask_launches = n1 - n0 - backbone_per_forward
    log(f"  served 3 batches of 8, 2 single images and 1 pinned batch in {serve_s:.2f} s")
    log(f"  GroupNorm kernel launches on the main path: {main_launches}; per 512x512 "
        f"forward (backbone + heads): {backbone_per_forward}; mask head on the pinned "
        f"batch: {mask_launches} ({mask_launches // 3} chunk(s) x 3 norms)")
    require(backbone_per_forward > 0 and main_launches >= 6 * backbone_per_forward,
            "the backbone did not go through the kernel")
    require(mask_launches > 0, "the mask head did not go through the kernel")
    for o in outs:
        check_infer_output(torch, o, 8, cfg, 512, 512)
    check_infer_output(torch, pinned_out, 8, cfg, 512, 512)
    require(bool(pinned_out["valid"][:, :PINNED_DETS].all()), "pinned slots lost")
    fg = float((pinned_out["label_map"] > 0).float().mean())
    log(f"  found detections per batch: {[int(o['valid'].sum()) for o in outs]}; "
        f"pinned batch foreground share {fg:.3f}")
    require(fg > 0.01, "pinned detections pasted no mask")
    for im, p in zip(singles, preds):
        require(p["label_map"].shape == im.shape[:2] and p["label_map"].dtype == np.int32,
                "predictor label map shape/dtype")
        n = p["num_instances"]
        require(p["boxes"].shape == (n, 4) and p["masks"].shape[0] == n,
                "predictor output counts")
        require(0 <= p["label_map"].min() and p["label_map"].max() <= n,
                "predictor label ids outside [0, n]")
        require(np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all(),
                "predictor outputs are not finite")
    log(f"  predictor: {[(im.shape[:2], p['num_instances']) for im, p in zip(singles, preds)]}")

    # 4. whole path: kernel vs plain GroupNorm on the same pinned batch
    log("[4] whole path with the plain GroupNorm on the same pinned batch")
    before = gn.launches
    model.use_plain_norm(True)
    found_p, plain_out = pinned_call(model, cfg, pinned_imgs, pinned)
    model.use_plain_norm(False)
    require(gn.launches == before, "the plain run launched the kernel")
    same = float((plain_out["label_map"] == pinned_out["label_map"]).float().mean())
    same_dets = bool(torch.equal(found_p.valid, found.valid))
    mask_err = float((plain_out["masks"] - pinned_out["masks"])[:, :PINNED_DETS].abs().max())
    log(f"  label-map pixels equal: {same:.5f} (floor {LABEL_AGREEMENT_FLOOR}); "
        f"mask prob max abs diff {mask_err:.4f}; same detector valid slots: {same_dets}")
    require(same >= LABEL_AGREEMENT_FLOOR, "kernel and plain label maps disagree")

    # e2e throughput (bench.py protocol: batch 32, 512x512, 24 pinned dets)
    imgs32 = torch.from_numpy(
        rng.integers(0, 256, (E2E_BATCH, 512, 512, 3), dtype=np.uint8)).cuda()
    dets32 = seeded_dets(cfg, E2E_BATCH, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e2e = e2e_bench(model, cfg, batch=E2E_BATCH, ndets=PINNED_DETS)
    img_s = e2e["img_per_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dg = decode_group_bench(cfg, "cuda")
    stages = stage_times(torch, infer, model, cfg, imgs32, dets32)
    log(f"  e2e {img_s:.2f} img/s, median of {REPEATS} repeats of {e2e['iters']} "
        f"calls (min {e2e['img_per_s_min']:.2f}, max {e2e['img_per_s_max']:.2f}; batch "
        f"{E2E_BATCH}, {PINNED_DETS} pinned dets/img, peak {peak_gb:.2f} GB), "
        f"{e2e['flops_per_img'] / 1e9:.2f} GFLOP/img (FlopCounterMode); decode+group+nms "
        f"{stages['decode_group_nms'] / E2E_BATCH:.4f} ms/img (stage of the batch-{E2E_BATCH} "
        f"call), {dg['ms_per_img']:.4f} ms/img (bench protocol, batch {dg['batch']}; min "
        f"{dg['ms_per_img_min']:.4f}, max {dg['ms_per_img_max']:.4f})")
    log("  stages, ms per batch of %d: %s" % (E2E_BATCH, ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items())))
    log("  GroupNorm kernel at the shapes of one e2e call (bf16, ReLU):")
    gn_rows = gn_per_shape(torch, gn, gn_shape_counts(
        lambda: pinned_call(model, cfg, imgs32, dets32)))
    if "--profile" in sys.argv[1:]:
        profile_e2e(torch, lambda: pinned_call(model, cfg, imgs32, dets32))

    # 5. the Gaussian target kernel
    log("[5] Gaussian target kernel vs plain PyTorch version")
    gstats = phase_gaussian(np, torch, gauss)

    # 6. train the default Config at full width
    log("[6] training the default Config (batch 8, 512x512, lr_warmup_steps=1)")
    del model, infer_fn, predictor, imgs32, dets32
    tcfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_warmup_steps=1))
    state, tbatch, tstats = phase_train(np, torch, gn, gauss, tcfg)

    # 7. serve from the trained model
    log("[7] serving from the trained model (eval mode, GroupNorm kernel)")
    trained = state.model.eval()
    gn.launches = gauss.launches = 0
    with torch.no_grad():
        served = infer.build_infer_fn(trained, tcfg)(tbatch["image"])
    torch.cuda.synchronize()
    require(gn.launches >= GN_PER_FORWARD and gauss.launches == 0, f"serving the trained model "
            f"launched the GroupNorm kernel {gn.launches} and the Gaussian kernel "
            f"{gauss.launches} times")
    check_infer_output(torch, served, tcfg.train.batch_size, tcfg, 512, 512)
    log(f"  GroupNorm kernel launches: {gn.launches}; detections per image "
        f"{[int(v) for v in served['valid'].sum(1)]}")

    # 8. the trained flagship through the port's checkpoint and CLIs
    log("[8] serving the trained flagship (assets_torch) through from_checkpoint and "
        "kgtpu_torch.cli.test, scored with the port's evaluate")
    del trained, state, tbatch, served
    torch.cuda.empty_cache()
    fstats = phase_flagship(np, torch, gn, gauss)

    # 9. the training CLI
    log(f"[9] training from the CLI (python -m kgtpu_torch.cli.train, in-process; default "
        f"Config, batch 8, 512x512, synthetic) for {CLI_EPOCHS} epochs, then --resume")
    torch.cuda.empty_cache()
    cstats = phase_train_cli(np, torch, gn, gauss)

    # 10. TTA, ensemble and tiling with the flagship
    log("[10] TTA (3 scales + flip), ensemble (EMA + raw) and whole-slide tiling with the "
        "flagship through kgtpu_torch.cli.test, f32 and bf16, against kgtpu's reference")
    torch.cuda.empty_cache()
    ttastats = phase_tta(np, torch, gn, smi)

    # 11. the other backbones, norms and decoders
    log("[11] the unet flagship and the heterogeneous ensemble through cli.test (f32, bf16) "
        "against kgtpu's reference; the unet's batch-32 e2e call; resnet_fpn, hourglass_fast, "
        "inter_inject, norm=batch and centernet served and trained at full width; remat")
    torch.cuda.empty_cache()
    bstats = phase_backbones(np, torch, gn, gauss)

    # 12. users' own files
    log("[12] users' files: every format decoded as cv2 decodes it, the flagship over JPEG "
        "and mixed folders, cli.train on coco and neural_cells, the RSS watchdog")
    torch.cuda.empty_cache()
    xstats = phase_formats(np, torch, gn, gauss, fstats)

    metrics = {"e2e_img_per_s": img_s, "e2e_img_per_s_min": e2e["img_per_s_min"],
               "e2e_img_per_s_max": e2e["img_per_s_max"], "e2e_repeats": REPEATS,
               "e2e_img_per_s_all": e2e["img_per_s_all"], "e2e_batch": E2E_BATCH,
               "gflops_per_img": e2e["flops_per_img"] / 1e9,
               "pinned_dets_per_img": PINNED_DETS,
               "decode_group_ms_per_img": stages["decode_group_nms"] / E2E_BATCH,
               "decode_group_bench_ms_per_img_b16": dg["ms_per_img"],
               "decode_group_bench_ms_per_img_b16_min": dg["ms_per_img_min"],
               "decode_group_bench_ms_per_img_b16_max": dg["ms_per_img_max"],
               "peak_mem_gb": peak_gb,
               "gn_launches_per_forward": backbone_per_forward,
               "gn_launches_mask_head_pinned_batch": mask_launches,
               "label_map_agreement_vs_plain": same,
               "gn_per_shape_b32": gn_rows,
               "gauss_exps_within_reach": gstats["exps_within_reach"],
               "gauss_wrapper_host_us": gstats["host_us"],
               **tstats, **fstats, **cstats, **ttastats, **bstats, **xstats, "card": smi}
    log("metrics " + json.dumps(metrics))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    kernel = {"name": "group_norm_relu", "route": "cuda",
              "source": "kgtpu_torch/csrc/groupnorm.cu",
              "replaces": "kgtpu/ops/pallas/groupnorm.py:119",
              "launches": main_launches,
              "launches_by_phase": {"serve [3]": main_launches,
                                    "train [6]": tstats["gn_launches_train"],
                                    "flagship bf16 [8]": fstats["flagship_gn_launches_bf16"],
                                    "flagship f32 [8]": fstats["flagship_gn_launches_f32"],
                                    "train CLI [9]": cstats["train_cli_gn_launches"],
                                    **{f"{name} {short} [10]": ttastats[f"{name}_gn_launches_{short}"]
                                       for short in ("f32", "bf16") for name in TTA_RUNS},
                                    "TTA timed batch [10]": ttastats["tta_gn_launches_per_batch"],
                                    "2048 slide [10]": ttastats["slide_2048_gn_launches"],
                                    **{f"{name} {short} [11]": bstats[f"{name}_gn_launches_{short}"]
                                       for short in ("f32", "bf16") for name in UNET_RUNS},
                                    "unet e2e b32 [11]": bstats["unet_e2e_gn_launches"],
                                    **{f"{name} serve [11]": v["gn_launches_serving"]
                                       for name, v in bstats["variants"].items()},
                                    "JPEG folder f32 [12]": xstats["jpeg_gn_launches_f32"],
                                    "JPEG folder bf16 [12]": xstats["jpeg_gn_launches_bf16"],
                                    "mixed folder [12]": xstats["mixed_gn_launches"]},
              "max_abs_err": kstats["max_abs_err"],
              "ms": kstats["ms"], "device_ms": kstats["device_ms"],
              "plain_ms": kstats["plain_ms"],
              "bound_ms": kstats["bound_ms"], "bound_by": "bytes",
              "library_ms": kstats["library_ms"]}
    gkernel = {"name": "render_heatmaps", "route": "cuda",
               "source": "kgtpu_torch/csrc/gaussian.cu",
               "replaces": "kgtpu/ops/pallas/gaussian.py:74",
               "launches": tstats["gauss_launches"],
               "launches_by_phase": {"train [6]": tstats["gauss_launches"],
                                     "train CLI [9]": cstats["train_cli_gauss_launches"],
                                     **{f"{name} train [11]": v["gauss_launches_train"]
                                        for name, v in bstats["variants"].items()},
                                     **{f"{name} train [12]": xstats[f"train_{name}_gauss_launches"]
                                        for name in TRAIN_FORMAT_STEPS}},
               "max_abs_err": gstats["max_abs_err"],
               "ms": gstats["ms"], "device_ms": gstats["device_ms"],
               "plain_ms": gstats["plain_ms"],
               "bound_ms": gstats["bound_ms"], "bound_by": gstats["bound_by"],
               "library_ms": None}
    print(json.dumps({"kernels": [kernel, gkernel]}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
