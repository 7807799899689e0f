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
    every shape of the batch-32 e2e call: CUDA-event and device ms (the
    latter from torch.profiler in a fresh process), HBM bound, launches per
    call and the wrapper's host enqueue time.
[5] Holds the Gaussian target kernel against its plain version on hard
    cases (empty and full images, border-touching and tiny boxes, two
    instances on one pixel, a ragged height and width, sizes whose radius
    lies just below or above an integer) and times it (its device ms from
    torch.profiler in a fresh process).
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
    thousands off).  The bf16 run must launch the GroupNorm kernel.  The
    port's compiled host ops (`kgtpu_torch/native.py`, g++ at first use)
    must build and load: evaluate's f32 IoU and the loader's boxes and
    renumbering go through them, as kgtpu's do by default; the reference
    metrics are kgtpu's with its compiled f32 IoU.
[9] Trains from the command line: `python -m kgtpu_torch.cli.train`, called
    in-process, at full width (the default Config, batch 8, 512x512, EMA,
    lr 1e-3 after 50 warmup steps) on `synthetic` (64 generated images,
    rotation up to 15 degrees) for CLI_EPOCHS epochs of CLI_STEPS steps,
    evaluated on the 16 val images at the last one, then `--resume` for one
    more epoch of CLI_RESUME_STEPS steps.  Requires: the EMA weights' val mAP_dsb2018 and AP50 above
    their floors; a Gaussian launch every step; at least 58 GroupNorm
    launches per eval batch of 8 (raw and EMA weights) and none in
    training; best.json naming a checkpoint that exists; exactly
    --keep_last checkpoint directories; one metrics.jsonl line per epoch;
    the resumed run starting at the saved epoch and step; and `cli.test`
    on the best checkpoint, serving the 16 val images, giving the label
    maps of the in-training eval.  Times the CLI's steady img/s (eval and
    saves excluded), its wait for batches per step, the host's ms per
    augmented 512x512 sample (with the compiled host ops), and each host
    op's ms per 512x512 label map of HOST_OP_INSTANCES instances, compiled
    and NumPy, in this process.
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
    (full width, 512x512, batch 8) for 5 steps on `--dataset coco` and 5 on
    `--dataset neural_cells`, the datasets built in a temporary directory
    from the fixtures: every sample's image and label map equal to kgtpu's
    readers' (by sha256), a finite loss, one Gaussian launch per step.  (d)
    The host-RSS watchdog in a subprocess (`os.execv` would replace this
    script): `python -m kgtpu_torch.cli.train` at a small size for 2 epochs
    with --rss_limit_gb 0.001 re-execs exactly once, resumes at epoch 1,
    writes two metrics.jsonl lines and exits 0.  Budget FORMATS_PHASE_S.
[13] The serving export and the debugging flags.  (a) The flagship
    (assets_torch/flagship_ema) exported with `kgtpu_torch.export.export_infer`
    at batch 16, 512x512, in f32 and in bf16, into a temporary directory,
    loaded with `load_serving` and run on the 16 images: integer outputs and
    label maps equal to the live `build_infer_fn`'s in this process, floats
    within 1e-4 (f32), [8]'s gates against kgtpu's reference, and the
    GroupNorm kernel launched as many times inside the artifact as by the
    live call; prints export s, artifact bytes and ms per batch of the
    artifact and of the live path (median of 5, timed at the end of the
    phase), and the host syncs of one call of each; a tiny artifact traced on the CPU is served on the card
    (`load_serving` moves it) and launches the kernel.  (b) The TTA
    artifact (3 scales + flip, batch 8) and the tiled one (a 1024x1024
    slide, 9 tiles of 512 in two chunks; [10] times the 2048x2048 slide)
    equal to the live builders in f32.  The TTA artifact is written by the
    export CLI (`python -m kgtpu_torch.export --tta`) in a process of its
    own, started with the phase and traced while this one runs (a), the
    tiled part and (c); it is served here after (c).  (c) `cli.test --save_vis
    --debug_nans` over the 16 images (16 overlays, label maps equal to the
    live f32 path's), `cli.train --profile_dir --debug_nans` for 2 steps (a
    non-empty trace), and a checkpoint with one NaN weight under
    --debug_nans stopping `cli.test` with FloatingPointError.  Budget
    EXPORT_PHASE_S.
[14] Captured multi-step training and data parallelism.  (a) The default
    Config at full width (batch 8, 512x512, EMA 0.999), from one seeded
    state and 8 seeded batches with their draws: 8 eager steps, twice (the
    yardstick), then 2 replays of k = 4 steps captured as one CUDA graph
    (`train_lib.make_train_multi_step`, the batches staged from host NumPy);
    again with norm=batch.  The losses agree within rtol 1e-4; every
    parameter, Adam moment, EMA entry and running stat lies within twice
    the two eager runs' gap plus kgtpu's multi-step tolerance (rtol 1e-5,
    atol 1e-6); whether they are bitwise equal, and the largest gaps, are
    printed.  The Gaussian kernel counts its launches on every replay (and
    the capture's warm-up of k eager steps).  Fixed-batch train img/s at
    k = 1 (eager) and k = 4 and 8 (graph): median of 5 rounds of 8 steps with
    min and max, the host's ms per step, the device's idle share and the
    peak memory.  (b) In a fresh process (this script with --graph-profile,
    since the earlier phases' profiling leaves this one's profiler short of
    records): a profiled replay holds k device records of the Gaussian
    kernel (an empty or short window is measured again), and the replay's
    loss equals the loss with plain targets on the same state.  (c)
    `cli.train --steps_per_dispatch 4` and 1 (twice, the yardstick) on
    `synthetic` (8 images), batch 8, 512x512: one epoch of 6 steps (a dispatch and a
    2-step tail), then one more with --resume; metrics.jsonl and the
    checkpoints' tensors held to (a)'s bound; the CLI's img/s and wait per
    step.  (d) `cli.train --coordinator localhost:<port> --num_hosts 1`
    (NCCL, one rank) for 5 steps at k = 1 and k = 2 (the all-reduces inside
    the graph): losses within 1e-4 of the run without a process group; the
    all-reduces per step; `build_infer_fn(devices=<every card>)` equal to
    the unsharded call, through the GroupNorm kernel.  The machine has one
    H100, so no run here checks more than one rank on the card.  Budget
    CAPTURE_PHASE_S.
[15] Format variants.  (a) Decodes every fixture of assets_torch/formats/
    variants (the 16 synthetic_hard images at 512x512, each in one variant:
    planar tiled and old-LZW TIFF, YCbCr and CMYK TIFF, CMYK / YCCK /
    lossless JPEG, sequential and progressive arithmetic JPEG, JPEG in
    TIFF, RLE8 / 565 / OS/2 BMP, Group 4 and Group 3 2-D TIFF) in every mode
    with the port's readers: each equals cv2's sha256, shape and dtype
    (kgtpu_reference_formats.npz `variants_decode_json`), or raises
    UnreadableImage where cv2 returns None; times each variant (median of 3
    reads, or 1 read for a decoder over SLOW_DECODE_MS; ms per image and
    per 512x512 of pixels) beside the card's name and power limit.  (b) `cli.test --dataset folder` over that folder with
    the flagship in f32 and bf16, held against kgtpu's committed runs on the
    same files with [8]'s gates, the GroupNorm kernel launched; the CLI's
    img/s beside [12]'s JPEG folder.  Budget VARIANTS_PHASE_S.  Then (a) and
    (b) over assets_torch/formats/variants2 (the 16 images in the damaged
    files and the variants ported since: a progressive JPEG cut at 30% of
    its scans and a progressive arithmetic JPEG of its DC scans only (block
    smoothing), a baseline JPEG with a Huffman code in no table, LZW TIFF
    with a byte changed, damaged Group 3 and Group 4 TIFF, CCITT RLEW,
    lossless JPEG with subsampled chroma, 16-bit grey of three samples, a
    palette with an extra sample and a 16-bit one without a ColorMap, a
    codec libtiff does not know, JPEG TIFF in separate planes, 4x4 YCbCr,
    SGILog LogL and ThunderScan; `variants2_*` keys), and (a) alone over
    assets_torch/formats/variants2_extra (256x256 files cv2 reads in
    "unchanged" only, or not at all: 10-, 12- and 14-bit grey, 12-bit RGB,
    a PNG cut mid-file, SGILog24 LogLuv; `variants2_extra_*`).  Budget
    VARIANTS2_PHASE_S.
[16] Image containers.  [15]'s (a) and (b) over assets_torch/formats/
    containers: the 16 synthetic_hard images at 512x512, each in a
    container cv2 5.0 sniffs by content, named with one of kgtpu's
    extensions (.png, .jpg, .tif, .bmp): P6 PPM, P5 PGM, GRAYSCALE PAM, P4
    PBM, 8-bit palette Sun raster, run-length Radiance HDR, plain,
    interlaced, animated and transparent GIF, lossless, lossy (quality 90
    and 50), lossy with alpha, animated and simple-loop-filter WebP
    (`containers_decode_json` and `*_containers_*` of
    kgtpu_reference_formats.npz).  A decoder over SLOW_DECODE_MS is timed
    by one read.  Budget CONTAINERS_PHASE_S.
[17] JPEG 2000.  [15]'s (a) and (b) over assets_torch/formats/jpeg2000: the
    first 8 synthetic_hard images at 512x512, each in one JPEG 2000 kind,
    named with kgtpu's extensions: cv2's lossless default (5/3, RCT) and
    its IMWRITE_JPEG2000_COMPRESSION_X1000 200 and 50, PIL's raw codestream
    with the 9/7 wavelet in three quality layers, grey in 128x128 tiles
    with RPCL and 64x64 precincts, PCRL with 32x32 code-blocks, 3
    resolutions and no colour transform, RGBA (cdef alpha) with CPRL and 7
    resolutions, and 16-bit grey with RLCP (`jpeg2000_decode_json` and
    `*_jpeg2000_*`).  The pure-Python decoder takes seconds per image; each
    kind is timed alone.  Budget JPEG2000_PHASE_S.  Then (c),
    decode only: assets_torch/formats/jpeg2000_styles, 128x128 files in the
    code-block styles (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM, all six
    lossless and in 9/7 layers, grey in layers, 16-bit grey) against cv2's
    hashes (`jpeg2000_styles_decode_json`) in the same processes, each kind
    timed by one read; budget JPEG2000_STYLES_S.  Then (d), decode only:
    assets_torch/formats/jpeg2000_ht, 128x128 files of HT code-blocks (Part
    15: RGB and grey lossless, 9/7, 16-bit grey, RGBA, tiles with
    precincts, 4x4 and 16x8 code-blocks with RPCL, SigProp + MagRef, two
    layers with VSC) and one with Part 2 MCT / MCC / MCO offsets, written by
    tools/variant_encoders.jpeg2000_ht, against cv2's hashes
    (`jpeg2000_ht_decode_json`) in the same processes, each kind timed by
    one read; budget JPEG2000_HT_S.
[18] AVIF.  (a) assets_torch/formats/avif, 128x128 cuts of the synthetic_hard
    images: cv2's lossless RGB, grey, RGBA, 10- and 12-bit; PIL's lossy
    4:2:0 at two qualities (one with quantiser matrices), 4:2:2, 4:4:4
    without in-loop filters, screen content with palettes, 2x2 tiles,
    128x128 superblocks and an image sequence; libaom's own encoder's lossy
    monochrome, intra block copy (a 128x768 strip) and a 2x2 grid; and the
    kinds whose frames need AV1's deblocking, or deblocking and CDEF: cv2's
    quality 90 and 80, PIL's default, PIL's 4:2:2 with CDEF, cv2's 10-bit
    quality 80, libaom's delta loop filter levels and its 128x128
    superblocks with CDEF; the kinds whose frames need loop restoration or
    superres, from libaom's good-quality usage: 4:2:0 and 4:4:4 with
    restoration in luma and chroma, 128x128 superblocks, 2x2 tiles and 10
    bits with restoration, superres at denominator 12 with deblocking and
    CDEF and at 16 with restoration; each in every mode against cv2's hashes
    (`avif_decode_json`), each kind timed by one read (the filters' host ms
    beside it: deblocking + CDEF, superres + loop restoration); budget
    AVIF_DECODE_S.  (b) assets_torch/formats/avif_folder, the first 6
    synthetic_hard images at 512x512 as cv2's lossless and quality 80,
    PIL's filter-free lossy and default and libaom's good-quality AVIF
    (loop restoration) under .png / .jpg / .tif / .bmp names: their hashes,
    one read per kind timed, then
    [15]'s (b) (`avif_folder_*` keys: kgtpu's f32 and bf16 runs on cv2's
    reads of the same files; the f32 mAP must equal kgtpu's exactly);
    budget AVIF_SERVE_S.
The decode checks of [15]-[18] share one pool of DECODE_WORKERS spawned
processes, and their folders are served with `cli.test --decode_workers
DECODE_WORKERS` (the images read in that many processes, in order).

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

import contextlib
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 1050           # the run's limit is 1200 s
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
CLI_RESUME_STEPS = 10       # the resumed epoch's steps (cut from 40 for the run's time)
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
TRAIN_FORMAT_STEPS = {"coco": 5, "neural_cells": 5}   # coco cut from 10 for the run's time
WATCHDOG_FLAGS = ["--dataset", "synthetic", "--synthetic_n", "8", "--input_size", "64",
                  "--batch_size", "2", "--steps_per_epoch", "2", "--num_epochs", "2",
                  "--backbone", "hourglass_lite", "--num_stacks", "1", "--roi_size", "8",
                  "--mask_size", "16", "--K", "32", "--max_detections", "32",
                  "--rss_limit_gb", "0.001"]
FORMATS_PHASE_S = 150       # phase [12]'s budget
EXPORT_PHASE_S = 200        # phase [13]'s budget
# phase [14]: captured multi-step training and data parallelism
CAPTURE_BATCHES, CAPTURE_K = 8, 4
TIMED_KS = (1, 4, 8)
TIMED_REPEATS = 5
CAPTURE_LOSS_RTOL = 1e-4
MULTI_RTOL, MULTI_ATOL = 1e-5, 1e-6     # kgtpu's multi-step tolerance, tests/test_train.py
CAPTURE_CLI_FLAGS = ["--dataset", "synthetic", "--synthetic_n", "8", "--ema_decay", "0.999",
                     "--lr", "1e-3", "--eval_every", "0", "--rss_limit_gb", "0"]
CAPTURE_CLI_STEPS, CAPTURE_CLI_K = 6, 4   # 6 cut from 10 for the run's time
DP_STEPS = 5
# phase [15]: the image-format variants cv2 reads
VARIANTS_DIR = os.path.join(FORMATS, "variants")
VARIANTS_PHASE_S = 150      # phase [15]'s budget for formats/variants
VARIANTS2_DIR = os.path.join(FORMATS, "variants2")
VARIANTS2_EXTRA_DIR = os.path.join(FORMATS, "variants2_extra")
VARIANTS2_PHASE_S = 150     # ... and for formats/variants2 and variants2_extra
SLOW_DECODE_MS = 1000       # [15] / [16]: a decode over this is timed once, not 3 times
# phase [16]: the image containers cv2 sniffs, under kgtpu's file names
CONTAINERS_DIR = os.path.join(FORMATS, "containers")
CONTAINERS_PHASE_S = 120    # phase [16]'s budget
# phase [17]: JPEG 2000 under kgtpu's file names
JPEG2000_DIR = os.path.join(FORMATS, "jpeg2000")
JPEG2000_PHASE_S = 150      # phase [17]'s budget
JPEG2000_STYLES_DIR = os.path.join(FORMATS, "jpeg2000_styles")
JPEG2000_STYLES_S = 30      # [17] (c)'s budget
JPEG2000_HT_DIR = os.path.join(FORMATS, "jpeg2000_ht")
JPEG2000_HT_S = 20          # [17] (d)'s budget
DECODE_WORKERS = 8          # [15]-[18]: one process pool for the decode checks, and
                            # cli.test --decode_workers for the folders served
# phase [18]: AVIF
AVIF_DIR = os.path.join(FORMATS, "avif")
AVIF_DECODE_S = 25          # [18] (a)'s budget
AVIF_FOLDER_DIR = os.path.join(FORMATS, "avif_folder")
AVIF_SERVE_S = 60           # [18] (b)'s budget
HOST_OP_INSTANCES = 120     # [9]: instances of the label map the host ops are timed on
CAPTURE_PHASE_S = 180       # phase [14]'s budget
GRAPH_PROFILE_FLAG = "--graph-profile"   # runs [14](b) alone, in a fresh process
KERNEL_PROFILE_FLAG = "--kernel-profile"  # [4]'s and [5]'s device ms, in a fresh process


def require(cond, msg: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def f6(v) -> str:
    """A stored reference metric, or "null" where the reference holds none
    (tools/make_torch_eval_assets.py --only rescore)."""
    return "null" if v is None else f"{v:.6f}"


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


# kernel_device_ms calls whose device time came from CUDA events because the
# profiler traced nothing (reported in the metrics line)
PROFILER_BLIND: list = []


def record_lead(torch, prof) -> str:
    """How far the window's first device record was stamped after its first
    launch call (negative: before it), in microseconds."""
    ev = prof.events()
    dev = [e.time_range.start for e in ev if e.device_type != torch.autograd.DeviceType.CPU]
    calls = [e.time_range.start for e in ev
             if e.device_type == torch.autograd.DeviceType.CPU and "Launch" in e.name]
    if not (dev and calls):
        return "no launch call or device record to compare"
    return f"first device record {min(dev) - min(calls):+.1f} us from the first launch call"


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
    alone is measured up to four more times before it fails.  Where every
    window held no device record of any kind (the profiler traced nothing;
    five such windows in a row have been seen on one machine), the device time
    comes from CUDA events around the same calls instead, and the call is
    listed in PROFILER_BLIND."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want, attempts, blind = iters * launches_per_call, 5, 0
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
        blind += not device
        log(f"  profiler saw {count} launches of {names} in {iters} calls, want {want}; "
            f"the wrapper launched all {made}; device records of any kind in the window: "
            f"{sum(e.count for e in device)}; {record_lead(torch, prof)}"
            + ("; measuring again" if attempt < attempts - 1 else ""))
    if blind == attempts:
        ms = cuda_time_ms(fn, iters=iters, warmup=0)
        PROFILER_BLIND.append({"kernels": list(names), "event_ms": ms})
        log(f"  the profiler traced no device activity in {attempts} windows: device time "
            f"from CUDA events instead, {ms:.4f} ms a call")
        return ms
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


def enqueue_us(torch, call, n: int = 50) -> float:
    """Host microseconds per call over n back-to-back calls (enqueue only),
    median of 3 such runs."""
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            call()
        runs.append((time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[1]


def gn_shape_call(torch, gn, shape):
    """One GroupNorm kernel call (bf16, ReLU, unit affine) on a random
    channels-last input of `shape`."""
    c = shape[1]
    x = torch.randn(shape, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    return x, w, b, lambda: gn.group_norm_relu(x, w, b, gn.num_groups(c), True)


def device_ms_fresh(spec: dict) -> dict:
    """Kernel device ms from torch.profiler in a fresh process (this script
    with KERNEL_PROFILE_FLAG and `spec`): {"group_norm": [shape, ...]} gives
    {"group_norm": {shape: ms}} as `gn_shape_call` calls it, {"gaussian":
    true} gives {"gaussian": ms} on [5]'s timed scene.  A process that had
    profiled before has kept too few kernel records in every window of one
    measurement while the wrapper's count was whole (19 of 20 GroupNorm
    records in [4], 18 of 20 Gaussian ones in [5]; H100 80GB HBM3 runs),
    and a window in a fresh process never has (`kernel_device_ms`'s notes;
    [14](b) profiles in a fresh process for the same reason).  Its log
    lines are printed here; its last line is the JSON result."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), KERNEL_PROFILE_FLAG,
                        json.dumps(spec)], capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    require(r.returncode == 0 and lines, f"the profiled kernels exited with {r.returncode}: "
            f"{r.stderr[-3000:]}")
    out = json.loads(lines[-1])
    if "group_norm" in out:
        out["group_norm"] = {tuple(k): v for k, v in out["group_norm"]}
    return out


def kernel_profile_main() -> int:
    """KERNEL_PROFILE_FLAG: `device_ms_fresh`'s measurements for the JSON
    spec that follows the flag, printed as JSON on the last line."""
    import numpy as np
    import torch
    spec = json.loads(sys.argv[sys.argv.index(KERNEL_PROFILE_FLAG) + 1])
    out = {}
    if "group_norm" in spec:
        from kgtpu_torch.ops import groupnorm as gn
        gn.build()
        out["group_norm"] = []
        for shape in spec["group_norm"]:
            _, _, _, call = gn_shape_call(torch, gn, tuple(shape))
            out["group_norm"].append([shape, kernel_device_ms(
                torch, call, ("group_norm_kernel",), 1, lambda: gn.launches)])
    if spec.get("gaussian"):
        from kgtpu_torch.ops import gaussian as gauss
        gauss.build()
        call = gaussian_timed_call(np, torch, gauss)[3]
        out["gaussian"] = kernel_device_ms(torch, call, ("render_kernel",), 1,
                                           lambda: gauss.launches)
    print(json.dumps(out), flush=True)
    return 0


def gn_per_shape(torch, gn, counts: dict) -> list:
    """The kernel at every shape of the e2e call (bf16, ReLU): CUDA-event ms
    over back-to-back calls, device ms from torch.profiler (one launch per
    call, in a fresh process: `device_ms_fresh`), the HBM bound and the
    wrapper's host time per call (enqueue only: host clock over 50 calls,
    no synchronize inside), as eager calls make it and through the
    registered op, as an exported program does."""
    rows = []
    order = sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][2] * kv[0][3])
    device = device_ms_fresh({"group_norm": [shape for shape, _ in order]})["group_norm"]
    for shape, n in order:
        c = shape[1]
        x, w, b, call = gn_shape_call(torch, gn, shape)
        ms = cuda_time_ms(call)
        dev = device[tuple(shape)]
        host_us, op_us = (enqueue_us(torch, f) for f in (
            call, lambda: torch.ops.kgtpu_torch.group_norm_relu(x, w, b, gn.num_groups(c), True)))
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": list(shape), "launches": n, "ms": ms, "device_ms": dev,
                     "bound_ms": bound, "host_us": host_us, "host_us_op": op_us})
        log(f"  gn {str(list(shape)):20s} x{n:<3d} {ms:.4f} ms, device {dev:.4f} ms, bound "
            f"{bound:.4f} ms ({bound / dev:.2f} of it), host {host_us:.1f} us/call ({op_us:.1f} "
            f"through the registered op)")
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


def gaussian_timed_call(np, torch, gauss):
    """[5]'s timed scene ([8, 128, 128, 5], N = 128, 40 valid instances an
    image) and one render of it by the kernel's wrapper: (kpts, sizes,
    valid, call)."""
    kpts, sizes, valid = gaussian_scene(np, torch, 8, 128, 128, 128, [40] * 8, seed=20)
    return kpts, sizes, valid, lambda: gauss.render_heatmaps(kpts, sizes, valid, 128, 128)


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

    kpts, sizes, valid, call = gaussian_timed_call(np, torch, gauss)
    ms = cuda_time_ms(call, iters=50)
    device_ms = device_ms_fresh({"gaussian": True})["gaussian"]
    plain_ms = cuda_time_ms(lambda: render_heatmaps_batch(kpts, sizes, valid, 128, 128))
    bound_ms, bound_by, exps = gaussian_bound_ms(torch, kpts, sizes, valid, 128, 128)
    log(f"  timed [8,128,128,5], N=128, 40 valid/img: wrapper {ms:.4f} ms, kernel device "
        f"time {device_ms:.5f} ms (torch.profiler, a fresh process), plain {plain_ms:.4f} ms, bound "
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
        out["label_map"].append(renumber_label_map(label, remap).astype(np.uint16))
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
    from kgtpu_torch import native
    from kgtpu_torch.ops import _cuda
    weights = os.path.join(ASSETS, "flagship_ema")
    images = os.path.join(ASSETS, "synthetic_hard", "images")
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference.npz"))
    ids = [str(i) for i in ref["ids"]]
    ref_metrics = json.loads(str(ref["metrics_json"]))
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}

    lib = native.get_lib()                    # built at first use, in [6]'s batches
    log(f"  compiled host ops: {lib._name if lib is not None else native.error} "
        f"(g++ {' '.join(_cuda.GXX_FLAGS)})")
    require(lib is not None, f"the host ops did not build: {native.error}")

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
                f"{f6(ref_metrics[dtype]['AP_coco'])}), AJI {m['AJI']:.6f} (kgtpu "
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


def host_op_ms(np, smi: str) -> dict:
    """Each host op's ms per 512x512 label map of HOST_OP_INSTANCES
    instances (filled ellipses, ids shuffled; the IoU against the map
    shifted by 3 pixels), compiled and NumPy, medians of 5 calls, in this
    process; the two paths' outputs must be equal."""
    from kgtpu_torch import evaluate, native
    from kgtpu_torch.data import transforms
    rng = np.random.default_rng(7)
    size = 512
    label = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    for cell in rng.permutation(np.arange(1, HOST_OP_INSTANCES + 1)):
        a, c = rng.uniform(6, 28, 2)
        cx, cy = rng.uniform(0, size, 2)
        label[((xx - cx) / a) ** 2 + ((yy - cy) / c) ** 2 <= 1.0] = cell
    pred = np.roll(label, (3, -2), (0, 1))
    remap = transforms.boxes_from_label_map(label, 128)[2]
    calls = {"boxes_from_label_map": lambda: transforms.boxes_from_label_map(label, 128),
             "renumber_label_map": lambda: transforms.renumber_label_map(label, remap),
             "iou_from_label_maps": lambda: evaluate.iou_from_label_maps(pred, label)[0]}
    compiled = native.get_lib
    out = {}
    for name, call in calls.items():
        row, results = {}, {}
        for path in ("compiled", "numpy"):
            native.get_lib = compiled if path == "compiled" else (lambda: None)
            try:
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    results[path] = call()
                    times.append((time.perf_counter() - t) * 1e3)
            finally:
                native.get_lib = compiled
            row[f"{path}_ms"] = sorted(times)[2]
        a, b = results["compiled"], results["numpy"]
        same = all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
            else np.array_equal(a, b)
        require(same, f"{name}: the compiled op and the NumPy path differ")
        out[name] = row
        log(f"  host op {name}: compiled {row['compiled_ms']:.3f} ms, NumPy "
            f"{row['numpy_ms']:.3f} ms per {size}x{size} map of {HOST_OP_INSTANCES} "
            f"instances (median of 5, outputs equal); {smi}")
    return out


def phase_train_cli(np, torch, gn, gauss, smi: str) -> dict:
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
        second = train_cli.run(flags + ["--num_epochs", str(CLI_EPOCHS + 1), "--resume",
                                        "--steps_per_epoch", str(CLI_RESUME_STEPS)])
        torch.cuda.synchronize()
        torch.set_num_threads(threads)
        log(f"  resumed at epoch {second['start_epoch']} step {second['start_step']}, ended at "
            f"step {second['end_step']}; launches: Gaussian {gauss.launches}, GroupNorm "
            f"{gn.launches}")
        require(second["start_epoch"] == CLI_EPOCHS and second["start_step"] == first["end_step"]
                == steps and second["end_step"] == steps + CLI_RESUME_STEPS,
                "the resumed run did not continue from the saved epoch and step")
        require(gauss.launches >= CLI_RESUME_STEPS and gn.launches == 0,
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
    from kgtpu_torch import native
    require(native.get_lib() is not None, "the host data path runs without its compiled ops")
    host = host_sample_ms(np, torch, base)
    ops = host_op_ms(np, smi)
    phase_s = time.perf_counter() - t_phase
    log(f"  steady state (epochs 1-{CLI_EPOCHS - 1}): {img_s:.2f} img/s, {step_ms:.1f} ms per "
        f"step, of which {wait_ms:.1f} ms waiting for the batch; host ms per augmented 512x512 "
        f"sample (compiled host ops): {', '.join(f'{k} {v:.1f}' for k, v in host.items())}; "
        f"{smi}")
    log(f"  phase [9]: {phase_s:.1f} s (budget {CLI_PHASE_S} s)")
    require(phase_s <= CLI_PHASE_S, f"phase [9] took {phase_s:.0f} s")
    return {"train_cli_img_per_s": img_s, "train_cli_step_ms": step_ms,
            "train_cli_wait_ms_per_step": wait_ms, "train_cli_first_wall_s": wall,
            "train_cli_val": m, "train_cli_steps": steps + CLI_RESUME_STEPS,
            "train_cli_gauss_launches": gauss_1, "train_cli_gn_launches": gn_1,
            "train_cli_eval_batches": eval_batches, "host_ms_per_sample": host,
            "host_op_ms_per_512x512": ops,
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
                    f"AP_coco {m['AP_coco']:.6f} (kgtpu {f6(want['AP_coco'])}), AJI "
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
                    f"{m['AP_coco']:.6f} (kgtpu {f6(want['AP_coco'])}), AJI {m['AJI']:.6f}, PQ "
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


class _FolderRun(dict):
    """One `cli.test` folder run held against kgtpu's (`folder_vs_kgtpu`)."""

    def require(self, what: str) -> None:
        dtype = self["dtype"]
        require(self["launches"] > 0, f"the {what} folder {dtype} did not launch the "
                "GroupNorm kernel")
        require(abs(self["dmap"]) <= MAP_TOL[dtype], f"{what} {dtype} mAP_dsb2018 "
                f"{self['mAP_dsb2018']} is off kgtpu's by {self['dmap']}")
        if dtype == "float32":
            require(self["count_diff_max"] == 0, f"{what} f32 instance counts off kgtpu's: "
                    f"{self['count_diffs']}")
            require(max(self["off"]) <= PIXELS_OFF_TOL, f"{what} f32 label maps off kgtpu's "
                    f"by {self['off']}")


def folder_vs_kgtpu(np, torch, gn, gauss, data_dir: str, ids: list, gt: dict, ref_labels,
                    ref_counts, ref_metrics: dict, dtype: str, save: str,
                    decode_workers: int = 0) -> _FolderRun:
    """`cli.test --dataset folder` over `data_dir` with the flagship (batch 16,
    512x512, --use_ema) in `dtype` (and --decode_workers), scored and held
    against kgtpu's run: mAP_dsb2018, instance counts and label-map pixels
    off, per image."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.data.png import read_png
    gn.launches = gauss.launches = 0                      # this path's run
    t = time.perf_counter()
    rc = test_cli.main(["--dataset", "folder", "--data_dir", data_dir,
                        "--weights", os.path.join(ASSETS, "flagship_ema"), "--use_ema",
                        "--input_size", "512", "--batch_size", "16", "--compute_dtype", dtype,
                        "--decode_workers", str(decode_workers), "--save_dir", save])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with open(os.path.join(save, "detections.json")) as f:
        det = {r["id"]: r for r in json.load(f)["images"]}
    require(rc == 0 and sorted(det) == sorted(ids), f"cli.test over {data_dir} {dtype} failed")
    m = eval_metrics(records(save, gt, 512))
    counts = np.array([det[i]["num_instances"] for i in ids])
    dcount = counts - ref_counts
    off = [int((read_png(os.path.join(save, f"{i}_label.png"), "unchanged")
                != ref_labels[k]).sum()) for k, i in enumerate(ids)]
    return _FolderRun(dtype=dtype, mAP_dsb2018=m["mAP_dsb2018"],
                      dmap=m["mAP_dsb2018"] - ref_metrics["mAP_dsb2018"],
                      counts=counts.tolist(), count_diffs=dcount.tolist(),
                      count_diff_max=int(np.abs(dcount).max()), off=off, wall=wall,
                      launches=gn.launches)


def format_serving(np, torch, gn, gauss, fstats: dict) -> dict:
    """[12] (b): the flagship over the baseline JPEGs (f32, bf16) against
    kgtpu's run on them, and over the mixed folder."""
    from kgtpu_torch.cli import test as test_cli
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
            r = folder_vs_kgtpu(np, torch, gn, gauss, os.path.join(FORMATS, "jpeg"), ids, gt,
                                ref[f"labels_{dtype}"], ref[f"counts_{dtype}"],
                                ref_metrics[dtype], dtype, os.path.join(tmp, dtype))
            png_wall = fstats[f"flagship_cli_wall_s_{dtype}"]
            log(f"  JPEG folder {dtype}: mAP_dsb2018 {r['mAP_dsb2018']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['mAP_dsb2018']:.6f}, diff {r['dmap']:+.6f}, tol "
                f"{MAP_TOL[dtype]}); instances {r['counts']}, largest count diff "
                f"{r['count_diff_max']}, label-map pixels off kgtpu's: max {max(r['off'])}, "
                f"equal {r['off'].count(0)}/16; GroupNorm launches {r['launches']}; CLI "
                f"{16 / r['wall']:.2f} img/s ({r['wall']:.2f} s; the PNG folder of [8]: "
                f"{16 / png_wall:.2f} img/s)")
            r.require("JPEG")
            out.update({f"jpeg_mAP_dsb2018_{short}": r["mAP_dsb2018"],
                        f"jpeg_mAP_diff_{short}": r["dmap"],
                        f"jpeg_count_diff_max_{short}": r["count_diff_max"],
                        f"jpeg_pixels_off_max_{short}": max(r["off"]),
                        f"jpeg_cli_img_per_s_{short}": 16 / r["wall"],
                        f"png_cli_img_per_s_{short}": 16 / png_wall,
                        f"jpeg_gn_launches_{short}": r["launches"]})
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


def count_syncs(torch, call) -> int:
    """Host-device synchronisations in one `call` (torch's sync debug mode
    warns at each)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def write_like_cli(np, save: str, ids: list, out: dict) -> None:
    """Label PNGs and detections.json of `out` (a served batch, numpy) as
    `cli.test` writes them, for `cli.eval.records`."""
    from kgtpu_torch.data.png import write_png
    os.makedirs(save, exist_ok=True)
    images = []
    for k, iid in enumerate(ids):
        write_png(os.path.join(save, f"{iid}_label.png"), out["label_map"][k].astype(np.uint16))
        valid = out["valid"][k]
        images.append({"id": iid, "scores": out["scores"][k][valid].tolist(),
                       "num_instances": int(valid.sum())})
    with open(os.path.join(save, "detections.json"), "w") as f:
        json.dump({"images": images}, f)


def same_outputs(np, got: dict, want: dict, float_tol) -> float:
    """Integer outputs equal and floats within `float_tol` (None: not held);
    returns the largest float difference."""
    require(set(got) == set(want), f"outputs {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        require(g.shape == w.shape and g.dtype == w.dtype, f"{k}: {g.shape} {g.dtype} against "
                f"{w.shape} {w.dtype}")
        if np.issubdtype(w.dtype, np.floating):
            err = float(np.abs(g.astype(np.float64) - w).max()) if w.size else 0.0
            worst = max(worst, err)
            require(float_tol is None or err <= float_tol + float_tol * float(np.abs(w).max()),
                    f"{k} differs by {err}")
        else:
            require(np.array_equal(g, w), f"{k} differs in {int((g != w).sum())} entries")
    return worst


def stop_process(proc) -> None:
    """Kill `proc` if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def phase_export(np, torch, gn, gauss, smi: str) -> dict:
    """[13]: the flagship exported with `kgtpu_torch.export` and served from
    the reloaded artifact, against the live builders in the same process
    and against kgtpu's committed reference; the CLIs' --save_vis,
    --debug_nans and --profile_dir."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.cli import train as train_cli
    from kgtpu_torch.cli.eval import metrics as eval_metrics
    from kgtpu_torch.cli.eval import records
    from kgtpu_torch.config import required_divisor
    from kgtpu_torch.data.loader import prepare_sample
    from kgtpu_torch.data.png import read_png
    from kgtpu_torch.export import export_infer, load_serving, serving_model
    from kgtpu_torch.infer import build_infer_fn, build_multiscale_fn, build_tiled_infer_fn
    from kgtpu_torch.utils.debug import disable_nan_debugging
    t_phase = time.perf_counter()
    weights = os.path.join(ASSETS, "flagship_ema")
    images_dir = os.path.join(ASSETS, "synthetic_hard", "images")
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference.npz"))
    ids = [str(i) for i in ref["ids"]]
    ref_metrics = json.loads(str(ref["metrics_json"]))
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}
    pixels = [read_png(os.path.join(images_dir, f"{i}.png"), "color") for i in ids]
    to_np = lambda out: {k: v.cpu().numpy() for k, v in out.items()}
    out, live_f32, timed = {}, None, {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stops:
        # (b)'s TTA artifact (3 scales + flip, batch 8, f32): the export CLI
        # traces it in a process of its own while (a), the tiled part and (c) run
        tta_kw = dict(test_scales=(0.75, 1.0, 1.25), test_flip=True)
        tta_art = os.path.join(tmp, "tta.pt2")
        tta_log = os.path.join(tmp, "tta_export.log")
        tta_t0 = time.time()
        with open(tta_log, "w") as f:
            tta_proc = subprocess.Popen(
                [sys.executable, "-m", "kgtpu_torch.export", "--weights", weights,
                 "--out", tta_art, "--batch", "8", "--input_size", "512", "--use_ema",
                 "--tta", "--test_scales", ",".join(map(str, tta_kw["test_scales"])),
                 "--test_flip", "--compute_dtype", "float32"],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                stderr=subprocess.STDOUT)
        stops.callback(stop_process, tta_proc)      # on any way out of the phase
        # (a) single mode, batch 16, 512x512, f32 (TF32 off) and bf16
        for dtype in ("float32", "bfloat16"):
            short = "f32" if dtype == "float32" else "bf16"
            art = os.path.join(tmp, f"single_{short}.pt2")
            t = time.perf_counter()
            m = export_infer(weights, art, batch=16, input_size=512, use_ema=True,
                             compute_dtype=dtype)
            export_s = time.perf_counter() - t
            cfg, model = serving_model(weights, use_ema=True, input_size=512,
                                       compute_dtype=dtype)
            batch = torch.from_numpy(np.stack(
                [prepare_sample({"image": im, "label_map": gt[i]}, cfg.data)["image"]
                 for im, i in zip(pixels, ids)])).cuda()
            live = build_infer_fn(model, cfg)
            t = time.perf_counter()
            serve = load_serving(art)
            load_s = time.perf_counter() - t
            gn.launches = 0
            want = to_np(live(batch))
            torch.cuda.synchronize()
            n_live = gn.launches
            gn.launches = 0                           # the artifact's run
            got = to_np(serve(batch))
            torch.cuda.synchronize()
            n_art = gn.launches
            err = same_outputs(np, got, want, 1e-4 if dtype == "float32" else None)
            require(n_art == n_live > 0, f"{dtype}: the artifact launched the GroupNorm kernel "
                    f"{n_art} times, the live path {n_live}")
            timed[dtype] = (serve, live, batch)     # timed once the export process ends
            save = os.path.join(tmp, f"scored_{short}")
            write_like_cli(np, save, ids, got)
            metr = eval_metrics(records(save, gt, 512))
            counts = got["valid"].sum(1)
            dcount = counts - ref[f"counts_{dtype}"]
            off = [int((got["label_map"][k] != ref[f"labels_{dtype}"][k]).sum())
                   for k in range(len(ids))]
            dmap = metr["mAP_dsb2018"] - ref_metrics[dtype]["mAP_dsb2018"]
            log(f"  (a) single {dtype}: export {export_s:.1f} s, load {load_s:.1f} s, "
                f"{m['bytes']} bytes; GroupNorm launches {n_art} (live {n_live}); integer "
                f"outputs equal, largest float diff {err:.3g}")
            log(f"    against kgtpu's {dtype} run: mAP_dsb2018 {metr['mAP_dsb2018']:.6f} (diff "
                f"{dmap:+.6f}, tol {MAP_TOL[dtype]}), largest count diff "
                f"{int(np.abs(dcount).max())}, label pixels off: max {max(off)}")
            require(abs(dmap) <= MAP_TOL[dtype], f"artifact {dtype} mAP off kgtpu's by {dmap}")
            if dtype == "float32":
                require(not dcount.any(), f"artifact f32 counts off kgtpu's: {dcount.tolist()}")
                require(max(off) <= PIXELS_OFF_TOL, f"artifact f32 label maps off kgtpu's by "
                        f"{off} pixels")
                live_f32 = want["label_map"]
            out.update({f"export_single_s_{short}": export_s, f"export_load_s_{short}": load_s,
                        f"export_single_bytes_{short}": m["bytes"],
                        f"export_single_gn_launches_{short}": n_art,
                        f"export_single_float_err_{short}": err,
                        f"export_single_mAP_diff_{short}": dmap,
                        f"export_single_pixels_off_max_{short}": max(off)})
            del serve, live, model

        # an artifact traced on the CPU and served on the card: load_serving
        # moves it with move_to_device_pass (a tiny random model)
        from kgtpu_torch import checkpoint
        from kgtpu_torch.config import tiny_test_config
        from kgtpu_torch.models import build_model
        tiny = tiny_test_config()
        tw = checkpoint.write_payload(
            os.path.join(tmp, "tiny"), 0,
            {"params": build_model(tiny.model, seed=0, device="cpu").state_dict()},
            {"config_json": checkpoint.encode_config(tiny)})
        art = os.path.join(tmp, "tiny_cpu.pt2")
        export_infer(tw, art, batch=2, input_size=128, platforms=("cpu", "cuda"))
        imgs = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3), np.uint8)
        on_cpu = to_np(load_serving(art, device="cpu")(imgs))
        gn.launches = 0
        moved = load_serving(art)(imgs)
        torch.cuda.synchronize()
        moved_launches = gn.launches
        require(all(v.device.type == "cuda" for v in moved.values()) and moved_launches > 0,
                "the CPU-traced artifact did not serve on the card through the kernel")
        moved = to_np(moved)
        moved_err = max(float(np.abs(moved[k].astype(np.float64) - on_cpu[k]).max())
                        for k in on_cpu if np.issubdtype(on_cpu[k].dtype, np.floating))
        moved_px = int((moved["label_map"] != on_cpu["label_map"]).sum())
        log(f"  (a) an artifact traced on the CPU (tiny random model, batch 2, 128x128) served on "
            f"the card: GroupNorm launches {moved_launches}; against its CPU run, largest float "
            f"diff {moved_err:.3g}, label pixels differing {moved_px}")
        out.update({"export_moved_gn_launches": moved_launches,
                    "export_moved_float_err_vs_cpu": moved_err})

        marks = {"single f32 and bf16, tiny CPU artifact": time.perf_counter() - t_phase}
        # (b) one 1024x1024 slide (9 tiles of 512, two chunks), f32
        art = os.path.join(tmp, "tiled.pt2")
        t = time.perf_counter()
        export_infer(weights, art, use_ema=True, mode="tiled", slide_hw=(1024, 1024),
                     tile_size=512, compute_dtype="float32")
        tiled_export_s = time.perf_counter() - t
        cfg, model = serving_model(weights, use_ema=True, tile_size=512, compute_dtype="float32")
        slide = torch.from_numpy(mosaic(np, pixels[:4], 2)).cuda()
        want = to_np(build_tiled_infer_fn(model, cfg, (1024, 1024))(slide))
        gn.launches = 0
        got = to_np(load_serving(art)(slide))
        tiled_launches = gn.launches
        tiled_err = same_outputs(np, got, want, 1e-4)
        require(tiled_launches > 0 and int(want["valid"].sum()) > 0, "tiled artifact: no "
                "launch or no detection")
        del model
        torch.cuda.empty_cache()
        log(f"  (b) tiled artifact (1024x1024, 9 tiles of 512, f32): export "
            f"{tiled_export_s:.1f} s, equal to the live path (largest float diff "
            f"{tiled_err:.3g}), GroupNorm launches {tiled_launches}")
        out.update({"export_tiled_s": tiled_export_s, "export_tiled_gn_launches": tiled_launches,
                    "export_tiled_float_err": tiled_err})

        marks["tiled"] = time.perf_counter() - t_phase
        # (c) the CLIs' flags
        save = os.path.join(tmp, "vis")
        gn.launches = 0
        t = time.perf_counter()
        try:
            rc = test_cli.main(["--dataset", "folder", "--data_dir", images_dir,
                                "--weights", weights, "--use_ema", "--input_size", "512",
                                "--batch_size", "16", "--compute_dtype", "float32",
                                "--save_dir", save, "--save_vis", "--debug_nans"])
        finally:
            disable_nan_debugging()
        vis_s = time.perf_counter() - t
        vis_launches = gn.launches
        overlays = sorted(f for f in os.listdir(save) if f.endswith("_vis.png"))
        require(rc == 0 and len(overlays) == 16, f"cli.test --save_vis wrote {len(overlays)}")
        for k, i in enumerate(ids):
            require(np.array_equal(read_png(os.path.join(save, f"{i}_label.png"), "unchanged"),
                                   live_f32[k]), f"{i}: --debug_nans label map differs")
            vis = read_png(os.path.join(save, f"{i}_vis.png"), "color")
            require(vis.shape == (512, 512, 3), f"{i}: overlay {vis.shape}")
        prof = os.path.join(tmp, "prof")
        gauss.launches = 0
        t = time.perf_counter()
        try:
            train_cli.run(["--dataset", "synthetic", "--synthetic_n", "16", "--batch_size", "8",
                           "--num_epochs", "1", "--steps_per_epoch", "2", "--rss_limit_gb", "0",
                           "--save_dir", os.path.join(tmp, "train"), "--profile_dir", prof,
                           "--debug_nans"])
        finally:
            disable_nan_debugging()
        train_s = time.perf_counter() - t
        train_gauss = gauss.launches
        require(train_gauss == 2, f"2 train steps launched the Gaussian kernel {train_gauss} "
                "times")
        trace_bytes = os.path.getsize(os.path.join(prof, "trace.json"))
        with open(os.path.join(prof, "trace.json")) as f:
            n_events = len(json.load(f)["traceEvents"])
        require(n_events > 0, "the --profile_dir trace is empty")
        from kgtpu_torch import checkpoint
        state, extra = checkpoint.restore_bundle(weights, use_ema=True)
        name = next(k for k in state if k.endswith("weight") and state[k].dim() == 4)
        state = dict(state)
        state[name] = state[name].clone()
        state[name][0, 0, 0, 0] = float("nan")
        bad = checkpoint.write_payload(os.path.join(tmp, "nan"), 0, {"params": state}, extra)
        stopped = None
        try:
            test_cli.main(["--dataset", "folder", "--data_dir", images_dir, "--weights", bad,
                           "--batch_size", "16", "--save_dir", os.path.join(tmp, "nan_out"),
                           "--debug_nans"])
        except FloatingPointError as e:
            stopped = str(e)
        finally:
            disable_nan_debugging()
        require(stopped is not None, "a NaN weight under --debug_nans did not stop cli.test")
        log(f"  (c) cli.test --save_vis --debug_nans: 16 overlays, label maps equal to the live "
            f"f32 path, {vis_s:.1f} s, GroupNorm launches {vis_launches}; cli.train "
            f"--profile_dir --debug_nans: 2 steps in {train_s:.1f} s, trace {trace_bytes} bytes "
            f"({n_events} events); planted NaN ({name}[0,0,0,0]) stopped cli.test: {stopped}")
        marks["CLIs"] = time.perf_counter() - t_phase
        # (b) the TTA artifact, served against the live multi-scale builder
        cfg, model = serving_model(weights, use_ema=True, input_size=512,
                                   compute_dtype="float32", **tta_kw)
        div = required_divisor(cfg.model)
        stacks = {}
        for sc in cfg.infer.test_scales:
            dcfg = dataclasses.replace(cfg.data, input_size=max(round(512 * sc / div), 1) * div)
            stacks[f"{sc:g}"] = torch.from_numpy(np.stack(
                [prepare_sample({"image": im, "label_map": gt[i]}, dcfg)["image"]
                 for im, i in zip(pixels[:8], ids[:8])])).cuda()
        want = to_np(build_multiscale_fn(model, cfg)(stacks))
        try:
            rc = tta_proc.wait(timeout=max(EXPORT_PHASE_S - (time.perf_counter() - t_phase),
                                           1))
        except subprocess.TimeoutExpired:
            rc = None
        with open(tta_log) as f:
            require(rc == 0 and os.path.exists(tta_art),
                    f"the TTA export exited with {rc}: {f.read()[-3000:]}")
        tta_export_s = os.path.getmtime(tta_art) - tta_t0
        gn.launches = 0
        got = to_np(load_serving(tta_art)(stacks))
        tta_launches = gn.launches
        tta_err = same_outputs(np, got, want, 1e-4)
        require(tta_launches > 0 and int(want["valid"].sum()) > 0, "TTA artifact: no launch "
                "or no detection")
        del model
        torch.cuda.empty_cache()
        log(f"  (b) TTA artifact (3 scales + flip, batch 8, f32): the export CLI's process "
            f"wrote it {tta_export_s:.1f} s after its start, equal to the live path (largest "
            f"float diff {tta_err:.3g}), GroupNorm launches {tta_launches}")
        out.update({"export_tta_s": tta_export_s, "export_tta_gn_launches": tta_launches,
                    "export_tta_float_err": tta_err})
        # (a)'s timings, on a host no longer shared with the export process
        for dtype, (serve, live, batch) in timed.items():
            short = "f32" if dtype == "float32" else "bf16"
            art_ms = 1e3 * np.median(timed_repeats(torch, lambda: serve(batch), 5))
            live_ms = 1e3 * np.median(timed_repeats(torch, lambda: live(batch), 5))
            art_syncs, live_syncs = count_syncs(torch, lambda: serve(batch)), count_syncs(
                torch, lambda: live(batch))
            log(f"  (a) single {dtype}, timed after (c): artifact {art_ms:.2f} ms per batch of "
                f"16 against live {live_ms:.2f} ms (median of 5); host syncs per call "
                f"{art_syncs} (live {live_syncs}); {smi}")
            out.update({f"export_single_ms_b16_{short}": art_ms,
                        f"live_single_ms_b16_{short}": live_ms,
                        f"export_single_syncs_{short}": art_syncs,
                        f"live_single_syncs_{short}": live_syncs})
        del timed, serve, live, batch
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log("  phase [13] elapsed at the end of each part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in marks.items()) + f", TTA served and (a) timed "
        f"{phase_s:.1f} s")
    log(f"  phase [13]: {phase_s:.1f} s (budget {EXPORT_PHASE_S} s)")
    require(phase_s <= EXPORT_PHASE_S, f"phase [13] took {phase_s:.0f} s")
    return {**out, "vis_cli_s": vis_s, "vis_gn_launches": vis_launches,
            "profile_trace_bytes": trace_bytes, "debug_train_s": train_s,
            "debug_train_gauss_launches": train_gauss,
            "export_phase_s": phase_s}


def capture_config(norm: str):
    """[14]'s training Config: the default at full width (2-stack hourglass,
    128 channels, 512x512, batch 8), EMA 0.999, a 1-step warmup."""
    from kgtpu_torch.config import Config
    c = Config()
    return c.replace(model=dataclasses.replace(c.model, norm=norm),
                     train=dataclasses.replace(c.train, lr_warmup_steps=1, ema_decay=0.999))


def state_names(state) -> list:
    """Names of `train_lib._state_tensors(state)`, in its order."""
    names = [n for n, _ in state.model.named_parameters()]
    bufs = [f"buffer {n}" for n, _ in state.model.named_buffers()]
    return ([f"param {n}" for n in names] + [f"mu {n}" for n in names]
            + [f"nu {n}" for n in names] + bufs
            + ([f"ema {n}" for n in names] if state.ema is not None else []))


def held_to_yardstick(torch, names, got, ref, ref2) -> dict:
    """Each tensor of `got` against `ref`: |got - ref| <= 2 * max|ref - ref2|
    (the tensor's own yardstick: two eager runs of the same steps; cuDNN's
    and scatter's backward passes are not bitwise deterministic) + atol +
    rtol * |ref| (kgtpu's multi-step tolerance)."""
    over, rows, bitwise, bitwise_ref = [], [], True, True
    for name, g, a, b in zip(names, got, ref, ref2):
        g, a, b = g.detach().float(), a.detach().float(), b.detach().float()
        yard = float((a - b).abs().max()) if a.numel() else 0.0
        d = (g - a).abs()
        gap = float(d.max()) if d.numel() else 0.0
        if bool((d > 2 * yard + MULTI_ATOL + MULTI_RTOL * a.abs()).any()):
            over.append(name)
        bitwise &= torch.equal(g, a)
        bitwise_ref &= torch.equal(a, b)
        rows.append((gap, yard, name))
    rows.sort(reverse=True)
    return {"over": over, "bitwise_equal": bitwise, "eager_runs_bitwise_equal": bitwise_ref,
            "largest_gaps": [{"tensor": n, "gap": g, "yardstick": y} for g, y, n in rows[:5]]}


def capture_inputs(np, torch, cfg, hosts):
    """Device batches, their [8, ...] device stacks and the 8 steps' draws
    (step j's from its own generator)."""
    from kgtpu_torch import train_lib
    dev = torch.device("cuda")
    batches = [train_lib.batch_to_device(h, dev) for h in hosts]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    n = hosts[0]["valid"].shape[1]
    draws = [train_lib.step_draws(cfg, torch.Generator(device="cuda").manual_seed(1000 + j),
                                  cfg.train.batch_size, n, dev) for j in range(len(hosts))]
    sel = torch.stack([d[0] for d in draws])
    jit = torch.stack([d[1] for d in draws])
    return batches, stacked, draws, sel, jit


def capture_parity(np, torch, gauss, hosts, norm: str) -> dict:
    """[14](a): 8 eager steps twice (the yardstick), then 2 replays of k = 4
    from the same seeded state on the same batches and draws."""
    from kgtpu_torch import train_lib
    cfg = capture_config(norm)
    batches, _, draws, sel, jit = capture_inputs(np, torch, cfg, hosts)

    def eager():
        st = train_lib.create_train_state(cfg, seed=0)
        losses = [train_lib.train_step(st, b, *d, cfg)["loss"] for b, d in zip(batches, draws)]
        return st, torch.stack(losses)

    e1, l1 = eager()
    e2, l2 = eager()
    g = train_lib.create_train_state(cfg, seed=0)
    multi = train_lib.make_train_multi_step(cfg, CAPTURE_K)
    gauss.launches = 0                          # the captured steps' run
    outs = []
    for lo in range(0, CAPTURE_BATCHES, CAPTURE_K):
        group = hosts[lo:lo + CAPTURE_K]        # host NumPy, staged through pinned memory
        outs.append(multi(g, {k: np.stack([h[k] for h in group]) for k in group[0]},
                          sel[lo:lo + CAPTURE_K], jit[lo:lo + CAPTURE_K]))
    torch.cuda.synchronize()
    launches = gauss.launches
    lg = torch.cat([o["loss"] for o in outs])
    loss_gap = float(((lg - l1).abs() / l1.abs()).max())
    names = state_names(g)
    held = held_to_yardstick(torch, names, train_lib._state_tensors(g),
                             train_lib._state_tensors(e1), train_lib._state_tensors(e2))
    log(f"  norm={norm}: eager losses {[round(float(v), 5) for v in l1]}; captured "
        f"{[round(float(v), 5) for v in lg]}; largest relative loss gap {loss_gap:.3g} (rtol "
        f"{CAPTURE_LOSS_RTOL}); captured == eager bitwise: {held['bitwise_equal']}, the two "
        f"eager runs bitwise: {held['eager_runs_bitwise_equal']}; Gaussian launches of the "
        f"capture's warm-up and the 2 replays: {launches}")
    log("    largest gaps (captured vs eager, yardstick eager vs eager): " + "; ".join(
        f"{r['tensor']} {r['gap']:.3g} ({r['yardstick']:.3g})" for r in held["largest_gaps"]))
    # the capture's warm-up runs the k bodies once, eagerly
    require(launches == CAPTURE_BATCHES + CAPTURE_K, f"the capture and its replays counted "
            f"{launches} Gaussian launches, want {CAPTURE_BATCHES + CAPTURE_K}")
    require(loss_gap <= CAPTURE_LOSS_RTOL, f"norm={norm}: captured losses off by {loss_gap}")
    require(not held["over"], f"norm={norm}: {len(held['over'])} tensors beyond the bound, "
            f"e.g. {held['over'][:3]}")
    require(g.step == g.optimizer.count == CAPTURE_BATCHES, "the host counts did not advance by k")
    return {"loss_rel_gap": loss_gap, "gauss_launches": launches, **held}


def capture_timing(np, torch, hosts, cfg) -> dict:
    """[14](a): fixed-batch train img/s over rounds of 8 steps on
    device-resident batches: eager (k = 1) and one CUDA graph of k steps;
    median of TIMED_REPEATS rounds, the host's ms per step (the call's
    return, before the device finishes), the device's idle share of a
    round (torch.profiler) and the peak memory."""
    from kgtpu_torch import train_lib
    batches, stacked, draws, sel, jit = capture_inputs(np, torch, cfg, hosts)
    b = cfg.train.batch_size
    rows = {}
    for k in TIMED_KS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = train_lib.create_train_state(cfg, seed=0)
        if k == 1:
            def round_(st=st):
                for bt, d in zip(batches, draws):
                    train_lib.train_step(st, bt, *d, cfg)
        else:
            multi = train_lib.make_train_multi_step(cfg, k)

            def round_(st=st, multi=multi, k=k):
                for lo in range(0, CAPTURE_BATCHES, k):
                    multi(st, {n: v[lo:lo + k] for n, v in stacked.items()}, sel[lo:lo + k],
                          jit[lo:lo + k])
        round_()                                # the capture, for k > 1
        torch.cuda.synchronize()
        walls, host = [], []
        for _ in range(TIMED_REPEATS):
            t = time.perf_counter()
            round_()
            th = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            host.append(th - t)
        prof = profile_e2e(torch, round_, top=0)
        ips = sorted(b * CAPTURE_BATCHES / w for w in walls)
        rows[k] = {"img_per_s": ips[len(ips) // 2], "img_per_s_min": ips[0],
                   "img_per_s_max": ips[-1],
                   "host_ms_per_step": sorted(host)[len(host) // 2] / CAPTURE_BATCHES * 1e3,
                   "idle_share": prof["idle_share"], "device_busy_ms_per_step":
                   prof["device_busy_ms"] / CAPTURE_BATCHES,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  k={k} ({'eager' if k == 1 else 'CUDA graph'}): {rows[k]['img_per_s']:.2f} img/s "
            f"(min {ips[0]:.2f}, max {ips[-1]:.2f}; median of {TIMED_REPEATS} rounds of "
            f"{CAPTURE_BATCHES} steps at batch {b}), host {rows[k]['host_ms_per_step']:.2f} "
            f"ms/step, device busy {rows[k]['device_busy_ms_per_step']:.2f} ms/step, idle share "
            f"{prof['idle_share']:.3f}, peak {rows[k]['peak_mem_gb']:.2f} GB")
        del st, round_
        if k > 1:
            del multi
    return rows


def gaussian_in_graph(np, torch, gauss, hosts, cfg) -> dict:
    """[14](b) on k batches (`hosts`): a profiled replay holds k device
    records of the Gaussian kernel (an empty or short window is measured
    again, up to 5 windows), and the replay's first loss equals the loss
    with plain targets on the same state, batch and draws."""
    from torch.profiler import ProfilerActivity, profile

    from kgtpu_torch import train_lib
    from kgtpu_torch.ops.targets import render_heatmaps_batch
    batches, stacked, draws, sel, jit = capture_inputs(np, torch, cfg, hosts)
    st = train_lib.create_train_state(cfg, seed=0)
    multi = train_lib.make_train_multi_step(cfg, CAPTURE_K)
    k = CAPTURE_K
    gauss.launches = 0                          # this path's run

    def dispatch():                             # the k batches (`hosts`) as one dispatch
        return multi(st, stacked, sel, jit)

    dispatch()                                  # the capture and one replay
    with torch.no_grad():
        _, plain = train_lib.loss_fn(st.model, batches[0], *draws[0], cfg,
                                     render=render_heatmaps_batch)
    plain_loss = float(plain["loss"])
    torch.cuda.synchronize()
    counts, loss_gap = [], None
    for window in range(5):
        before = gauss.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = dispatch()                    # the same batches, from the moved state
            torch.cuda.synchronize()
        require(gauss.launches - before == k, f"a replay counted {gauss.launches - before} "
                f"Gaussian launches, want {k}")
        if loss_gap is None:
            loss_gap = abs(float(out["loss"][0]) - plain_loss) / abs(plain_loss)
        device = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU]
        count = sum(e.count for e in device if "render_kernel" in e.key)
        counts.append((count, sum(e.count for e in device)))
        if count == k:
            break
        log(f"  profiler window {window}: {count} Gaussian kernel records of {k}, "
            f"{counts[-1][1]} device records of any kind; measuring again")
    blind = all(c[1] == 0 for c in counts)
    log(f"  profiled replay: {counts[-1][0]} Gaussian kernel records for k={k} (windows: "
        f"{counts}); replay loss vs plain targets: relative gap {loss_gap:.3g} (rtol "
        f"{TRAIN_LOSS_RTOL})")
    require(counts[-1][0] == k or blind, f"no profiled replay held {k} Gaussian records")
    if blind:
        PROFILER_BLIND.append({"kernels": ["render_kernel"], "graph_replay": True})
    require(loss_gap <= TRAIN_LOSS_RTOL, "the replay's loss differs from the plain targets'")
    return {"gauss_records_per_replay": counts[-1][0], "profiler_windows": counts,
            "replay_loss_vs_plain_rel_gap": loss_gap, "gauss_launches": gauss.launches,
            "profiler_blind": blind}


def gaussian_in_graph_fresh() -> dict:
    """[14](b) in a fresh process (this script with GRAPH_PROFILE_FLAG):
    after the earlier phases' profiled calls, this process's torch.profiler
    keeps too few device records (ROADMAP's "profiler drops records"), here
    of a replay's kernels too (one H100 80GB HBM3 run: 3 of 4 Gaussian
    records, and 42 of 10,295 records of any kind missing, in each of five
    windows).
    Its log lines are printed here; its last line is its stats."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), GRAPH_PROFILE_FLAG],
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    require(r.returncode == 0 and lines, f"[14](b) exited with {r.returncode}: "
            f"{r.stderr[-3000:]}")
    return json.loads(lines[-1])


def graph_profile_main() -> int:
    """GRAPH_PROFILE_FLAG: [14](b) alone, its stats as the last line."""
    import numpy as np
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from kgtpu_torch.ops import gaussian as gauss
    cfg = capture_config("group")
    hosts = [train_batch(np, cfg, cfg.train.batch_size, seed=20 + j) for j in range(CAPTURE_K)]
    stats = gaussian_in_graph(np, torch, gauss, hosts, cfg)
    print(json.dumps(stats), flush=True)
    return 0


def payload_tensors(torch, path: str) -> dict:
    """The tensors of a checkpoint, by name."""
    from kgtpu_torch import checkpoint
    payload = checkpoint.restore(path)
    out = {}
    for sec in ("params", "ema"):
        out.update({f"{sec} {n}": t for n, t in payload.get(sec, {}).items()})
    for sec in ("mu", "nu"):
        out.update({f"{sec} {n}": t for n, t in payload["opt"][sec].items()})
    return out


def capture_cli(np, torch, gauss) -> dict:
    """[14](c): cli.train at k = CAPTURE_CLI_K and at k = 1 (twice, the
    yardstick), one epoch of CAPTURE_CLI_STEPS steps then one more with
    --resume; metrics and checkpoint tensors held to (a)'s bound."""
    from kgtpu_torch.cli import train as train_cli
    from kgtpu_torch.config import config_to_json
    threads = torch.get_num_threads()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            f.write(config_to_json(capture_config("group")))
        for name, k in (("k1", 1), (f"k{CAPTURE_CLI_K}", CAPTURE_CLI_K), ("k1 again", 1)):
            save = os.path.join(tmp, name.replace(" ", "_"))
            flags = CAPTURE_CLI_FLAGS + ["--config", cfg_path, "--save_dir", save,
                                         "--steps_per_epoch", str(CAPTURE_CLI_STEPS),
                                         "--steps_per_dispatch", str(k)]
            gauss.launches = 0                  # this CLI run's path
            first = train_cli.run(flags + ["--num_epochs", "1"])
            second = train_cli.run(flags + ["--num_epochs", "2", "--resume"])
            torch.cuda.synchronize()
            torch.set_num_threads(threads)
            with open(os.path.join(save, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            epochs = first["epochs"] + second["epochs"]
            runs[name] = {"launches": gauss.launches, "rows": rows, "start": second["start_step"],
                          "end": second["end_step"],
                          "tensors": {e: payload_tensors(torch, os.path.join(save, f"model_{e}"))
                                      for e in (0, 1)},
                          "img_per_s": 8 * sum(e["steps"] for e in epochs)
                          / sum(e["train_s"] for e in epochs),
                          "wait_ms_per_step": sum(e["wait_s"] for e in epochs)
                          / sum(e["steps"] for e in epochs) * 1e3}
            r = runs[name]
            log(f"  cli.train --steps_per_dispatch {k}: {r['img_per_s']:.2f} img/s, "
                f"{r['wait_ms_per_step']:.1f} ms/step waiting for batches; resumed at step "
                f"{r['start']}, ended at {r['end']}; Gaussian launches {r['launches']}; "
                f"losses {[row['loss'] for row in rows]}")
            # each of the two runs captures once, after a warm-up of k steps
            warm = 2 * k if k > 1 else 0
            require(r["launches"] == 2 * CAPTURE_CLI_STEPS + warm
                    and r["start"] == CAPTURE_CLI_STEPS
                    and r["end"] == 2 * CAPTURE_CLI_STEPS and len(rows) == 2,
                    f"cli.train --steps_per_dispatch {k}: launches, steps or epochs off")
    a, b, a2 = runs["k1"], runs[f"k{CAPTURE_CLI_K}"], runs["k1 again"]
    for key in ("loss", "loss_hm", "loss_off", "loss_mask", "grad_norm"):
        for ra, rb, ra2 in zip(a["rows"], b["rows"], a2["rows"]):
            bound = 2 * abs(ra[key] - ra2[key]) + CAPTURE_LOSS_RTOL * abs(ra[key]) + 1e-6
            require(abs(rb[key] - ra[key]) <= bound, f"metrics.jsonl {key} epoch "
                    f"{ra['epoch']}: k={CAPTURE_CLI_K} {rb[key]} vs k=1 {ra[key]} (bound {bound})")
    held = {}
    for e in (0, 1):
        names = sorted(a["tensors"][e])
        held[e] = held_to_yardstick(torch, names, [b["tensors"][e][n] for n in names],
                                    [a["tensors"][e][n] for n in names],
                                    [a2["tensors"][e][n] for n in names])
        log(f"  checkpoint model_{e}: k={CAPTURE_CLI_K} == k=1 bitwise {held[e]['bitwise_equal']};"
            f" largest gaps " + "; ".join(f"{r['tensor']} {r['gap']:.3g} ({r['yardstick']:.3g})"
                                          for r in held[e]["largest_gaps"][:3]))
        require(not held[e]["over"], f"model_{e}: {held[e]['over'][:3]} beyond the bound")
    return {"cli_img_per_s": {n: r["img_per_s"] for n, r in runs.items()},
            "cli_wait_ms_per_step": {n: r["wait_ms_per_step"] for n, r in runs.items()},
            "cli_gauss_launches_k4": b["launches"],
            "cli_checkpoint_bitwise": {e: held[e]["bitwise_equal"] for e in held}}


def dp_on_card(np, torch, gn, gauss) -> dict:
    """[14](d): cli.train through --coordinator (NCCL, one rank) at k = 1 and
    k = 2 against the run without a process group; data-parallel serving
    over every visible card against the unsharded call."""
    from kgtpu_torch import infer
    from kgtpu_torch.cli import train as train_cli
    from kgtpu_torch.config import Config, config_to_json
    from kgtpu_torch.models import build_model
    from kgtpu_torch.parallel import launch, make_mesh
    threads = torch.get_num_threads()
    cards = torch.cuda.device_count()
    log(f"  visible cards: {cards}. This machine has one H100, so no run here checks more "
        f"than one rank on the card (the CPU tests run two gloo ranks).")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            f.write(config_to_json(capture_config("group")))
        for name, k, dp in (("plain", 1, False), ("nccl k=1", 1, True), ("nccl k=2", 2, True)):
            save = os.path.join(tmp, name.replace(" ", "_").replace("=", ""))
            flags = CAPTURE_CLI_FLAGS + ["--config", cfg_path, "--save_dir", save,
                                         "--steps_per_epoch", str(DP_STEPS), "--num_epochs", "1",
                                         "--steps_per_dispatch", str(k)]
            if dp:
                flags += ["--coordinator", f"localhost:{launch.free_port()}", "--num_hosts", "1",
                          "--host_id", "0"]
            gauss.launches = 0                  # this run's path
            summary = train_cli.run(flags)
            torch.cuda.synchronize()
            torch.set_num_threads(threads)
            with open(os.path.join(save, "metrics.jsonl")) as f:
                row = json.loads(f.readline())
            runs[name] = {"row": row, "launches": gauss.launches,
                          "all_reduces": summary.get("all_reduces", 0)}
            log(f"  {name}: loss {row['loss']}, Gaussian launches {gauss.launches}, all-reduces "
                f"issued by the host {runs[name]['all_reduces']}")
            warm = k if k > 1 else 0           # the capture's warm-up
            require(gauss.launches == DP_STEPS + warm,
                    f"{name}: {gauss.launches} Gaussian launches")
    plain = runs["plain"]["row"]
    for name in ("nccl k=1", "nccl k=2"):
        row = runs[name]["row"]
        for key in ("loss", "loss_hm", "loss_off", "loss_mask"):
            gap = abs(row[key] - plain[key]) / abs(plain[key])
            require(gap <= CAPTURE_LOSS_RTOL, f"{name} {key} {row[key]} vs {plain[key]}")
    per_step = runs["nccl k=1"]["all_reduces"] / DP_STEPS
    log(f"  all-reduces per step: {per_step:g} (a num_pos sum per stack, the metrics' sum, one "
        f"flat gradient all-reduce); with k=2 the host issued "
        f"{runs['nccl k=2']['all_reduces']} (the warm-up's and the capture's, and the tail's "
        f"step), the replays re-run the captured ones")

    cfg = Config()
    model = build_model(cfg.model, seed=0, device="cuda")
    imgs = np.random.default_rng(5).integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    devices = make_mesh(0, "cuda")
    gn.launches = 0                             # the data-parallel serving path
    got = infer.build_infer_fn(model, cfg, devices=devices)(imgs)
    torch.cuda.synchronize()
    gn_launches = gn.launches
    want = infer.build_infer_fn(model, cfg)(imgs)
    same = all(torch.equal(got[k], want[k]) for k in ("label_map", "valid", "boxes", "scores"))
    log(f"  build_infer_fn(devices={[str(d) for d in devices]}) on a batch of 8: label maps, "
        f"boxes, scores and validity equal to the unsharded call: {same}; GroupNorm launches "
        f"{gn_launches}")
    require(same and gn_launches >= GN_PER_FORWARD, "data-parallel serving differs")
    return {"visible_cards": cards, "dp_losses": {n: r["row"]["loss"] for n, r in runs.items()},
            "dp_all_reduces_per_step": per_step, "dp_gauss_launches": {
                n: r["launches"] for n, r in runs.items()}, "dp_serving_gn_launches": gn_launches}


def phase_capture(np, torch, gn, gauss) -> dict:
    """[14]: captured multi-step training and data parallelism."""
    t_phase = time.perf_counter()
    cfg = capture_config("group")
    hosts = [train_batch(np, cfg, cfg.train.batch_size, seed=20 + j)
             for j in range(CAPTURE_BATCHES)]
    log("  (a) 8 eager steps (twice) against 2 replays of k=4, GroupNorm and BatchNorm")
    parity = {norm: capture_parity(np, torch, gauss, hosts, norm) for norm in ("group", "batch")}
    torch.cuda.empty_cache()
    timing = capture_timing(np, torch, hosts, cfg)
    log("  (b) the Gaussian kernel inside the graph (a fresh process)")
    torch.cuda.empty_cache()
    graph = gaussian_in_graph_fresh()
    log(f"  (c) cli.train --steps_per_dispatch {CAPTURE_CLI_K} against 1")
    torch.cuda.empty_cache()
    cli = capture_cli(np, torch, gauss)
    log("  (d) data parallelism on the card")
    torch.cuda.empty_cache()
    dp = dp_on_card(np, torch, gn, gauss)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase [14]: {phase_s:.1f} s (budget {CAPTURE_PHASE_S} s)")
    require(phase_s <= CAPTURE_PHASE_S, f"phase [14] took {phase_s:.0f} s")
    return {"capture_parity": parity, "capture_timing": timing, "capture_graph": graph,
            "capture_cli": cli, "capture_dp": dp, "capture_phase_s": phase_s}


def _read_or_refuse(path: str, mode: str):
    """read_image, or the UnreadableImage it raises (a pool worker's job)."""
    from kgtpu_torch.data.imread import UnreadableImage, read_image
    try:
        return read_image(path, mode)
    except UnreadableImage as e:
        return e


def _timed_reads(path: str, mode: str, reads: int, clock_filters: bool):
    """A pool worker's job: ([(ms, {AV1 filter group: ms} or None), ...],
    shape) of `reads` reads of one file, or of one where it takes over
    SLOW_DECODE_MS (the groups: `av1_filter_clock`)."""
    from kgtpu_torch.data.imread import read_image
    filters_ms = av1_filter_clock() if clock_filters else None
    out = []
    try:
        while len(out) < reads and not (out and out[0][0] > SLOW_DECODE_MS):
            if filters_ms is not None:
                for v in filters_ms.values():
                    v.clear()
            t = time.perf_counter()
            img = read_image(path, mode)
            out.append(((time.perf_counter() - t) * 1e3, None if filters_ms is None else
                        {k: sum(v) for k, v in filters_ms.items()}))
    finally:
        if filters_ms is not None:
            av1_filter_clock(stop=True)
    return out, img.shape


_POOL: list = []


def decode_pool():
    """The one process pool (DECODE_WORKERS spawned processes) of the decode
    checks of [15]-[18]; main shuts it down."""
    if not _POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL.append(ProcessPoolExecutor(DECODE_WORKERS,
                                         mp_context=multiprocessing.get_context("spawn")))
    return _POOL[0]


def folder_decodes(np, smi: str, key: str, folder: str, stem: str, reads: int = 3) -> dict:
    """[15] / [16] / [17] (a), [17] (c), (d), [18]: every fixture of a folder
    in every mode against cv2's hash (`<key>_decode_json`; UnreadableImage
    where cv2 returns None), in the shared decode pool; then the decode time
    of each kind (`_timed_reads`: median of `reads` reads, 1 read for a
    decoder over SLOW_DECODE_MS; a kind that several files share is timed
    on its first), every kind at once in the pool, one a process."""
    from kgtpu_torch.data.imread import UnreadableImage
    from tools.make_torch_format_assets import sha
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_formats.npz"))
    decodes = json.loads(str(ref[f"{key}_decode_json"]))
    kinds = json.loads(str(ref[f"{key}_kinds_json"]))
    t = time.perf_counter()
    bad, refused = [], 0
    jobs = [(os.path.join(folder, d["path"]), d["mode"]) for d in decodes]
    results = list(decode_pool().map(_read_or_refuse, *zip(*jobs)))
    for d, got in zip(decodes, results):
        if isinstance(got, UnreadableImage):
            if d["sha256"] is None:
                refused += 1
            else:
                bad.append((d["path"], d["mode"], f"UnreadableImage where cv2 reads: {got}"))
            continue
        if d["sha256"] is None:
            bad.append((d["path"], d["mode"], "read where cv2 returns None"))
        elif (sha(got), list(got.shape), str(got.dtype)) != (d["sha256"], d["shape"],
                                                              d["dtype"]):
            bad.append((d["path"], d["mode"], list(got.shape)))
    check_s = time.perf_counter() - t
    log(f"  {len(decodes) - len(bad)}/{len(decodes)} {stem} decodes equal cv2's (sha256, "
        f"shape, dtype; {refused} of them UnreadableImage where cv2 returns None) in "
        f"{check_s:.1f} s ({DECODE_WORKERS} processes)")
    require(not bad, f"{stem} decodes off cv2's: {bad[:5]}")
    first = {}                 # kind -> its first file, in the first mode cv2 reads
    for f, kind in sorted(kinds.items(), key=lambda kv: kv[1]):
        mode = next((d["mode"] for d in decodes if d["path"] == f and d["sha256"]), None)
        if mode is not None and kind not in first:
            first[kind] = (f, mode)
    n = len(first)
    runs = decode_pool().map(_timed_reads, [os.path.join(folder, f) for f, _ in first.values()],
                             [m for _, m in first.values()], [reads] * n,
                             [stem.startswith("avif")] * n)
    timed = {}
    for (kind, (f, mode)), (times, shape) in zip(first.items(), runs):
        ms, spent = sorted(times, key=lambda r: r[0])[len(times) // 2]
        pixels = shape[0] * shape[1]
        timed[kind] = {"ms_per_image": ms, "reads": len(times), "pixels": pixels, "mode": mode,
                       "ms_per_512x512": ms * 512 * 512 / pixels,
                       "bytes": os.path.getsize(os.path.join(folder, f))}
        share = ""
        if spent is not None:
            timed[kind]["av1_filters_ms"] = spent["deblocking + CDEF"]
            timed[kind]["av1_superres_lr_ms"] = spent["superres + loop restoration"]
            share = "".join(f", AV1 {k} {v:.1f} ms ({v / ms:.3f} of it)"
                            for k, v in spent.items() if v)
        log(f"  decode {kind} ({mode}): {ms:.1f} ms per {shape[0]}x{shape[1]} image (median "
            f"of {len(times)} read(s)), {timed[kind]['ms_per_512x512']:.1f} ms per 512x512 of "
            f"pixels, {timed[kind]['bytes']} bytes{share}; {smi}")
    return {f"{stem}_decode_checks": len(decodes), f"{stem}_decode_refused": refused,
            f"{stem}_decode_check_s": check_s, f"{stem}_decode_ms": timed}


def av1_filter_clock(stop: bool = False):
    """Host ms spent in the AV1 decoder's post-filters, by group ({"deblocking
    + CDEF": [...], "superres + loop restoration": [...]}, each call
    appending to its group's list), by wrapping `av1_decode`'s four filters
    in this process (a pool worker); `stop` puts them back."""
    from kgtpu_torch.data import av1_decode
    names = ("deblock", "cdef", "upscale", "restore")
    if stop:
        for name, fn in zip(names, _AV1_FILTERS.pop()):
            setattr(av1_decode, name, fn)
        return None
    spent: dict = {"deblocking + CDEF": [], "superres + loop restoration": []}

    def clocked(fn, group):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                group.append((time.perf_counter() - t) * 1e3)
        return run
    _AV1_FILTERS.append(tuple(getattr(av1_decode, name) for name in names))
    groups = ("deblocking + CDEF",) * 2 + ("superres + loop restoration",) * 2
    for name, group in zip(names, groups):
        setattr(av1_decode, name, clocked(getattr(av1_decode, name), spent[group]))
    return spent


_AV1_FILTERS: list = []


def folder_serving(np, torch, gn, gauss, xstats: dict, key: str, folder: str) -> dict:
    """[15] / [16] / [17] / [18] (b): the flagship over a folder (f32, bf16;
    cli.test --decode_workers DECODE_WORKERS) against kgtpu's run on the
    same files (`labels_<key>_<dtype>`, ...), with [8]'s gates."""
    from kgtpu_torch.data.png import read_png
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_formats.npz"))
    ref_metrics = json.loads(str(ref[f"{key}_metrics_json"]))
    ids = [str(i) for i in ref[f"{key}_ids"]]
    gt = {i: read_png(os.path.join(ASSETS, "synthetic_hard", "labels", f"{i}.png"),
                      "unchanged").astype(np.int32) for i in ids}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            short = "f32" if dtype == "float32" else "bf16"
            r = folder_vs_kgtpu(np, torch, gn, gauss, folder, ids, gt,
                                ref[f"labels_{key}_{dtype}"],
                                ref[f"counts_{key}_{dtype}"], ref_metrics[dtype], dtype,
                                os.path.join(tmp, dtype), decode_workers=DECODE_WORKERS)
            jpeg = xstats[f"jpeg_cli_img_per_s_{short}"]
            log(f"  {key} folder {dtype}: mAP_dsb2018 {r['mAP_dsb2018']:.6f} (kgtpu "
                f"{ref_metrics[dtype]['mAP_dsb2018']:.6f}, diff {r['dmap']:+.6f}, tol "
                f"{MAP_TOL[dtype]}); instances {r['counts']}, largest count diff "
                f"{r['count_diff_max']}, label-map pixels off kgtpu's: max {max(r['off'])}, "
                f"equal {r['off'].count(0)}/{len(ids)}; GroupNorm launches {r['launches']}; "
                f"CLI {len(ids) / r['wall']:.2f} img/s ({r['wall']:.2f} s; the JPEG folder of "
                f"[12]: {jpeg:.2f} img/s)")
            r.require(key)
            if key == "avif_folder" and dtype == "float32":
                # AV1's decoding and filters are exact, so the served images are
                # cv2's, and the f32 flagship scores them as kgtpu does
                require(r["dmap"] == 0, f"{key} f32 mAP_dsb2018 {r['mAP_dsb2018']} is not "
                        f"kgtpu's {ref_metrics[dtype]['mAP_dsb2018']}")
            out.update({f"{key}_mAP_dsb2018_{short}": r["mAP_dsb2018"],
                        f"{key}_mAP_diff_{short}": r["dmap"],
                        f"{key}_count_diff_max_{short}": r["count_diff_max"],
                        f"{key}_pixels_off_max_{short}": max(r["off"]),
                        f"{key}_cli_img_per_s_{short}": len(ids) / r["wall"],
                        f"{key}_gn_launches_{short}": r["launches"]})
    return out


def phase_folder(np, torch, gn, gauss, smi: str, xstats: dict, phase: str, key: str,
                 folder: str, stem: str, budget_s: int) -> dict:
    """[15] / [16] / [17] / [18]: (a) and (b) of the module docstring over
    one folder."""
    t_phase = time.perf_counter()
    out = folder_decodes(np, smi, key, folder, stem)
    out.update(folder_serving(np, torch, gn, gauss, xstats, key, folder))
    phase_s = time.perf_counter() - t_phase
    log(f"  phase [{phase}]: {phase_s:.1f} s (budget {budget_s} s)")
    require(phase_s <= budget_s, f"phase [{phase}] took {phase_s:.0f} s")
    out[f"{key}_phase_s"] = phase_s
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if GRAPH_PROFILE_FLAG in sys.argv[1:]:
        return graph_profile_main()
    if KERNEL_PROFILE_FLAG in sys.argv[1:]:
        return kernel_profile_main()
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
    cstats = phase_train_cli(np, torch, gn, gauss, smi)

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

    # 13. the serving export, and the debugging and profiling flags
    log("[13] the flagship exported (kgtpu_torch.export) and served from the reloaded "
        "artifact (single f32 and bf16, TTA, tiled) against the live path and kgtpu's "
        "reference; cli.test --save_vis --debug_nans, cli.train --profile_dir --debug_nans, "
        "a planted NaN")
    torch.cuda.empty_cache()
    estats = phase_export(np, torch, gn, gauss, smi)

    # 14. captured multi-step training and data parallelism
    log("[14] captured multi-step training (k steps in one CUDA graph) against eager steps, the "
        "Gaussian kernel inside the graph, cli.train --steps_per_dispatch, and data "
        "parallelism through NCCL on the card")
    torch.cuda.empty_cache()
    capstats = phase_capture(np, torch, gn, gauss)

    # 15. the image-format variants cv2 reads
    log("[15] format variants: every variant fixture decoded as cv2 decodes it and timed, the "
        "flagship over formats/variants (f32, bf16) against kgtpu's run on them")
    torch.cuda.empty_cache()
    vstats = phase_folder(np, torch, gn, gauss, smi, xstats, "15", "variants", VARIANTS_DIR,
                          "variant", VARIANTS_PHASE_S)
    log("[15] damaged files and the variants ported since: formats/variants2 decoded as cv2 "
        "decodes it, timed and served (f32, bf16) against kgtpu's run on them; "
        "formats/variants2_extra decoded and timed")
    t = time.perf_counter()
    vstats.update(phase_folder(np, torch, gn, gauss, smi, xstats, "15", "variants2",
                               VARIANTS2_DIR, "variant2", VARIANTS2_PHASE_S))
    vstats.update(folder_decodes(np, smi, "variants2_extra", VARIANTS2_EXTRA_DIR,
                                 "variant2_extra"))
    vstats["variants2_all_s"] = time.perf_counter() - t
    require(vstats["variants2_all_s"] <= VARIANTS2_PHASE_S,
            f"[15] variants2 took {vstats['variants2_all_s']:.0f} s")

    # 16. the image containers cv2 sniffs under kgtpu's file names
    log("[16] image containers: every container fixture (PNM / PAM, Sun raster, Radiance HDR, "
        "GIF, WebP under .png / .jpg / .tif / .bmp names) decoded as cv2 decodes it and "
        "timed, the flagship over formats/containers (f32, bf16) against kgtpu's run on them")
    torch.cuda.empty_cache()
    ctstats = phase_folder(np, torch, gn, gauss, smi, xstats, "16", "containers",
                           CONTAINERS_DIR, "container", CONTAINERS_PHASE_S)

    # 17. JPEG 2000 under kgtpu's file names
    log("[17] JPEG 2000: every JPEG 2000 fixture (JP2 and raw codestreams under .png / .jpg / "
        ".tif / .bmp names) decoded as cv2 decodes it and timed, the flagship over "
        "formats/jpeg2000 (f32, bf16) against kgtpu's run on them")
    torch.cuda.empty_cache()
    j2stats = phase_folder(np, torch, gn, gauss, smi, xstats, "17", "jpeg2000", JPEG2000_DIR,
                           "jpeg2000", JPEG2000_PHASE_S)
    log("[17] (c) JPEG 2000 code-block styles: formats/jpeg2000_styles decoded as cv2 decodes "
        "it, each kind timed once")
    t = time.perf_counter()
    j2stats.update(folder_decodes(np, smi, "jpeg2000_styles", JPEG2000_STYLES_DIR,
                                  "jpeg2000_styles", reads=1))
    j2stats["jpeg2000_styles_s"] = time.perf_counter() - t
    log(f"  [17] (c): {j2stats['jpeg2000_styles_s']:.1f} s (budget {JPEG2000_STYLES_S} s)")
    require(j2stats["jpeg2000_styles_s"] <= JPEG2000_STYLES_S,
            f"[17] (c) took {j2stats['jpeg2000_styles_s']:.0f} s")
    log("[17] (d) JPEG 2000 HT code-blocks and Part 2 markers: formats/jpeg2000_ht decoded as "
        "cv2 decodes it, each kind timed once")
    t = time.perf_counter()
    j2stats.update(folder_decodes(np, smi, "jpeg2000_ht", JPEG2000_HT_DIR, "jpeg2000_ht",
                                  reads=1))
    j2stats["jpeg2000_ht_s"] = time.perf_counter() - t
    log(f"  [17] (d): {j2stats['jpeg2000_ht_s']:.1f} s (budget {JPEG2000_HT_S} s)")
    require(j2stats["jpeg2000_ht_s"] <= JPEG2000_HT_S,
            f"[17] (d) took {j2stats['jpeg2000_ht_s']:.0f} s")

    # 18. AVIF
    log("[18] (a) AVIF: formats/avif (128x128 cuts: cv2's lossless RGB, grey, RGBA, 10 and 12 "
        "bits; lossy 4:2:0 / 4:2:2 / 4:4:4 / monochrome without in-loop filters, quantiser "
        "matrices, palettes, intra block copy, tiles, 128x128 superblocks, a grid, a "
        "sequence; with deblocking and CDEF: cv2's quality 90 / 80 and 10-bit, PIL's "
        "default and 4:2:2, delta loop filter levels, 128x128 superblocks; with loop "
        "restoration and superres: libaom's good quality at 4:2:0 / 4:4:4, 128x128 "
        "superblocks, 2x2 tiles, 10 bits, superres 12 / 16) decoded as cv2 decodes it, each "
        "kind timed once")
    t = time.perf_counter()
    avstats = folder_decodes(np, smi, "avif", AVIF_DIR, "avif", reads=1)
    avstats["avif_decode_s"] = time.perf_counter() - t
    log(f"  [18] (a): {avstats['avif_decode_s']:.1f} s (budget {AVIF_DECODE_S} s)")
    require(avstats["avif_decode_s"] <= AVIF_DECODE_S,
            f"[18] (a) took {avstats['avif_decode_s']:.0f} s")
    log("[18] (b) AVIF served: formats/avif_folder (512x512 AVIF under .png / .jpg / .tif / "
        ".bmp names: cv2's lossless and quality 80, PIL's lossy without in-loop filters and "
        "at its default, libaom's good quality with loop restoration) decoded as cv2 decodes "
        "it and timed once per kind, the flagship over it (f32, bf16) against kgtpu's run on "
        "cv2's reads")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    avstats.update(folder_decodes(np, smi, "avif_folder", AVIF_FOLDER_DIR, "avif_folder",
                                  reads=1))
    avstats.update(folder_serving(np, torch, gn, gauss, xstats, "avif_folder",
                                  AVIF_FOLDER_DIR))
    avstats["avif_serve_s"] = time.perf_counter() - t
    log(f"  [18] (b): {avstats['avif_serve_s']:.1f} s (budget {AVIF_SERVE_S} s)")
    require(avstats["avif_serve_s"] <= AVIF_SERVE_S,
            f"[18] (b) took {avstats['avif_serve_s']:.0f} s")
    decode_pool().shutdown()

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
               **tstats, **fstats, **cstats, **ttastats, **bstats, **xstats, **estats,
               **capstats, **vstats, **ctstats, **j2stats, **avstats,
               "device_ms_from_cuda_events": PROFILER_BLIND, "card": smi}
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
                                    "mixed folder [12]": xstats["mixed_gn_launches"],
                                    "single artifact f32 [13]": estats["export_single_gn_launches_f32"],
                                    "single artifact bf16 [13]":
                                        estats["export_single_gn_launches_bf16"],
                                    "TTA artifact [13]": estats["export_tta_gn_launches"],
                                    "tiled artifact [13]": estats["export_tiled_gn_launches"],
                                    "cli.test --save_vis --debug_nans [13]":
                                        estats["vis_gn_launches"],
                                    "data-parallel serving [14](d)":
                                        capstats["capture_dp"]["dp_serving_gn_launches"],
                                    "variants folder f32 [15]": vstats["variants_gn_launches_f32"],
                                    "variants folder bf16 [15]":
                                        vstats["variants_gn_launches_bf16"],
                                    "variants2 folder f32 [15]":
                                        vstats["variants2_gn_launches_f32"],
                                    "variants2 folder bf16 [15]":
                                        vstats["variants2_gn_launches_bf16"],
                                    "containers folder f32 [16]":
                                        ctstats["containers_gn_launches_f32"],
                                    "containers folder bf16 [16]":
                                        ctstats["containers_gn_launches_bf16"],
                                    "jpeg2000 folder f32 [17]":
                                        j2stats["jpeg2000_gn_launches_f32"],
                                    "jpeg2000 folder bf16 [17]":
                                        j2stats["jpeg2000_gn_launches_bf16"],
                                    "AVIF folder f32 [18]":
                                        avstats["avif_folder_gn_launches_f32"],
                                    "AVIF folder bf16 [18]":
                                        avstats["avif_folder_gn_launches_bf16"]},
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
                                        for name in TRAIN_FORMAT_STEPS},
                                     "train --profile_dir --debug_nans [13]":
                                         estats["debug_train_gauss_launches"],
                                     **{f"2 replays of k=4, norm={n} [14](a)":
                                        v["gauss_launches"]
                                        for n, v in capstats["capture_parity"].items()},
                                     "capture and profiled replays, fresh process [14](b)":
                                         capstats["capture_graph"]["gauss_launches"],
                                     "device records in one profiled replay [14](b)":
                                         capstats["capture_graph"]["gauss_records_per_replay"],
                                     "cli.train --steps_per_dispatch 4 [14](c)":
                                         capstats["capture_cli"]["cli_gauss_launches_k4"],
                                     **{f"cli.train {n} [14](d)": v for n, v in
                                        capstats["capture_dp"]["dp_gauss_launches"].items()}},
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
