#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (kgtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the GroupNorm(+ReLU) kernel from kgtpu_torch/csrc with nvcc, holds it
against its plain PyTorch version at every shape the main path gives it,
serves the default Config at full width (2-stack hourglass, 128 channels,
512x512, seeded random weights) through `build_infer_fn` and `Predictor`,
checks that the kernel served the backbone and the mask head, compares the
whole path against the plain GroupNorm, and times the kernel and the
end-to-end path (and its stages; `--profile` adds a torch.profiler table
of the e2e call's kernels and the device's idle share).  Exits non-zero without a result line when CUDA is missing
or any check fails.  Builds into kgtpu_torch/_build/ and writes nothing else.

The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.  TF32 is off for every phase (cuDNN and matmul), so
f32 comparisons are full f32; the model itself computes in bf16.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

WATCHDOG_S = 900            # the run's limit is 1200 s
TOL = {"bfloat16": 0.05, "float32": 2e-4}   # tests/test_pallas.py's tolerances
LABEL_AGREEMENT_FLOOR = 0.98
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PINNED_DETS = 24
E2E_BATCH = 32
# GroupNorm shapes of the main path at 512x512, NCHW (B = 8; the mask head
# sees batch x mask_chunk crops)
GN_SHAPES = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 128, 64, 64),
             (8, 128, 32, 32), (8, 128, 16, 16), (8, 128, 8, 8),
             (8 * 32, 64, 32, 32)]
TIMED_SHAPE = (32, 128, 128, 128)


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


def phase_kernel_vs_plain(torch, gn) -> dict:
    """Kernel vs plain at every main-path shape, relu on/off, bf16 and f32;
    then kernel, plain and library times at TIMED_SHAPE."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for shape in GN_SHAPES:
        c = shape[1]
        groups = gn.num_groups(c)
        w = torch.randn(c, device="cuda", generator=g) * 0.2 + 1.0
        b = torch.randn(c, device="cuda", generator=g) * 0.5
        xf = (torch.randn(shape, device="cuda", generator=g) * 3.0 + 2.0).contiguous(
            memory_format=torch.channels_last)
        for dtype in ("bfloat16", "float32"):
            x = xf.to(getattr(torch, dtype))
            for relu in (False, True):
                got = gn.group_norm_relu(x, w, b, groups, relu)
                want = gn.group_norm_relu_reference(x, w, b, groups, relu)
                torch.cuda.synchronize()
                require(got.dtype == x.dtype and got.shape == x.shape, "kernel output dtype/shape")
                require(got.is_contiguous(memory_format=torch.channels_last),
                        "kernel output is not channels_last")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                excess = float((diff - TOL[dtype] * (1 + want.float().abs())).max())
                log(f"  gn {str(list(shape)):22s} {dtype:8s} relu={int(relu)} "
                    f"max_abs_err={err:.3g} (tol {TOL[dtype]} abs+rel)")
                require(excess <= 0, f"kernel disagrees with plain at {shape} {dtype}")
                max_err = max(max_err, err)
        del xf

    per_shape = []
    for shape in GN_SHAPES:
        c = shape[1]
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        k = cuda_time_ms(lambda: gn.group_norm_relu(x, w, b, 32, True))
        p = cuda_time_ms(lambda: gn.group_norm_relu_reference(x, w, b, 32, True))
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        per_shape.append({"shape": list(shape), "ms": k, "plain_ms": p, "bound_ms": bound})
        log(f"  time {str(list(shape)):22s} bf16 relu kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, bound {bound:.4f} ms")

    c = TIMED_SHAPE[1]
    x = torch.randn(TIMED_SHAPE, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(c, device="cuda", generator=g) * 0.2 + 1.0
    b = torch.randn(c, device="cuda", generator=g) * 0.5
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ms = cuda_time_ms(lambda: gn.group_norm_relu(x, w, b, 32, True))
    plain_ms = cuda_time_ms(lambda: gn.group_norm_relu_reference(x, w, b, 32, True))
    lib_ms = cuda_time_ms(lambda: torch.relu(F.group_norm(x, 32, wl, bl, eps=gn.EPS)))
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    log(f"  timed shape {list(TIMED_SHAPE)} bf16 relu: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library F.group_norm+relu {lib_ms:.4f} ms, HBM bound "
        f"{bound_ms:.4f} ms (2 * numel * 2 B at 3.35 TB/s)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "per_shape": per_shape}


def seeded_dets(np, torch, cfg, batch: int, seed: int):
    """Detections pinned like the JAX bench (benchmarks/common.py::
    pin_valid_dets): the first PINNED_DETS slots of every image valid.  An
    untrained net finds next to nothing, so the boxes come from a seed:
    sides of 1/16 to 1/3.2 of the stride-4 map (8-40 stride px at 512x512),
    inside the map, scores descending."""
    from kgtpu_torch.ops.group import Boxes
    rng = np.random.default_rng(seed)
    d = cfg.group.max_detections
    side = cfg.infer.input_size / cfg.data.stride
    wh = rng.uniform(side / 16, side / 3.2, (batch, d, 2))
    xy = rng.uniform(0, side - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.2, 1.0, (batch, d)), axis=1)[:, ::-1].astype(np.float32)
    valid = np.zeros((batch, d), bool)
    valid[:, :PINNED_DETS] = True
    scores[~valid] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return Boxes(boxes=t(boxes), scores=t(scores), valid=t(valid))


def run_pinned(torch, infer, model, cfg, images, dets):
    """Detect on `images` (raw uint8, on the card), then the mask stage on
    the pinned `dets`.  Returns (detections, mask-stage output)."""
    from kgtpu_torch.ops.preprocess import normalize_images
    with torch.inference_mode():
        x = normalize_images(images, cfg.data.mean, cfg.data.std)
        found, feats = infer.detect_batch(model, cfg, x)
        out = infer.mask_batch(model, cfg, feats, dets, images.shape[1], images.shape[2])
    return found, out


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
    """torch.profiler over one pinned e2e call: kernels by device time, and
    the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
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
    log(f"  profile: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}")
    for e in rows[:top]:
        log(f"    {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


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
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import build_model
    from kgtpu_torch.ops import groupnorm as gn
    from kgtpu_torch.predictor import Predictor

    # 1. build
    t = time.perf_counter()
    lib = gn.build()
    log(f"[1] built {lib} with nvcc in {time.perf_counter() - t:.1f} s")

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
    pinned = seeded_dets(np, torch, cfg, 8, seed=1)
    torch.cuda.synchronize()

    gn.launches = 0                                   # the main path's run
    t = time.perf_counter()
    outs = [infer_fn(b) for b in batches]
    preds = [predictor.predict(im) for im in singles]
    n0 = gn.launches
    found, pinned_out = run_pinned(torch, infer, model, cfg, pinned_imgs, pinned)
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
    found_p, plain_out = run_pinned(torch, infer, model, cfg, pinned_imgs, pinned)
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
    dets32 = seeded_dets(np, torch, cfg, E2E_BATCH, seed=2)
    run_pinned(torch, infer, model, cfg, imgs32, dets32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t = time.perf_counter()
    for _ in range(iters):
        _, o = run_pinned(torch, infer, model, cfg, imgs32, dets32)
        o["label_map"].sum().item()
    e2e_s = (time.perf_counter() - t) / iters
    img_s = E2E_BATCH / e2e_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = stage_times(torch, infer, model, cfg, imgs32, dets32)
    dg_ms = stages["decode_group_nms"]
    log(f"  e2e {img_s:.2f} img/s ({e2e_s * 1e3:.1f} ms per batch of {E2E_BATCH}, "
        f"{PINNED_DETS} pinned dets/img, peak {peak_gb:.2f} GB); decode+group+nms "
        f"{dg_ms / E2E_BATCH:.4f} ms/img")
    log("  stages, ms per batch of %d: %s" % (E2E_BATCH, ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items())))
    if "--profile" in sys.argv[1:]:
        profile_e2e(torch, lambda: run_pinned(torch, infer, model, cfg, imgs32, dets32))

    metrics = {"e2e_img_per_s": img_s, "e2e_batch": E2E_BATCH,
               "pinned_dets_per_img": PINNED_DETS, "decode_group_ms_per_img":
               dg_ms / E2E_BATCH, "peak_mem_gb": peak_gb,
               "gn_launches_per_forward": backbone_per_forward,
               "gn_launches_mask_head_pinned_batch": mask_launches,
               "label_map_agreement_vs_plain": same,
               "gn_per_shape": kstats["per_shape"], "card": smi}
    log("metrics " + json.dumps(metrics))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    kernel = {"name": "group_norm_relu", "route": "cuda",
              "source": "kgtpu_torch/csrc/groupnorm.cu",
              "replaces": "kgtpu/ops/pallas/groupnorm.py:119",
              "launches": main_launches, "max_abs_err": kstats["max_abs_err"],
              "ms": kstats["ms"], "plain_ms": kstats["plain_ms"],
              "bound_ms": kstats["bound_ms"], "bound_by": "bytes",
              "library_ms": kstats["library_ms"]}
    print(json.dumps({"kernels": [kernel]}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
