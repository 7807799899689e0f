"""Serving export: the whole inference program as one self-contained artifact.
Counterpart of `kgtpu/export.py` (`export_infer`, `load_serving`,
`python -m kgtpu.export`).

The artifact is a `torch.export` program saved with `torch.export.save`:
the pipeline of `infer.build_infer_fn` (device-side normalize -> backbone
-> decode -> group -> NMS -> mask head -> paste), or its TTA or whole-slide
form, traced once with the trained weights held in the program as its
state.  Every eval-mode GroupNorm is one node of the op
`kgtpu_torch::group_norm_relu`, so the program launches the Hopper kernel on
CUDA; the grouper's and NMS's rounds are `torch.while_loop`s and the slot
chunks of the mask stage `torch.cond`s (the `traced` forms of `infer.py`).

    # build side (once, after training)
    python -m kgtpu_torch.export --weights weights/ --out model.pt2 --batch 8

    # serving side: no model code, checkpoint or config
    from kgtpu_torch.export import load_serving
    fn = load_serving("model.pt2")          # device="cuda" by default
    out = fn(images_uint8)                   # (B, H, W, 3) raw pixels
    out["label_map"], out["boxes"], out["scores"], ...

The serving site needs one import of this package, for the op's
registration (`kgtpu_torch.ops.groupnorm`, which importing this module
does): the op's CUDA implementation builds the kernel from
`kgtpu_torch/csrc/` at first use, and its CPU implementation is the plain
version.  It needs no model code, checkpoint or config.

Shapes are static (batch and canvas fixed at export time), as in kgtpu.
`platforms` names the device classes the artifact serves on ("cuda",
"cpu"); it is exported on the first, and `load_serving` moves it to another
with `torch.export.passes.move_to_device_pass`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Callable

import numpy as np
import torch

import kgtpu_torch.ops.groupnorm  # noqa: F401  (registers the GroupNorm op)

__all__ = ["export_infer", "load_serving", "serving_model"]

PLATFORMS = ("cuda", "cpu")
MANIFEST = "kgtpu_torch_manifest.json"   # the manifest, inside the artifact


class _Program(torch.nn.Module):
    """The module `torch.export` traces: a builder's pipeline over `model`
    (registered, so that its weights become the program's state)."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, images):
        return self.fn(images)


def _side(size: int, scale: float, div: int) -> int:
    """A TTA scale's side: round(scale * size) to the divisor (test.py)."""
    return max(round(size * scale / div), 1) * div


def serving_model(checkpoint_path: str, *, use_ema: bool = False,
                  input_size: int | None = None,
                  test_scales: tuple[float, ...] | None = None,
                  test_flip: bool | None = None, tile_size: int | None = None,
                  compute_dtype: str | None = None):
    """(cfg, model) that `export_infer` traces: the checkpoint's stored
    architecture with the default inference settings and these overrides,
    the size-prior fallback of Predictor and `cli.test`, and the weights
    loaded (on the CPU, in training mode: the builders move and switch it)."""
    from kgtpu_torch import checkpoint as ckpt
    from kgtpu_torch.config import Config
    from kgtpu_torch.models import KGNet
    from kgtpu_torch.predictor import size_prior_fallback

    state_dict, extra = ckpt.restore_bundle(checkpoint_path, use_ema=use_ema)
    stored = ckpt.decode_config(extra)
    cfg = Config() if stored is None else dataclasses.replace(Config(), model=stored.model)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
    overrides = {k: v for k, v in (("input_size", input_size), ("test_scales", test_scales),
                                   ("test_flip", test_flip), ("tile_size", tile_size))
                 if v is not None}
    if "test_scales" in overrides:
        overrides["test_scales"] = tuple(overrides["test_scales"])
    if overrides:
        cfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, **overrides))
    # without wh-head size pruning, the stored dataset stats cap the box size
    cfg = size_prior_fallback(cfg, extra)
    model = KGNet(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    return cfg, model


def export_infer(checkpoint_path: str, out_path: str, *, batch: int = 8,
                 input_size: int | None = None, use_ema: bool = False,
                 platforms: tuple[str, ...] | None = None,
                 mode: str = "single",
                 test_scales: tuple[float, ...] | None = None,
                 test_flip: bool | None = None,
                 slide_hw: tuple[int, int] | None = None,
                 tile_size: int | None = None,
                 compute_dtype: str | None = None) -> dict:
    """Export the checkpoint's inference program to `out_path`.

    Weights are baked in (the artifact is self-contained); inputs are raw
    uint8 pixels.  Returns a manifest dict whose ``inputs`` entry records
    the exact serving-call shapes.

    mode="single": images (batch, size, size, 3).
    mode="tta":    dict {"<scale>": (batch, side_s, side_s, 3)} with
                   side_s = round-to-divisor(scale * size), the sides
                   `cli.test` feeds `build_multiscale_fn`.
    mode="tiled":  one whole slide (H, W, 3) of static `slide_hw`.

    platforms: device classes the artifact serves on (default ("cuda",));
    the program is traced on the first.  compute_dtype overrides the
    checkpoint's ("bfloat16" or "float32"), as `cli.test --compute_dtype`.
    The config is `serving_model`'s.
    """
    from kgtpu_torch.config import required_divisor
    from kgtpu_torch.device import resolve_device
    from kgtpu_torch.infer import (build_infer_fn, build_multiscale_fn,
                                   build_tiled_infer_fn)

    platforms = tuple(platforms or ("cuda",))
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad} (choose from {PLATFORMS})")
    cfg, model = serving_model(checkpoint_path, use_ema=use_ema, input_size=input_size,
                               test_scales=test_scales, test_flip=test_flip,
                               tile_size=tile_size, compute_dtype=compute_dtype)
    if mode == "tta" and 1.0 not in cfg.infer.test_scales:
        raise ValueError(f"test_scales {cfg.infer.test_scales} must include 1.0")
    size = cfg.infer.input_size
    div = required_divisor(cfg.model)
    checked = cfg.infer.tile_size if mode == "tiled" else size
    if checked % div:
        raise ValueError(f"input side {checked} must be divisible by {div}")

    dev = resolve_device(platforms[0])
    model.requires_grad_(False)
    u8 = dict(dtype=torch.uint8, device=dev)
    if mode == "single":
        fn = build_infer_fn(model, cfg, device=dev, traced=True)
        spec = torch.zeros((batch, size, size, 3), **u8)
    elif mode == "tta":
        fn = build_multiscale_fn(model, cfg, device=dev, traced=True)
        spec = {f"{sc:g}": torch.zeros((batch, _side(size, sc, div), _side(size, sc, div), 3),
                                       **u8)
                for sc in cfg.infer.test_scales}
    elif mode == "tiled":
        if slide_hw is None:
            raise ValueError('mode="tiled" needs slide_hw=(H, W)')
        fn = build_tiled_infer_fn(model, cfg, tuple(slide_hw), device=dev, traced=True)
        spec = torch.zeros((*slide_hw, 3), **u8)
    else:
        raise ValueError(f"unknown export mode {mode!r}")
    with torch.no_grad():
        program = torch.export.export(_Program(model, fn), (spec,), strict=False)
    out_spec = program.call_spec.out_spec
    outputs = torch.utils._pytree.tree_unflatten([None] * out_spec.num_leaves, out_spec)
    manifest = {
        "out": out_path,
        "bytes": 0,
        "mode": mode,
        "batch": batch,
        "input_size": size,
        "inputs": ({k: list(v.shape) for k, v in spec.items()} if isinstance(spec, dict)
                   else list(spec.shape)),
        "platforms": list(platforms),
        "outputs": sorted(outputs.keys()) if isinstance(outputs, dict) else None,
    }
    with warnings.catch_warnings():
        # the weights are channels-last, so the writer finds no contiguous
        # tensor per storage and rebuilds each from its whole storage
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, out_path, extra_files={MANIFEST: json.dumps(manifest)})
    manifest["bytes"] = os.path.getsize(out_path)
    return manifest


def load_serving(path: str, device: str | torch.device = "cuda"):
    """Load an `export_infer` artifact as a callable on `device` (CUDA unless
    the caller asks for the CPU; an artifact traced on another device is
    moved there).

    The callable takes raw uint8 images of exactly the exported shape
    (numpy or tensors; a dict of per-scale stacks for "tta") and returns
    the output dict of `build_infer_fn` (label_map, boxes, scores, ...) as
    tensors on `device`.  `.exported` is the program, `.manifest` the
    manifest it was saved with."""
    from kgtpu_torch.device import resolve_device

    dev = resolve_device(device)
    files = {MANIFEST: ""}
    program = torch.export.load(path, extra_files=files)
    manifest = json.loads(files[MANIFEST]) if files[MANIFEST] else {}
    traced_on = manifest.get("platforms", ["cuda"])[0]
    if torch.device(traced_on).type != dev.type:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    module = program.module()

    def to_device(x):
        if isinstance(x, dict):
            return {k: to_device(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(dev)

    def serve(images) -> dict:
        with torch.no_grad():
            return module(to_device(images))

    serve.exported = program
    serve.manifest = manifest
    return serve


def _main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Export a trained checkpoint's full inference pipeline "
                    "to a self-contained torch.export serving artifact.")
    p.add_argument("--weights", required=True,
                   help="checkpoint dir / model_<epoch> / <dir>/best")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--input_size", type=int, default=0,
                   help="serving canvas (0 = the config default)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--platforms", default="",
                   help="comma list, e.g. 'cuda,cpu' (default: cuda); the "
                        "program is traced on the first")
    p.add_argument("--tta", action="store_true",
                   help="export the multi-scale TTA program "
                        "(inputs: dict of per-scale image batches)")
    p.add_argument("--test_scales", default="",
                   help="TTA scales, e.g. '0.75,1.0,1.25'")
    p.add_argument("--test_flip", action="store_true")
    p.add_argument("--slide", default="",
                   help="'H,W': export the one-call whole-slide tiled "
                        "program for this static slide size")
    p.add_argument("--tile_size", type=int, default=0,
                   help="tile side for --slide mode (0 = config default)")
    p.add_argument("--compute_dtype", default="", choices=["", "bfloat16", "float32"],
                   help="override the checkpoint's compute dtype")
    a = p.parse_args(argv)
    if a.tta and a.slide:
        raise SystemExit("--tta and --slide are exclusive")
    mode = "tta" if a.tta else ("tiled" if a.slide else "single")
    manifest = export_infer(
        a.weights, a.out, batch=a.batch, mode=mode,
        input_size=a.input_size or None, use_ema=a.use_ema,
        test_scales=(tuple(float(s) for s in a.test_scales.split(","))
                     if a.test_scales else None),
        test_flip=a.test_flip or None,
        slide_hw=(tuple(int(s) for s in a.slide.split(",")) if a.slide else None),
        tile_size=a.tile_size or None,
        platforms=tuple(s for s in a.platforms.split(",") if s) or None,
        compute_dtype=a.compute_dtype or None)
    print(json.dumps(manifest))


if __name__ == "__main__":
    _main()
