"""Gaussian target heatmaps for a batch: the Hopper kernel's wrapper.

The port's counterpart of `kgtpu/ops/pallas/gaussian.py::
render_heatmaps_pallas` (vmapped over the batch, as the JAX train step runs
it).  The kernel is `csrc/gaussian.cu` (its header note gives the design and
what bounds it); the plain version is `ops/targets.py::
render_heatmaps_batch`.

`render_heatmaps` takes a CPU tensor to the plain version.  For CUDA tensors
it allocates the output and launches the kernel once for the whole batch on
the inputs as they are (cast to contiguous f32 only where they are not): the
kernel floors the keypoints and computes each instance's radius and
1 / (2 sigma^2) itself.  It is built with nvcc at first use (`ops/_cuda.py`),
or the call raises.  Targets are data: no gradient flows through them, and
the output never requires one.  `launches` counts the kernel's launches:
one per CUDA call of the wrapper, and, for a CUDA graph that holds
launches (`train_lib`'s captured steps), their number on every replay; the
capture itself runs nothing and adds nothing.
"""

from __future__ import annotations

import ctypes

import torch

from kgtpu_torch.ops import _cuda
from kgtpu_torch.ops.targets import render_heatmaps_batch

# Number of times the CUDA kernel was launched in this process (graph
# replays included).
launches = 0

_SRC = "gaussian.cu"
# A block renders a TILE_H x TILE_W tile of one image (csrc/gaussian.cu
# kTileH, kTileW) from the instances within reach of the tile.
TILE_H = 8
TILE_W = 32
CUTOFF = 14.0               # reach: d^2 * coef < CUTOFF, exp(-14) ~ 8.3e-7
_MAX_INSTANCES = 1000       # the kernel's lists: 15 floats an instance


def build() -> str:
    """Compile csrc/gaussian.cu (once per source hash); its library path."""
    return _cuda.build(_SRC)


def _fn():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return _cuda.load(_SRC, "kgtpu_render_heatmaps",
                      [p, p, p, p, i, i, i, i, ctypes.c_double, p])


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def render_heatmaps(kpts: torch.Tensor, sizes_hw: torch.Tensor,
                    valid: torch.Tensor, height: int, width: int,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """kpts [B, N, 5, 2] (x, y) in stride coords, sizes_hw [B, N, 2], valid
    [B, N] -> heatmaps [B, height, width, 5] float32."""
    if kpts.dim() != 4 or kpts.shape[2:] != (5, 2):
        raise ValueError(f"expected kpts [B, N, 5, 2], got {tuple(kpts.shape)}")
    b, n = kpts.shape[:2]
    if sizes_hw.shape != (b, n, 2) or valid.shape != (b, n):
        raise ValueError("sizes_hw must be [B, N, 2] and valid [B, N]")
    dev = kpts.device
    if dev.type == "cpu":
        return render_heatmaps_batch(kpts, sizes_hw, valid, height, width,
                                     min_overlap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if sizes_hw.device != dev or valid.device != dev:
        raise ValueError("kpts, sizes_hw and valid must be on one device")
    if n > _MAX_INSTANCES:
        raise ValueError(f"{n} instances exceed the kernel's limit of {_MAX_INSTANCES}")
    out = torch.empty((b, height, width, 5), dtype=torch.float32, device=dev)
    if b == 0 or height == 0 or width == 0:
        return out
    k, s, v = _f32(kpts.detach()), _f32(sizes_hw.detach()), _f32(valid.detach())
    err = _cuda.call_on(dev, _fn(), k.data_ptr(), s.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, n, height, width, min_overlap)
    if err != 0:
        raise RuntimeError(f"Gaussian kernel launch failed (error {err})")
    global launches
    launches += 1
    return out
