"""Gaussian target heatmaps for a batch: the Hopper kernel's wrapper.

The port's counterpart of `kgtpu/ops/pallas/gaussian.py::
render_heatmaps_pallas` (vmapped over the batch, as the JAX train step runs
it).  The kernel is `csrc/gaussian.cu` (its header note gives the design and
what bounds it); the plain version is `ops/targets.py::
render_heatmaps_batch`.

`render_heatmaps` takes a CPU tensor to the plain version.  For CUDA tensors
it floors the keypoints and computes each instance's 1 / (2 sigma^2) in torch
on the card, then renders the whole batch in one launch of the kernel, which
is built with nvcc at first use (`ops/_cuda.py`), or raises.  Targets are
data: no gradient flows through them, and the output never requires one.
`launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from kgtpu_torch.ops import _cuda
from kgtpu_torch.ops.targets import render_heatmaps_batch, splat_coef

# Number of times the CUDA kernel was launched in this process.
launches = 0

_SRC = "gaussian.cu"
BAND_H = 8                  # rows per block: 128 blocks at [8, 128, 128]
_MAX_INSTANCES = 1000       # the kernel's shared memory stays under 48 KB


def build() -> str:
    """Compile csrc/gaussian.cu (once per source hash); its library path."""
    return _cuda.build(_SRC)


def _fn():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return _cuda.load(_SRC, "kgtpu_render_heatmaps",
                      [p, p, p, p, i, i, i, i, i, p])


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
    if kpts.device.type == "cpu":
        return render_heatmaps_batch(kpts, sizes_hw, valid, height, width,
                                     min_overlap)
    if kpts.device.type != "cuda":
        raise ValueError(f"unsupported device {kpts.device}")
    if sizes_hw.device != kpts.device or valid.device != kpts.device:
        raise ValueError("kpts, sizes_hw and valid must be on one device")
    out = torch.empty((b, height, width, 5), dtype=torch.float32, device=kpts.device)
    if b == 0 or height == 0 or width == 0:
        return out
    if n == 0:
        return out.zero_()
    if n > _MAX_INSTANCES:
        raise ValueError(f"{n} instances exceed the kernel's limit of {_MAX_INSTANCES}")
    with torch.no_grad():
        k = torch.floor(kpts.float())
        kx = k[..., 0].transpose(1, 2).contiguous()                # [B, 5, N]
        ky = k[..., 1].transpose(1, 2).contiguous()
        coef = splat_coef(sizes_hw, valid, min_overlap).contiguous()  # [B, N]
    with torch.cuda.device(out.device):
        err = _fn()(kx.data_ptr(), ky.data_ptr(), coef.data_ptr(), out.data_ptr(),
                    b, n, height, width, BAND_H,
                    torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Gaussian kernel launch failed (error {err})")
    global launches
    launches += 1
    return out
