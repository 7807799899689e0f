"""GroupNorm(+ReLU) over channels-last activations: the Hopper kernel's wrapper
and its plain PyTorch version.

The port's counterpart of `kgtpu/ops/pallas/groupnorm.py::fused_group_norm`
and of flax `nn.GroupNorm` as `kgtpu/models/blocks.py::Norm` uses it: stats
per (sample, group) in f32, eps 1e-6, per-channel scale and bias, optional
ReLU, output in the input dtype.  The kernel is `csrc/groupnorm.cu` (its
header note gives the design and what bounds it).

`group_norm_relu` takes an NCHW tensor laid out channels-last (NHWC in
memory), the layout the port's convolutions produce.  A CPU tensor goes to
`group_norm_relu_reference`; a CUDA tensor launches the kernel, which is
built with nvcc at first use (`ops/_cuda.py`), or raises.  The kernel has
no backward, like the Pallas one: on CUDA the wrapper raises when autograd
would record the call, rather than return a result with no `grad_fn`.
`launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kgtpu_torch.ops import _cuda

EPS = 1e-6

# Number of times the CUDA kernel was launched in this process.
launches = 0

_SRC = "groupnorm.cu"
# Blocks the stats pass aims for: about four per SM of a 132-SM H100.
_TARGET_BLOCKS = 4 * 132


def num_groups(channels: int, max_groups: int = 32) -> int:
    """The largest divisor of `channels` that is <= max_groups (flax Norm)."""
    return max(d for d in range(1, min(max_groups, channels) + 1)
               if channels % d == 0)


def group_norm_relu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int,
                              relu: bool) -> torch.Tensor:
    """Plain version: F.group_norm in f32 with eps 1e-6, then ReLU."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps=EPS)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def build() -> str:
    """Compile csrc/groupnorm.cu (once per source hash); its library path."""
    return _cuda.build(_SRC)


def _fn():
    p = ctypes.c_void_p
    return _cuda.load(_SRC, "kgtpu_group_norm_relu",
                      [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, p])


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected an NCHW tensor, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported dtype {x.dtype} (bfloat16 or float32)")
    if groups <= 0 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("weight and bias must have shape [C]")


def group_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int, relu: bool = False) -> torch.Tensor:
    """GroupNorm(+ReLU) of x [B, C, H, W] (channels-last in memory on CUDA).

    weight, bias: [C] (float32 on the kernel path).  Output: x's dtype and
    layout.
    """
    _check(x, weight, bias, groups)
    if x.device.type == "cpu":
        return group_norm_relu_reference(x, weight, bias, groups, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError(
            "the GroupNorm kernel has no backward: its output would cut the "
            "autograd graph (train with the module in training mode, or run "
            "under torch.no_grad / torch.inference_mode)")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the GroupNorm kernel needs a channels_last tensor")
    if (weight.dtype != torch.float32 or bias.dtype != torch.float32
            or weight.device != x.device or bias.device != x.device
            or not weight.is_contiguous() or not bias.is_contiguous()):
        raise ValueError("weight and bias must be contiguous float32 on x's device")
    b, c, h, w = x.shape
    hw = h * w
    if b == 0 or hw == 0:
        return torch.empty_like(x)
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    if c // vec > 1024 or c > 4096:
        raise ValueError(f"channels {c} exceed the kernel's limit")
    per_sample = max(1, -(-_TARGET_BLOCKS // b))
    chunk_rows = max(1, -(-hw // per_sample))
    nchunks = -(-hw // chunk_rows)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    partial = torch.empty((b, nchunks, 2, c), device=x.device, dtype=torch.float32)
    ab = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            partial.data_ptr(), ab.data_ptr(), b, hw, c, groups, chunk_rows,
            nchunks, int(relu), EPS, 0 if x.dtype == torch.float32 else 1, vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed (error {err})")
    global launches
    launches += 1
    return y
