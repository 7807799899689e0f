"""GroupNorm(+ReLU) over channels-last activations: the Hopper kernel's wrapper
and its plain PyTorch version.

The port's counterpart of `kgtpu/ops/pallas/groupnorm.py::fused_group_norm`
and of flax `nn.GroupNorm` as `kgtpu/models/blocks.py::Norm` uses it: stats
per (sample, group) in f32, eps 1e-6, per-channel scale and bias, optional
ReLU, output in the input dtype.  The kernel is `csrc/groupnorm.cu` (its
header note gives the design and what bounds it): one cooperative launch
per call that reads x once and writes y once.

`group_norm_relu` takes an NCHW tensor laid out channels-last (NHWC in
memory), the layout the port's convolutions produce, checks it and calls the
custom op `torch.ops.kgtpu_torch.group_norm_relu`: on a CPU tensor the op
computes `group_norm_relu_reference`; on a CUDA tensor it launches the
kernel, which is built with nvcc at first use (`ops/_cuda.py`), or raises.
As a registered op (with a fake implementation that gives the kernel's
channels-last output) the norm is one node of a `torch.export` graph, and a
saved program calls the kernel through it (`kgtpu_torch/export.py`).  An
eager call (a plain tensor, no Python dispatch mode active) runs the op's
implementation directly, without the op's dispatch.  The
kernel has no backward, like the Pallas one: on CUDA the wrapper raises when
autograd would record the call, rather than return a result with no
`grad_fn`; on the CPU such a call computes the differentiable plain version
directly.  `launches` counts the kernel's launches.

`launch_plan` is the pure-Python part of a launch: how a sample's rows are
cut into the parts that one block each holds in shared memory, and the
persistent grid that walks them.  The wrapper caches a plan per shape, and a
workspace (the parts' partial sums and the per-sample arrival counters) per
device and stream, grown when a larger call needs it: a call allocates
nothing but its output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from kgtpu_torch.ops import _cuda

EPS = 1e-6

# Number of times the CUDA kernel was launched in this process.
launches = 0

_SRC = "groupnorm.cu"
THREADS = 256               # threads per block (csrc/groupnorm.cu kThreads)
SLOTS = 3                   # slab slots per block (csrc/groupnorm.cu kSlots)
# Shared memory per block, so that two blocks fit an H100 SM: (228 KB less
# the 1 KB the runtime reserves per block) / 2.
SMEM_PER_BLOCK = 115_712
# A part holds at least this many bytes of x unless its sample is smaller:
# below it the exchange between parts costs more than the spread gains.
MIN_PART_BYTES = 16 * 1024
# A block's step (sum, exchange and normalise one item) has a fixed cost of
# about the time its slot's data takes: the plan counts it as this many
# bytes per step (from the kernel's phase times on an H100, PERF.md).
STEP_BYTES = 32 * 1024


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


class Params(ctypes.Structure):
    """csrc/groupnorm.cu's Params, field for field."""
    _fields_ = [("batch", ctypes.c_int64), ("hw", ctypes.c_int64),
                ("c", ctypes.c_int), ("groups", ctypes.c_int),
                ("rows_per_block", ctypes.c_int), ("slab_rows", ctypes.c_int),
                ("parts", ctypes.c_int), ("grid", ctypes.c_int),
                ("smem", ctypes.c_int), ("slab_bytes", ctypes.c_int),
                ("relu", ctypes.c_int), ("eps", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut: a work item is (sample, part), the part's
    `rows_per_block` rows of the sample's [H*W, C] matrix, which a block
    holds in one of its SLOTS shared-memory slots of `slab_rows` rows (in
    `chunks` slabs where an item is longer than a slot; 1 chunk: x is read
    once).  `grid` blocks, a multiple of `parts`, walk the items in
    sample-major order in `rounds` rounds."""
    slab_rows: int
    chunks: int
    rows_per_block: int
    parts: int
    grid: int
    rounds: int
    smem: int            # dynamic shared memory per block, bytes
    slab_bytes: int      # one slot, 16-byte aligned
    workspace: int       # f32 partial sums [batch, parts, stride], stride =
                         # 2 * groups rounded up to a multiple of 4


def scratch_bytes(c: int, groups: int, vec: int) -> int:
    """The kernel's shared memory beside the slots: per-thread channel sums,
    each slot's group stats, scale and bias, and a and b."""
    rpp = THREADS // (c // vec)
    return 4 * (2 * rpp * c + SLOTS * 2 * groups + 4 * c)


def launch_plan(batch: int, hw: int, c: int, groups: int, itemsize: int,
                vec: int, capacity: int) -> Plan:
    """The launch of one call on `batch` samples of [hw, c]: `capacity` is
    how many blocks fit the card at once.

    Parts are as few as the slot size allows, and more where that shortens
    the call: rounds x (STEP_BYTES + the bytes of a part), with parts of at
    least MIN_PART_BYTES.  Raises where the shape does not fit the kernel."""
    nvec = c // vec
    if nvec > THREADS:
        raise ValueError(f"channels {c} exceed the kernel's limit of "
                         f"{THREADS * vec} at {vec} per access")
    stride = -(-2 * groups // 4) * 4          # a part's sums, whole float4s
    if stride > 2 * (THREADS // nvec) * c:    # the exchange adds them in that scratch
        raise ValueError(f"{groups} groups exceed the kernel's exchange")
    row = c * itemsize
    scratch = scratch_bytes(c, groups, vec)
    max_rows = (SMEM_PER_BLOCK - scratch - 15 * SLOTS) // (SLOTS * row)
    if max_rows < 1 or capacity < 1:
        raise ValueError(f"a row of {c} channels does not fit the kernel's "
                         f"shared memory (capacity {capacity})")
    slabs = math.ceil(hw / max_rows)          # parts a sample needs at least
    if slabs > capacity:
        # a sample larger than all resident blocks' shared memory together
        chunks = math.ceil(slabs / capacity)
        parts = math.ceil(slabs / chunks)
    else:
        chunks = 1
        most = max(slabs, min(capacity, hw * row // MIN_PART_BYTES))

        def cost(k):
            return math.ceil(batch / (capacity // k)) * (STEP_BYTES + math.ceil(hw / k) * row)

        parts = min(range(slabs, most + 1), key=cost)
    rows_per_block = math.ceil(hw / parts)
    parts = math.ceil(hw / rows_per_block)
    slab_rows = math.ceil(rows_per_block / chunks)
    per_round = min(capacity // parts, batch)
    slab_bytes = -(-slab_rows * row // 16) * 16
    return Plan(slab_rows=slab_rows, chunks=chunks, rows_per_block=rows_per_block,
                parts=parts, grid=per_round * parts,
                rounds=math.ceil(batch / per_round), smem=SLOTS * slab_bytes + scratch,
                slab_bytes=slab_bytes, workspace=batch * parts * stride)


def build() -> str:
    """Compile csrc/groupnorm.cu (once per source hash); its library path."""
    return _cuda.build(_SRC)


def _fn():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return _cuda.load(_SRC, "kgtpu_group_norm_relu",
                      [p, p, p, p, p, p, i, ctypes.POINTER(Params), i, i, i, p])


_capacity: dict = {}      # (device index, dtype code, vec) -> blocks
_plans: dict = {}         # call signature -> (Plan, Params)
# (device index, stream) -> [partial f32, counters int32 [2, n], bank in use]
_work: dict = {}


def device_capacity(device: torch.device, dtype_code: int, vec: int) -> int:
    """Blocks of the kernel instance of (dtype, vec) that fit the card at
    once at SMEM_PER_BLOCK; sets its shared-memory limit."""
    key = (device.index, dtype_code, vec)
    got = _capacity.get(key)
    if got is None:
        f = _cuda.load(_SRC, "kgtpu_group_norm_capacity",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int()
        with torch.cuda.device(device):
            err = f(dtype_code, vec, SMEM_PER_BLOCK, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"GroupNorm kernel capacity query failed (error {err})")
        if out.value < 1:
            raise RuntimeError("the GroupNorm kernel needs cooperative launch, "
                               "which this device does not offer")
        got = _capacity[key] = out.value
    return got


def _workspace(device: torch.device, stream: int, floats: int, batch: int) -> list:
    """[partial sums, two banks of arrival counters, the bank this call
    counts in] for calls on `stream`, grown where this call needs more.  The
    banks take turns: the kernel zeroes the one the next call counts in."""
    ws = _work.get((device.index, stream))
    if ws is None or ws[0].numel() < floats or ws[1].shape[1] < batch:
        n_f = max(floats, ws[0].numel() if ws else 0)
        n_b = max(batch, ws[1].shape[1] if ws else 0)
        ws = _work[(device.index, stream)] = [
            torch.empty(n_f, device=device, dtype=torch.float32),
            torch.zeros((2, n_b), device=device, dtype=torch.int32), 1]
    ws[2] ^= 1
    return ws


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
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        if dev.type == "cpu":
            return group_norm_relu_reference(x, weight, bias, groups, relu)
        raise RuntimeError(
            "the GroupNorm kernel has no backward: its output would cut the "
            "autograd graph (train with the module in training mode, or run "
            "under torch.no_grad / torch.inference_mode)")
    if dev.type == "cuda":
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("the GroupNorm kernel needs a channels_last tensor")
        if (weight.dtype != torch.float32 or bias.dtype != torch.float32
                or weight.device != dev or bias.device != dev
                or not weight.is_contiguous() or not bias.is_contiguous()):
            raise ValueError("weight and bias must be contiguous float32 on x's device")
    if type(x) is not torch.Tensor or torch._C._len_torch_dispatch_stack():
        # traced (fake tensors, a tracing or checking dispatch mode): the op,
        # one node of the graph
        return torch.ops.kgtpu_torch.group_norm_relu(x, weight, bias, groups, relu)
    # eager: the op's implementation directly; the op's dispatch costs the
    # card's host ~17 us a launch, which lowered e2e img/s (PERF.md §6)
    if dev.type == "cuda":
        return launch(x, weight, bias, groups, relu)
    return _group_norm_relu_cpu(x, weight, bias, groups, relu)


@torch.library.custom_op("kgtpu_torch::group_norm_relu", mutates_args=(),
                         device_types="cuda")
def _group_norm_relu_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        groups: int, relu: bool) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel (`launch`)."""
    return launch(x, weight, bias, groups, relu)


@_group_norm_relu_op.register_kernel("cpu")
def _group_norm_relu_cpu(x, weight, bias, groups, relu):
    return group_norm_relu_reference(x, weight, bias, groups, relu).contiguous(
        memory_format=torch.channels_last)


@_group_norm_relu_op.register_fake
def _group_norm_relu_fake(x, weight, bias, groups, relu):
    return torch.empty_like(x, memory_format=torch.channels_last)


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, relu: bool) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors that `group_norm_relu` has
    checked: y [B, C, H, W] channels-last, in x's dtype."""
    dev = x.device
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if b == 0 or h * w == 0:
        return y
    code = 0 if x.dtype == torch.float32 else 1
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    key = (dev.index, b, h * w, c, groups, code, vec, relu)
    got = _plans.get(key)
    if got is None:
        plan = launch_plan(b, h * w, c, groups, x.element_size(), vec,
                           device_capacity(dev, code, vec))
        params = Params(b, h * w, c, groups, plan.rows_per_block, plan.slab_rows,
                        plan.parts, plan.grid, plan.smem, plan.slab_bytes,
                        int(relu), EPS)
        got = _plans[key] = (plan, params)
    plan, params = got
    ws = _workspace(dev, torch._C._cuda_getCurrentRawStream(dev.index), plan.workspace, b)
    partial, counters, bank = ws
    err = _cuda.call_on(dev, _fn(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                        y.data_ptr(), partial.data_ptr(), counters.data_ptr(),
                        counters.shape[1], ctypes.byref(params), bank, code, vec)
    if err != 0:
        ws[2] ^= 1                  # the kernel did not run: the turn is unused
        raise RuntimeError(f"GroupNorm kernel launch failed (error {err})")
    global launches
    launches += 1
    return y
