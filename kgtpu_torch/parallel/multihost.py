"""Data-parallel training over processes: counterpart of
`kgtpu/parallel/multihost.py`.

kgtpu runs one SPMD program over a global mesh, every host feeding its rows
of the batch, and XLA emits the collectives.  Here every rank is a process
that drives one device (`cuda:<local rank>`, or the CPU), joined in a
`torch.distributed` process group (NCCL on CUDA, gloo on the CPU).  A rank
holds only its rows of the global batch (`data.loader.batch_iterator(...,
process_id, num_processes)` builds them), and `GlobalBatch` gives it the
global batch's counts and sums, so that its step computes its share of the
global batch's update (`train_lib`).

Usage contract (`cli/train.py` wires it): `initialize` on every rank before
the model is built; host decisions that must agree (a new best epoch, the
watchdog's restart) go through `broadcast_scalar` / `all_hosts_max`; only
the main rank writes files (`is_main`).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def initialize(coordinator: str, num_hosts: int, host_id: int,
               device: str | torch.device = "cuda", timeout_s: int = 600) -> torch.device:
    """Join the process group of `num_hosts` ranks at tcp://`coordinator`
    (host:port; rank 0 listens there) as rank `host_id`, with NCCL for a
    CUDA device and gloo for the CPU, and return this rank's device.  On
    CUDA the rank drives `cuda:<host_id mod visible cards>`, made current
    before the group starts.

    Then one throwaway collective, as kgtpu's `initialize` runs one: the
    ranks are skewed here only by their imports, while later they may be
    skewed by a dataset build or a capture; and a CUDA graph can capture
    NCCL only on a communicator that is already up."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", host_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_hosts,
                            rank=host_id, timeout=datetime.timedelta(seconds=timeout_s))
    warm = torch.zeros(1, device=dev)
    dist.all_reduce(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dev


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _group() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def world_size() -> int:
    """The ranks of the process group; 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class _Sum(torch.autograd.Function):
    """x summed over the ranks, with the gradient: the ranks' gradients of
    the sum, summed over the ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def differentiable_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks (all-reduce), differentiable."""
    return _Sum.apply(x)


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits for the others (nothing outside a group)."""
    if _group():
        dist.barrier()


def broadcast_scalar(x: float) -> float:
    """The main rank's value on every rank.  Host decisions (is this epoch
    a new validation best?) must be identical everywhere: floats computed
    apart could straddle a comparison and desync the ranks' collectives."""
    if not _group():
        return float(x)
    t = torch.tensor([x], dtype=torch.float32, device=_comm_device())
    dist.broadcast(t, 0)
    return float(t.item())


def all_hosts_max(x: float) -> float:
    """Max of a per-rank scalar over the ranks (the host RSS, so every rank
    reaches the same watchdog decision)."""
    if not _group():
        return float(x)
    t = torch.tensor([x], dtype=torch.float32, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


class GlobalBatch:
    """A rank's view of the global batch of a data-parallel step.

    kgtpu's `global_batch` assembles the hosts' rows into one global array.
    In torch each rank keeps only its rows; this object gives it what the
    global array gave kgtpu's step: the global batch size, its rows of a
    global draw, and sums over every rank's rows (all-reduces of the
    default process group).  `collectives` counts the all-reduces it has
    issued."""

    def __init__(self):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.collectives = 0

    def size(self, local: int) -> int:
        """The global batch size of `local` rows a rank."""
        return local * self.world

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [B, ...] tensor."""
        lb = x.shape[0] // self.world
        return x[self.rank * lb:(self.rank + 1) * lb]

    @torch.no_grad()
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over the ranks (no gradient)."""
        y = x.detach().clone()
        dist.all_reduce(y)
        self.collectives += 1
        return y

    def sum_flat(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over the ranks, in ONE all-reduce of a flat
        buffer; returns views of it with the tensors' shapes and strides
        (channels-last gradients stay channels-last)."""
        flat, views = _flat(tensors)
        dist.all_reduce(flat)
        self.collectives += 1
        return views


@torch.no_grad()
def _flat(tensors: list[torch.Tensor]) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """A flat buffer holding the tensors one after another in their memory
    order, and views of it with their shapes and strides."""
    flat = torch.empty(sum(t.numel() for t in tensors), dtype=tensors[0].dtype,
                       device=tensors[0].device)
    views, off = [], 0
    for t in tensors:
        if not (t.is_contiguous() or (t.dim() == 4 and
                                      t.is_contiguous(memory_format=torch.channels_last))):
            raise ValueError("a flat collective takes contiguous or channels-last tensors")
        v = flat.as_strided(t.shape, t.stride(), off)
        v.copy_(t)
        views.append(v)
        off += t.numel()
    return flat, views


@torch.no_grad()
def broadcast_tensors(tensors: list[torch.Tensor]) -> None:
    """Rank 0's values of the tensors (one dtype) on every rank, in place,
    through one flat broadcast."""
    if not _group() or not tensors:
        return
    flat, views = _flat(tensors)
    dist.broadcast(flat, 0)
    for t, v in zip(tensors, views):
        t.copy_(v)


def global_batch() -> GlobalBatch | None:
    """This rank's `GlobalBatch` inside a process group (of any size, so a
    one-rank group runs the data-parallel step with its all-reduces), None
    outside one."""
    return GlobalBatch() if dist.is_initialized() else None
