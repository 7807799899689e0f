"""The devices of a data-parallel run, and a batch split over them:
counterpart of `kgtpu/parallel/mesh.py`.

kgtpu shards a batch over a 1-D mesh of devices inside one program.  Here a
"mesh" is the list of devices that each run a replica on its shard of the
batch: `cuda:0 ... cuda:n-1`, or n CPU shards when the caller names the CPU
(kgtpu's tests run on 8 virtual CPU devices; the port's on CPU shards).
"""

from __future__ import annotations

import torch

from kgtpu_torch.device import resolve_device


def make_mesh(num_devices: int = 0, device: str | torch.device = "cuda") -> list[torch.device]:
    """The first `num_devices` CUDA devices (0 = all), or `num_devices` CPU
    shards (at least one) for `device="cpu"`.  Asking for more cards than
    are visible raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(num_devices, 1)
    count = torch.cuda.device_count()
    n = num_devices or count
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} CUDA devices visible")
    return [torch.device("cuda", i) for i in range(n)]


def shard_batch(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Axis 0 of `x` in n equal contiguous shards, in batch order."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} must divide by the {n} devices")
    return list(x.split(x.shape[0] // n))


def gather_batch(parts: list[dict], device: torch.device) -> dict:
    """The shards' outputs (dicts of tensors, batch on axis 0) concatenated
    in batch order on `device`."""
    return {k: torch.cat([p[k].to(device) for p in parts]) for k in parts[0]}
