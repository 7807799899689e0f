"""Tracing and cost counts: counterpart of `kgtpu/utils/profiling.py`.

  * `trace(log_dir)`: a context manager around torch.profiler (host ops,
    and the card's kernels when CUDA is available) that writes a Chrome
    trace (`trace.json`) into `log_dir`; view it in Perfetto or
    chrome://tracing.  The CLIs expose it as --profile_dir.
  * `cost_analysis(fn, *args)`: the floating-point operations of one call,
    counted by `torch.utils.flop_counter.FlopCounterMode` (convolutions and
    matmuls, as `cli/bench.py` counts them), and the bytes it accesses.
  * `summarize_cost(fn, *args)`: the two as one line, with the arithmetic
    intensity.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/prof"): run_steps()` -> a Chrome trace in log_dir."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of the tensors each op reads and writes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def cost_analysis(fn, *args) -> dict:
    """Run fn(*args) once and count its cost: {"flops": float, "bytes
    accessed": float}.

    "bytes accessed" sums, over every aten op the call dispatches (views
    excluded), the bytes of its tensor inputs and outputs: an unfused count,
    unlike XLA's, which counts a fused program's own traffic, so it is an
    upper bound of what the call moves."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    traffic = _BytesMode()
    with torch.no_grad(), counter, traffic:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": float(traffic.total)}


def summarize_cost(fn, *args, name: str = "fn") -> str:
    ca = cost_analysis(fn, *args)
    flops = ca.get("flops", 0.0)
    byts = ca.get("bytes accessed", 0.0)
    ai = flops / byts if byts else float("nan")
    return (f"{name}: {flops/1e9:.2f} GFLOP, {byts/1e6:.1f} MB accessed, "
            f"arithmetic intensity {ai:.1f} FLOP/B")
