"""How many kernel records torch.profiler keeps in a window, on the card.

`chip_smoke.py`'s `kernel_device_ms` profiles N calls of a kernel's wrapper
and requires N kernel records.  In one process that had profiled before, the
profiler has kept N - 1 or N - 2 records in every window while the wrapper
counted N.  This script measures when: each case runs in a fresh process,
profiles the Gaussian kernel (20 calls a window, six windows), after one
window of the GroupNorm kernel or without it, with the window as
`kernel_device_ms` opens it or padded by an idle wait after it opens or
before it closes.  Per window it prints the records kept, the launch calls
the profiler saw, and the times (us from the trace's start) of the first
launch call and the first kernel record.

    python3 tools/profiler_window_probe.py      # needs one CUDA card
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {  # name: (GroupNorm window first, idle s after opening, idle s before closing)
    "fresh": (False, 0.0, 0.0),
    "after_groupnorm": (True, 0.0, 0.0),
    "after_groupnorm_idle_after_open": (True, 0.05, 0.0),
    "after_groupnorm_idle_before_close": (True, 0.0, 0.05),
}
WINDOWS = 6
CALLS = 20


def window(torch, fn, launched, idle_open: float, idle_close: float) -> dict:
    from torch.profiler import ProfilerActivity, profile
    before = launched()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(idle_open)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(idle_close)
    made = launched() - before
    ev = prof.events()
    kernels = sorted(e.time_range.start for e in ev
                     if e.device_type != torch.autograd.DeviceType.CPU)
    starts = sorted(e.time_range.start for e in ev if "Launch" in e.name
                    and e.device_type == torch.autograd.DeviceType.CPU)
    return {"wrapper": made, "kept": len(kernels), "launch_calls": len(starts),
            "first_launch_us": round(starts[0], 1) if starts else None,
            "first_kernel_us": round(kernels[0], 1) if kernels else None}


def case_main(name: str) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from kgtpu_torch.ops import gaussian as gauss
    from kgtpu_torch.ops import groupnorm as gn
    gn.build()
    gauss.build()
    first_gn, idle_open, idle_close = CASES[name]
    if first_gn:
        _, _, _, call = cs.gn_shape_call(torch, gn, cs.TIMED_SHAPE)
        call()
        torch.cuda.synchronize()
        r = window(torch, call, lambda: gn.launches, 0.0, 0.0)
        print(json.dumps({"case": name, "kernel": "group_norm", **r}), flush=True)
    kpts, sizes, valid = cs.gaussian_scene(np, torch, 8, 128, 128, 128, [40] * 8, seed=20)
    call = lambda: gauss.render_heatmaps(kpts, sizes, valid, 128, 128)  # noqa: E731
    call()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        r = window(torch, call, lambda: gauss.launches, idle_open, idle_close)
        print(json.dumps({"case": name, "kernel": "gaussian", **r}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 1:
        return case_main(sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("profiler_window_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi.strip()}", flush=True)
    rc = 0
    for name in CASES:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), name],
                           capture_output=True, text=True, timeout=300)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
