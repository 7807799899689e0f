"""Host-process self-monitoring: RSS tracking and a restart that resumes.
Counterpart of `kgtpu/utils/host.py`.

A long training run whose host memory grows (a leaking transport, a
fragmenting allocator) is OOM-killed mid-schedule unless it restarts first.
`cli/train.py` checks the host RSS at every epoch boundary but the last
and, past a limit, flushes a checkpoint and re-execs itself with
``--resume``: the fresh process starts with a clean heap and continues the
same schedule with no epoch lost.
"""

from __future__ import annotations

import os
import sys

__all__ = ["host_rss_gb", "default_rss_limit_gb", "restart_argv", "reexec"]


def host_rss_gb() -> float:
    """Current resident-set size of this process, in GB (decimal); 0 where
    /proc is not there (the watchdog then never fires)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, IndexError, ValueError):
        return 0.0


def default_rss_limit_gb() -> float:
    """75% of MemTotal, in GB: past this, an epoch-boundary restart is
    cheaper than the OOM killer mid-epoch.  0 (the watchdog off) where the
    total is unknown."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 * 0.75 / 1e9
    except (OSError, IndexError, ValueError):
        pass
    return 0.0


def restart_argv(argv: list[str]) -> list[str]:
    """argv for the re-exec'd process: the same run, resuming.

    Ensures exactly one bare ``--resume`` (resume the latest checkpoint of
    --save_dir); an explicit ``--resume <path>`` is rewritten to the bare
    form, because the checkpoint written just before the restart supersedes
    the original source."""
    out, skip = [], False
    for a in argv:
        if skip:                      # the value of a preceding --resume
            skip = False
            if not a.startswith("-"):
                continue
        if a == "--resume":
            skip = True
            continue
        if a.startswith("--resume="):
            continue
        out.append(a)
    return out + ["--resume"]


def reexec(argv: list[str]) -> None:
    """Replace this process with a fresh interpreter running `argv` (the
    arguments after the interpreter: a script or ``-m module``, then its
    flags)."""
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable] + argv)
