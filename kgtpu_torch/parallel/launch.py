"""The ranks of one host: `--ngpus n` starts n processes, rank i on
`cuda:i` (or the CPU), joined at a free localhost port.

`spawn(target, world, args)` runs `target(rank, world, coordinator, *args)`
in `world` fresh processes (the spawn start method: no fork of a process
that holds CUDA or threads) and returns their exit codes in rank order.  A
rank that fails ends the others, so no rank is left waiting in a
collective.  The target must be a module-level function of a module that
imports without side effects: each rank imports it.
"""

from __future__ import annotations

import multiprocessing
import socket
import sys
import time

RESTART = 75                # a rank's exit code: the whole group restarts


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(target, rank: int, world: int, coordinator: str, args: tuple) -> None:
    sys.exit(target(rank, world, coordinator, *args))


def spawn(target, world: int, args: tuple = (), timeout_s: float | None = None) -> list[int]:
    """Exit codes of `world` ranks of `target`; the first rank to fail (an
    exit code other than 0 and RESTART) ends the others, and so does the
    timeout."""
    ctx = multiprocessing.get_context("spawn")
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_entry, args=(target, r, world, coordinator, args),
                         name=f"rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0, RESTART) for p in procs)
            if failed or (deadline is not None and time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]
