"""Data-dependent control flow in the two forms the port runs it: a host
loop or branch (eager serving), or `torch.export`'s while_loop and cond
operators (the traced forms, `traced=True` in `infer.py`), counterparts of
kgtpu's lax.while_loop and lax.cond.

The traced forms call the higher-order operators themselves, with every
tensor a body reads passed in as an operand: `torch.cond` and
`torch._higher_order_ops.while_loop` would trace their bodies with dynamo,
which costs ~16 s per export of the tiny test model on a CPU, where tracing
the operators with explicit operands costs under 1 s.  Eagerly the operators
run their bodies on the host, so the traced forms also run (and are tested)
outside an export.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op

# Rounds run between two checks for live entries.
ROUNDS_PER_CHECK = 4


def run_rounds(step: Callable, live: torch.Tensor, out: torch.Tensor, max_rounds: int,
               traced: bool, operands: tuple = ()) -> torch.Tensor:
    """Apply `step(live, out, *operands) -> (live, out)` until no entry of
    `live` is set (at most `max_rounds` rounds, which must suffice) and
    return `out`.  `step` reads no tensor but its arguments.

    The host form checks `live` every ROUNDS_PER_CHECK rounds; the traced
    form is a while_loop whose body runs ROUNDS_PER_CHECK rounds.  Both give
    the same `out`, as a round with no live entry changes nothing."""
    if not traced:
        for r in range(max_rounds):
            if r % ROUNDS_PER_CHECK == 0 and not bool(live.any()):
                break
            live, out = step(live, out, *operands)
        return out

    def cond(r, live, out, *operands):
        return live.any() & (r < max_rounds)

    def body(r, live, out, *operands):
        for _ in range(ROUNDS_PER_CHECK):
            live, out = step(live, out, *operands)
        return r + ROUNDS_PER_CHECK, live, out

    r0 = torch.zeros((), dtype=torch.int64, device=live.device)
    return while_loop_op(cond, body, (r0, live, out), tuple(operands))[2]


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         operands: tuple) -> object:
    """`true_fn(*operands)` where the 0-d bool `pred` is set, else
    `false_fn(*operands)`, as the cond operator (traceable).  The branches
    read no tensor but the operands, and return new tensors of equal
    metadata (no operand itself)."""
    return cond_op(pred, true_fn, false_fn, tuple(operands))
