"""Numerics debugging: counterpart of `kgtpu/utils/debug.py`.

The failure modes that matter are NaN propagation and out-of-range gathers.
  * `enable_nan_debugging()` is the port's `jax_debug_nans`: a dispatch mode
    checks every floating output of every aten op (and of the port's custom
    ops) that computes, and raises FloatingPointError at the first op that
    produced a NaN, naming it (allocations, views, copies and casts pass a
    NaN on and are not checked); autograd's anomaly mode does the same for the backward and
    names the forward op whose gradient went NaN.  The check synchronises
    with the device after each op, so it is for debugging only.
    `disable_nan_debugging()` turns both off again.
  * `checked(fn)` is checkify with `index_checks | nan_checks`: it returns
    g(*args) -> (error, out), where `error.throw()` raises if an op inside
    fn indexed out of range (IndexError; the op then ran on the clamped
    indices, as XLA clamps them) or produced a NaN (FloatingPointError).

PyTorch runs eagerly, so `disable_jit` has nothing to turn off: the op that
produced the NaN is always the one reported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_nan_mode = None


# Ops that allocate, alias, copy or cast a tensor without computing on it:
# an allocation's bytes may read as NaN until written, and the others pass a
# NaN on from their input rather than produce one.
_NOT_COMPUTED = ("empty", "new_empty", "resize", "set_", "copy_", "_to_copy", "clone",
                 "lift_fresh", "lift_fresh_copy", "detach", "alias", "_copy_from")


def _not_computed(func) -> bool:
    """True for an op the NaN checks skip (see _NOT_COMPUTED) and for views."""
    name = func.overloadpacket.__name__
    return func.is_view or name == "copy" or name.startswith(_NOT_COMPUTED)


def _has_nan(out) -> bool:
    for t in tree_flatten(out)[0]:
        if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                and t.numel() and bool(torch.isnan(t).any())):
            return True
    return False


class _NanMode(TorchDispatchMode):
    """Raises FloatingPointError at the first op whose output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _not_computed(func) and _has_nan(out):
            raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


def enable_nan_debugging(disable_jit: bool = False) -> None:
    """Raise FloatingPointError at the first op that produces a NaN, on this
    thread, forward and backward (see the module note)."""
    global _nan_mode
    if _nan_mode is None:
        _nan_mode = _NanMode()
        _nan_mode.__enter__()
    torch.autograd.set_detect_anomaly(True)


def disable_nan_debugging() -> None:
    """Undo `enable_nan_debugging`."""
    global _nan_mode
    if _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
    torch.autograd.set_detect_anomaly(False)


class CheckError:
    """The first error `checked` saw, or none."""

    def __init__(self):
        self.error: Exception | None = None

    def get(self) -> str | None:
        return None if self.error is None else str(self.error)

    def throw(self) -> None:
        if self.error is not None:
            raise self.error


def _bounds(func, args) -> list[tuple[torch.Tensor, int, bool]]:
    """(index tensor, size of the dim it indexes, negative indices allowed)
    of an indexing op's indices."""
    a = torch.ops.aten
    base = func.overloadpacket
    if base in _LIST_INDEXED:
        src, idx = args[0], args[1]
        return [(i, src.shape[d], True) for d, i in enumerate(idx)
                if i is not None and i.dtype not in (torch.bool, torch.uint8)]
    if base in (a.gather, a.scatter, a.scatter_, a.scatter_add, a.scatter_add_,
                a.index_select, a.index_add, a.index_add_):
        return [(args[2], args[0].shape[args[1]], False)]
    return []


_LIST_INDEXED = (torch.ops.aten.index, torch.ops.aten.index_put, torch.ops.aten.index_put_)


class _CheckMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.error = CheckError()

    def _record(self, exc: Exception) -> None:
        if self.error.error is None:
            self.error.error = exc

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args = list(args)
        for idx, n, neg in _bounds(func, args):
            lo = -n if neg else 0
            if idx.numel() and bool(((idx < lo) | (idx >= n)).any()):
                self._record(IndexError(
                    f"out-of-bounds index in {func}: indices must lie in "
                    f"[{lo}, {n}), got [{int(idx.min())}, {int(idx.max())}]"))
                fixed = idx.clamp(lo, n - 1)
                if func.overloadpacket in _LIST_INDEXED:
                    args[1] = [fixed if i is idx else i for i in args[1]]
                else:
                    args[2] = fixed
        out = func(*args, **(kwargs or {}))
        if not _not_computed(func) and _has_nan(out):
            self._record(FloatingPointError(f"nan generated by {func}"))
        return out


def checked(fn: Callable) -> Callable:
    """Returns g(*args) -> (error, out); call error.throw() to raise."""

    def g(*args, **kwargs):
        mode = _CheckMode()
        with mode:
            out = fn(*args, **kwargs)
        return mode.error, out

    return g
