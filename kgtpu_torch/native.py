"""The port's compiled host ops: counterpart of `kgtpu/native`.

`csrc/host_ops.cpp` is built with g++ (`ops/_cuda.build(..., host=True)`)
into `kgtpu_torch/_build/` at the first call, never at import, and loaded
with ctypes.  `get_lib()` returns the library with its argtypes set, or None
where it cannot be built (no g++); `error` then says why.  Each op returns
None without the library, and its caller (`data/transforms.py`,
`evaluate.py`) takes its NumPy version, which gives the same results bit for
bit, as kgtpu's callers do.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False
error: str | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def get_lib():
    """ctypes CDLL with argtypes set, or None."""
    global _lib, _tried, error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from kgtpu_torch.ops import _cuda
        try:
            lib = ctypes.CDLL(_cuda.build("host_ops.cpp", host=True))
        except (RuntimeError, OSError) as e:
            error = str(e)
            return None
        c_int = ctypes.c_int
        lib.boxes_from_label_map.argtypes = [
            _I32P, c_int, c_int, c_int, c_int, _F32P, _F32P, _I32P]
        lib.boxes_from_label_map.restype = c_int
        lib.renumber_label_map.argtypes = [_I32P, c_int, c_int, _I32P, c_int, _I32P]
        lib.renumber_label_map.restype = None
        lib.label_map_iou.argtypes = [_I32P, _I32P, c_int, c_int, c_int, c_int, _F32P]
        lib.label_map_iou.restype = None
        _lib = lib
        return _lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def boxes_from_label_map(label, max_instances: int, min_pixels: int = 4):
    """Single-pass `transforms.boxes_from_label_map`: (boxes [N, 4] f32,
    valid [N] f32, remap [N] int32), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    label = _as_i32(label)
    h, w = label.shape
    boxes = np.zeros((max_instances, 4), np.float32)
    valid = np.zeros((max_instances,), np.float32)
    remap = np.zeros((max_instances,), np.int32)
    lib.boxes_from_label_map(label.ctypes.data_as(_I32P), h, w, max_instances, min_pixels,
                             boxes.ctypes.data_as(_F32P), valid.ctypes.data_as(_F32P),
                             remap.ctypes.data_as(_I32P))
    return boxes, valid, remap


def renumber_label_map(label, remap):
    """Single-pass `transforms.renumber_label_map` (int32), or None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    label = _as_i32(label)
    remap = _as_i32(remap)
    out = np.zeros_like(label)
    lib.renumber_label_map(label.ctypes.data_as(_I32P), label.shape[0], label.shape[1],
                           remap.ctypes.data_as(_I32P), len(remap), out.ctypes.data_as(_I32P))
    return out


def label_map_iou(pred, gt):
    """[P, G] f32 IoU matrix between the ids 1..max of two label maps, or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pred = _as_i32(pred)
    gt = _as_i32(gt)
    np_ = int(pred.max())
    ng = int(gt.max())
    iou = np.zeros((max(np_, 0), max(ng, 0)), np.float32)
    if np_ <= 0 or ng <= 0:
        return iou
    lib.label_map_iou(pred.ctypes.data_as(_I32P), gt.ctypes.data_as(_I32P),
                      pred.shape[0], pred.shape[1], np_, ng, iou.ctypes.data_as(_F32P))
    return iou
