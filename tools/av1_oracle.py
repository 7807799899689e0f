"""The libraries cv2 decodes AVIF with, called through ctypes, for tests
and tools only (the port never opens a library):

    LibaomOracle()       libaom 3.14's C reference functions, found by name
                         in the library's symbol table: the transforms
                         (av1_idct4 .. av1_idct64, av1_iadst4 .. 16,
                         av1_iidentity*_c, the 2-D av1_inv_txfm2d_add_WxH_c
                         and the lossless WHT), the deblocking filters
                         (aom_[highbd_]lpf_{horizontal,vertical}_{4,6,8,14}_c)
                         and CDEF's (cdef_find_dir_c, cdef_filter_{8,16}_*_c)
    avif_planes(data)    what libavif 1.4.2 (cv2's) decodes from an AVIF
                         file before any RGB conversion: the Y, U, V and
                         alpha planes, bit depth, format, range and CICP

The ctypes layouts are those of libaom 3.x and libavif 1.x (`avifImage`'s
first fields).
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from extract_av1_tables import Lib, TX_SIZES, default_lib  # noqa: E402


class LibaomOracle:
    def __init__(self, path: str | None = None):
        self.lib = Lib(path or default_lib())
        self.dl = ctypes.CDLL(self.lib.path)
        self.base = ctypes.cast(self.dl.aom_codec_version, ctypes.c_void_p).value - \
            self.lib.syms["aom_codec_version"][0][0]
        for init in ("av1_rtcd", "aom_dsp_rtcd"):  # fill the SIMD dispatch pointers
            self.fn(init)()

    def fn(self, name: str, *argtypes):
        return ctypes.CFUNCTYPE(None, *argtypes)(self.base + self.lib.syms[name][0][0])

    def tx1d(self, kind: str, x: list) -> list:
        """One 1-D transform ("idct", "iadst", "iidentity") of len(x)
        values, cos_bit 12, without stage clamping."""
        n = len(x)
        name = f"av1_{kind}{n}" + ("_c" if kind == "iidentity" else "")
        f = self.fn(name, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int8, ctypes.c_void_p)
        src = (ctypes.c_int32 * n)(*x)
        dst = (ctypes.c_int32 * n)()
        rng = (ctypes.c_int8 * 16)(*([31] * 16))
        f(ctypes.addressof(src), ctypes.addressof(dst), 12, ctypes.addressof(rng))
        return list(dst)

    def inv_txfm2d_add(self, coeffs: np.ndarray, pred: np.ndarray, tx_type: int,
                       bd: int) -> np.ndarray:
        """av1_inv_txfm2d_add_WxH_c: `coeffs` [h, w] in raster order (the
        top-left 32x32 of a 64-point size), added to `pred` [h, w]."""
        h, w = pred.shape
        cw, ch = min(w, 32), min(h, 32)
        inp = np.zeros(w * h, np.int32)
        inp[:cw * ch] = np.ascontiguousarray(coeffs[:ch, :cw].T).reshape(-1)
        out = np.ascontiguousarray(pred, np.uint16)
        f = self.fn(f"av1_inv_txfm2d_add_{w}x{h}_c", ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int)
        f(inp.ctypes.data, out.ctypes.data, w, tx_type, bd)
        return out.astype(np.int64)

    def iwht4x4_add(self, coeffs: np.ndarray, pred: np.ndarray, bd: int) -> np.ndarray:
        inp = np.ascontiguousarray(coeffs.T.reshape(-1), np.int32)
        out = np.ascontiguousarray(pred, np.uint16)
        f = self.fn("av1_highbd_iwht4x4_16_add_c", ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int)
        f(inp.ctypes.data, out.ctypes.data >> 1, 4, bd)  # CONVERT_TO_BYTEPTR
        return out.astype(np.int64)

    def lpf(self, edge: str, taps: int, lines: np.ndarray, blimit: int, limit: int,
            thresh: int, bd: int) -> np.ndarray:
        """aom_[highbd_]lpf_{edge}_{taps}_c (edge "horizontal" or
        "vertical", taps 4, 6, 8 or 14) on 4 `lines` [4, 16] of samples
        across one edge (p7 .. p0, q0 .. q7): the lines after the call."""
        lines = np.asarray(lines)
        buf = np.ascontiguousarray(lines if edge == "vertical" else lines.T,
                                   np.uint8 if bd == 8 else np.uint16)
        pitch = buf.shape[1]
        at = buf.ctypes.data + (8 if edge == "vertical" else 8 * pitch) * buf.itemsize
        lims = [ctypes.c_uint8(v) for v in (blimit, limit, thresh)]
        args = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
        vals = [at, pitch] + [ctypes.addressof(v) for v in lims]
        name = f"aom_lpf_{edge}_{taps}_c"
        if bd > 8:
            name, args, vals = "aom_highbd" + name[3:], args + [ctypes.c_int], vals + [bd]
        self.fn(name, *args)(*vals)
        return (buf if edge == "vertical" else buf.T).astype(np.int64)

    def cdef_find_dir(self, block: np.ndarray, coeff_shift: int) -> tuple[int, int]:
        """cdef_find_dir_c on an [8, 8] block: (direction, variance)."""
        img = np.ascontiguousarray(block, np.uint16)
        var = ctypes.c_int32()
        f = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int)(self.base + self.lib.syms["cdef_find_dir_c"][0][0])
        d = f(img.ctypes.data, 8, ctypes.addressof(var), coeff_shift)
        return d, var.value

    def cdef_filter(self, variant: int, src: np.ndarray, w: int, h: int, pri: int, sec: int,
                    direction: int, damping: int, coeff_shift: int,
                    high: bool = False) -> np.ndarray:
        """cdef_filter_{8,16}_{variant}_c (0: primary and secondary, 1:
        primary, 2: secondary, 3: copy) of the w x h block at [2, 2] of
        `src` [h + 4, w + 4] (CDEF_VERY_LARGE where a sample is not
        available), laid out at CDEF_BSTRIDE (144) as libaom's CDEF buffer
        is: the [h, w] result, 8- or (`high`) 16-bit."""
        buf = np.zeros((h + 8, CDEF_BSTRIDE), np.uint16)
        buf[2:h + 6, 6:w + 10] = src
        dst = np.zeros((h, w), np.uint16 if high else np.uint8)
        i = ctypes.c_int
        f = self.fn(f"cdef_filter_{16 if high else 8}_{variant}_c", ctypes.c_void_p, i,
                    ctypes.c_void_p, i, i, i, i, i, i, i, i)
        f(dst.ctypes.data, w, buf.ctypes.data + (4 * CDEF_BSTRIDE + 8) * 2, pri, sec, direction,
          damping, damping, coeff_shift, w, h)
        return dst.astype(np.int64)


CDEF_BSTRIDE = 144  # libaom's ALIGN_POWER_OF_TWO(128 + 2 * CDEF_HBORDER, 3)
CDEF_VERY_LARGE = 30000


def libavif_path() -> str:
    import cv2
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs",
                                  "libavif*.so*"))
    if not libs:
        raise SystemExit("no libavif next to cv2")
    return libs[0]


_AVIF = None


def avif_planes(data: bytes) -> dict | None:
    """libavif's decode of `data` (its primary item), or None where
    avifDecoderReadMemory fails: {"y", "u", "v", "a": arrays or None,
    "depth", "format" (avifPixelFormat), "range", "cp", "tc", "mc"}."""
    global _AVIF
    if _AVIF is None:
        _AVIF = ctypes.CDLL(libavif_path())
        _AVIF.avifDecoderCreate.restype = ctypes.c_void_p
        _AVIF.avifImageCreateEmpty.restype = ctypes.c_void_p
        _AVIF.avifDecoderReadMemory.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.c_char_p, ctypes.c_size_t]
        _AVIF.avifDecoderDestroy.argtypes = [ctypes.c_void_p]
        _AVIF.avifImageDestroy.argtypes = [ctypes.c_void_p]
    dec = _AVIF.avifDecoderCreate()
    img = _AVIF.avifImageCreateEmpty()
    try:
        res = _AVIF.avifDecoderReadMemory(dec, img, data, len(data))
        if res != 0:
            return None
        u32 = lambda off: ctypes.c_uint32.from_address(img + off).value  # noqa: E731
        ptr = lambda off: ctypes.c_void_p.from_address(img + off).value  # noqa: E731
        w, h, depth, fmt, rng = u32(0), u32(4), u32(8), u32(12), u32(16)
        dt = np.uint16 if depth > 8 else np.uint8
        es = 2 if depth > 8 else 1
        ssx = fmt in (2, 3)
        ssy = fmt == 3

        def plane(p, rb, pw, ph):
            if not p:
                return None
            buf = (ctypes.c_uint8 * (rb * ph)).from_address(p)
            a = np.frombuffer(bytes(buf), np.uint8).reshape(ph, rb)[:, :pw * es]
            return a.view(dt).copy()

        cw, ch = ((w + ssx) >> ssx, (h + ssy) >> ssy)
        out = {"width": w, "height": h, "depth": depth, "format": fmt, "range": rng,
               "y": plane(ptr(24), u32(48), w, h)}
        if fmt != 4:  # AVIF_PIXEL_FORMAT_YUV400
            out["u"] = plane(ptr(32), u32(52), cw, ch)
            out["v"] = plane(ptr(40), u32(56), cw, ch)
        out["a"] = plane(ptr(64), u32(72), w, h)
        cicp = lambda off: ctypes.c_uint16.from_address(img + off).value  # noqa: E731
        out["cp"], out["tc"], out["mc"] = cicp(104), cicp(106), cicp(108)
        return out
    finally:
        _AVIF.avifImageDestroy(img)
        _AVIF.avifDecoderDestroy(dec)


if __name__ == "__main__":
    o = LibaomOracle()
    print(o.tx1d("idct", [100, 0, 0, 0]), TX_SIZES[:2])
