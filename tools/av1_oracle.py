"""The libraries cv2 decodes AVIF with, called through ctypes, for tests
and tools only (the port never opens a library):

    LibaomOracle()       libaom 3.14's C reference functions, found by name
                         in the library's symbol table: the transforms
                         (av1_idct4 .. av1_idct64, av1_iadst4 .. 16,
                         av1_iidentity*_c, the 2-D av1_inv_txfm2d_add_WxH_c
                         and the lossless WHT), the deblocking filters
                         (aom_[highbd_]lpf_{horizontal,vertical}_{4,6,8,14}_c)
                         and CDEF's (cdef_find_dir_c, cdef_filter_{8,16}_*_c),
                         loop restoration's (av1_[highbd_]wiener_convolve_
                         add_src_c, av1_apply_selfguided_restoration_c) and
                         superres (av1_[highbd_]convolve_horiz_rs_c and
                         av1_upscale_normative_rows, on a stand-in
                         AV1_COMMON holding the fields it reads)
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
import struct
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


    def wiener(self, src: np.ndarray, hf, vf, bd: int) -> np.ndarray:
        """av1_[highbd_]wiener_convolve_add_src_c on the h x w area at [3, 3]
        of `src` [h + 6, w + 6] with the coded taps hf, vf (3 each,
        outermost first; the centre tap is their -2 x sum, the source added
        at 128): the [h, w] result.  The rounding of get_conv_params_wiener."""
        h, w = src.shape[0] - 6, src.shape[1] - 6
        high = bd > 8
        buf = np.zeros((h + 8, w + 16), np.uint16 if high else np.uint8)
        buf[:h + 6, :w + 6] = src
        dst = np.zeros((h, w), buf.dtype)
        # libaom finds a kernel's table by masking its address to 256 bytes
        # (get_filter_base): the two kernels sit at the start of such a block
        taps = np.zeros(256, np.int16)
        base = (taps.ctypes.data + 255) & ~255
        off = (base - taps.ctypes.data) // 2
        for k, c in enumerate((hf, vf)):
            c = [int(v) for v in c]
            taps[off + 8 * k:off + 8 * k + 8] = c + [-2 * sum(c)] + c[::-1] + [0]
        r0 = 3 + max(0, bd + 7 - 3 + 2 - 16)
        params = (ctypes.c_int * 2)(r0, 14 - r0)
        i, vp = ctypes.c_int, ctypes.c_void_p
        es = buf.itemsize
        at = buf.ctypes.data + (3 * buf.shape[1] + 3) * es
        args = [at >> high, buf.shape[1], dst.ctypes.data >> high, w, base, 16, base + 16, 16, w,
                h, ctypes.addressof(params)]
        types = [vp, ctypes.c_ssize_t, vp, ctypes.c_ssize_t, vp, i, vp, i, i, i, vp]
        name = "av1_wiener_convolve_add_src_c"
        if high:
            name, args, types = "av1_highbd" + name[3:], args + [bd], types + [i]
        self.fn(name, *types)(*args)
        return dst.astype(np.int64)

    def selfguided(self, src: np.ndarray, sgr_set: int, xqd, bd: int) -> np.ndarray:
        """av1_apply_selfguided_restoration_c (which runs
        av1_selfguided_restoration_c) on the h x w area (at most 64 x 64) at
        [3, 3] of `src` [h + 6, w + 6]: the [h, w] result."""
        h, w = src.shape[0] - 6, src.shape[1] - 6
        high = bd > 8
        buf = np.ascontiguousarray(src, np.uint16 if high else np.uint8)
        dst = np.zeros((h, w), buf.dtype)
        tmp = np.zeros(2 * 406 * 390, np.int32)  # 2 x RESTORATION_UNITPELS_MAX
        xq = (ctypes.c_int * 2)(*[int(v) for v in xqd])
        i, vp = ctypes.c_int, ctypes.c_void_p
        f = ctypes.CFUNCTYPE(i, vp, i, i, i, i, vp, vp, i, vp, i, i)(
            self.base + self.lib.syms["av1_apply_selfguided_restoration_c"][0][0])
        at = buf.ctypes.data + (3 * buf.shape[1] + 3) * buf.itemsize
        if f(at >> high, w, h, buf.shape[1], sgr_set, ctypes.addressof(xq),
             dst.ctypes.data >> high, w, tmp.ctypes.data, bd, int(high)):
            raise RuntimeError("av1_apply_selfguided_restoration_c failed")
        return dst.astype(np.int64)

    def convolve_horiz_rs(self, rows: np.ndarray, w: int, x0_qn: int, x_step_qn: int,
                          bd: int) -> np.ndarray:
        """av1_[highbd_]convolve_horiz_rs_c with av1_resize_filter_normative
        on `rows` [h, n] padded by their edge samples (4 each side) and
        handed over one sample left of their start, as libaom's
        upscale_normative_rect does for a lone tile column: [h, w]."""
        high = bd > 8
        buf = np.ascontiguousarray(np.pad(rows, ((0, 0), (4, 4)), mode="edge"),
                                   np.uint16 if high else np.uint8)
        dst = np.zeros((buf.shape[0], w), buf.dtype)
        i, vp = ctypes.c_int, ctypes.c_void_p
        filt = self.base + self.lib.syms["av1_resize_filter_normative"][0][0]
        args = [buf.ctypes.data + 3 * buf.itemsize, buf.shape[1], dst.ctypes.data, w, w,
                buf.shape[0], filt, x0_qn, x_step_qn]
        types = [vp, i, vp, i, i, i, vp, i, i]
        name = "av1_convolve_horiz_rs_c"
        if high:
            name, args, types = "av1_highbd" + name[3:], args + [bd], types + [i]
        self.fn(name, *types)(*args)
        return dst.astype(np.int64)

    def upscale_rows(self, rows: np.ndarray, width: int, upscaled_width: int, denom: int,
                     mi_cols: int, col_starts: list, sb_log2: int, plane: int, ssx: int,
                     bd: int) -> np.ndarray:
        """av1_upscale_normative_rows on the [h, >= (mi_cols * 4) >> ssx]
        rows of one plane of a frame of `width` (FrameWidth) upscaled to
        `upscaled_width` by `denom`, with tile columns starting at the
        superblocks `col_starts` (ending with the column count's end): the
        [h, Round2(upscaled_width, ssx)] rows libaom's decoder writes.  The
        AV1_COMMON and SequenceHeader fields it reads are set at libaom
        3.14's offsets in zeroed buffers (`COMMON_FIELDS`)."""
        high = bd > 8
        dt = np.uint16 if high else np.uint8
        down = (mi_cols * 4) >> (ssx if plane else 0)
        up = (upscaled_width + (ssx if plane else 0)) >> (ssx if plane else 0)
        src = np.zeros((rows.shape[0], down + 32), dt)
        src[:, 16:16 + down] = rows[:, :down]
        dst = np.zeros((rows.shape[0], up + 32), dt)
        cm = ctypes.create_string_buffer(0x6200)
        seq = ctypes.create_string_buffer(0x100)
        put = lambda buf, off, fmt, v: struct.pack_into(fmt, buf, off, v)  # noqa: E731
        put(cm, COMMON_FIELDS["seq_params"], "<Q", ctypes.addressof(seq))
        put(cm, COMMON_FIELDS["width"], "<i", width)
        put(cm, COMMON_FIELDS["superres_upscaled_width"], "<i", upscaled_width)
        put(cm, COMMON_FIELDS["superres_scale_denominator"], "<B", denom)
        put(cm, COMMON_FIELDS["tile_cols"], "<i", len(col_starts) - 1)
        put(cm, COMMON_FIELDS["mi_cols"], "<i", mi_cols)
        for k, v in enumerate(col_starts):
            put(cm, COMMON_FIELDS["tile_col_start_sb"] + 4 * k, "<i", v)
        put(seq, SEQ_FIELDS["mib_size_log2"], "<i", sb_log2)
        put(seq, SEQ_FIELDS["subsampling_x"], "<i", ssx)
        put(seq, SEQ_FIELDS["bit_depth"], "<i", bd)
        put(seq, SEQ_FIELDS["use_highbitdepth"], "<B", int(high))
        es = src.itemsize
        i, vp = ctypes.c_int, ctypes.c_void_p
        self.fn("av1_upscale_normative_rows", vp, vp, i, vp, i, i, i)(
            ctypes.addressof(cm), (src.ctypes.data + 16 * es) >> high, src.shape[1],
            (dst.ctypes.data + 16 * es) >> high, dst.shape[1], plane, rows.shape[0])
        return dst[:, 16:16 + up].astype(np.int64)


# Byte offsets in libaom 3.14's AV1_COMMON / SequenceHeader of the fields
# av1_upscale_normative_rows and av1_tile_set_col read (from their code:
# cm->seq_params, width, superres_upscaled_width, superres_scale_denominator
# (a byte), tiles.cols, tiles.col_start_sb[], mi_params.mi_cols;
# seq_params->mib_size_log2, subsampling_x, bit_depth, use_highbitdepth).
COMMON_FIELDS = {"seq_params": 0x6088, "width": 0x38, "superres_upscaled_width": 0x48,
                 "superres_scale_denominator": 0x50, "tile_cols": 0x60A0,
                 "tile_col_start_sb": 0x60DC, "mi_cols": 0x218}
SEQ_FIELDS = {"mib_size_log2": 0x24, "subsampling_x": 0x60, "bit_depth": 0x48,
              "use_highbitdepth": 0x4C}
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
