"""JPEG 2000 Part 2 multi-component markers as OpenJPEG 2.5.3 reads them for
cv2 (`j2k.c`: `opj_j2k_read_mct`, `_mcc`, `_mco`, `_cbd`, `opj_j2k_add_mct`).

cv2's reader refuses a COD whose multiple component transformation is not
0 or 1, so OpenJPEG's custom matrices never run; what reaches the pixels is:

  * MCO resets every component's DC level shift to 0, then (one stage at
    most; more are ignored with a warning, before the reset) applies the
    MCC record it names: if that collection covers every component, its
    offset array (an MCT record) becomes the components' DC level shifts
    (int16 read unsigned, int32 signed, floats truncated toward 0, out of
    range or NaN to INT_MIN), and its decorrelation array is only checked
    for size.  `opj_j2k_add_mct` compares only the first MCC record's index
    with the one named (its loop never advances), so naming a later record
    applies nothing.
  * The level shift is added in 32-bit integers on the 5/3 path (wrapping),
    in 64 bits after lrintf on the 9/7, then clamped.
  * CBD (main header only) replaces each component's precision and sign
    after SIZ: the 9/7 step sizes, the clamp and cv2's output depth follow
    it; the default DC level shift stays SIZ's.

Records live in the main header's state and in each tile's copy of it
(taken when the main header ends); MCT redefines a record of the same
index in place.  Each marker's malformations that OpenJPEG treats as
errors raise `UnreadableImage`; those it only warns about leave the state
as OpenJPEG leaves it.
"""

from __future__ import annotations

import copy
import math
import struct

import numpy as np

from kgtpu_torch.data.imread import UnreadableImage

MCT, MCC, MCO, CBD = 0xFF74, 0xFF75, 0xFF77, 0xFF78
ELEMENT_SIZE = (2, 4, 4, 8)
INT_MIN = -(1 << 31)


class Part2:
    """One tcp's Part 2 state: MCT records by index, MCC records in order,
    each component's DC level shift."""

    def __init__(self, dc: list):
        self.mct: dict = {}                 # index -> {"type", "elem", "data"}
        self.mcc: list = []                 # {"index", "n", "deco", "offset"}
        self.dc = list(dc)

    def copy(self) -> "Part2":
        return copy.deepcopy(self)


def _err(what: str) -> UnreadableImage:
    return UnreadableImage(f"JPEG 2000 {what} marker OpenJPEG cannot read")


def read_mct(st: Part2, seg: bytes) -> None:
    if len(seg) < 2:
        raise _err("MCT")
    if struct.unpack(">H", seg[:2])[0]:
        return                              # Zmct: data over several MCT markers
    if len(seg) <= 6:
        raise _err("MCT")
    imct, ymct = struct.unpack(">HH", seg[2:6])
    rec = st.mct.setdefault(imct & 0xFF, {})
    rec.update(type=(imct >> 8) & 3, elem=(imct >> 10) & 3, data=b"")
    if ymct:
        return                              # the record stays, with no data
    rec["data"] = bytes(seg[6:])


def read_mcc(st: Part2, seg: bytes) -> None:
    if len(seg) < 2:
        raise _err("MCC")
    if struct.unpack(">H", seg[:2])[0]:
        return
    if len(seg) < 7:
        raise _err("MCC")
    idx = seg[2]
    rec = next((r for r in st.mcc if r["index"] == idx), None)
    new = rec is None
    if new:
        rec = {"index": idx, "n": 0, "deco": None, "offset": None}
    ymcc, ncoll = struct.unpack(">HH", seg[3:7])
    if ymcc or ncoll > 1:
        return
    size, at = len(seg) - 7, 7
    for _ in range(ncoll):
        if size < 3:
            raise _err("MCC")
        if seg[at] != 1:
            return                          # not an array-based decorrelation
        (nc,) = struct.unpack(">H", seg[at + 1:at + 3])
        at, size = at + 3, size - 3
        nb, rec["n"] = 1 + (nc >> 15), nc & 0x7FFF
        n = rec["n"]
        if size < nb * n + 2:
            raise _err("MCC")
        size -= nb * n + 2
        for j in range(n):
            if int.from_bytes(seg[at:at + nb], "big") != j:
                return
            at += nb
        (nc,) = struct.unpack(">H", seg[at:at + 2])
        at += 2
        nb = 1 + (nc >> 15)
        if nc & 0x7FFF != n:
            return
        if size < nb * n + 3:
            raise _err("MCC")
        size -= nb * n + 3
        for j in range(n):
            if int.from_bytes(seg[at:at + nb], "big") != j:
                return
            at += nb
        t = int.from_bytes(seg[at:at + 3], "big")
        at += 3
        rec["deco"] = rec["offset"] = None
        for key, i in (("deco", t & 0xFF), ("offset", (t >> 8) & 0xFF)):
            if i:
                if i not in st.mct:
                    raise _err("MCC")
                rec[key] = i
    if size:
        raise _err("MCC")
    if new:
        st.mcc.append(rec)


def _to_int32(rec: dict, n: int) -> list:
    """`j2k_mct_read_functions_to_int32`."""
    fmt = (">H", ">i", ">f", ">d")[rec["elem"]]
    step = ELEMENT_SIZE[rec["elem"]]
    out = []
    for k in range(n):
        (v,) = struct.unpack(fmt, rec["data"][k * step:(k + 1) * step])
        if isinstance(v, float):              # (OPJ_INT32) of a float: cvttss2si
            v = int(v) if math.isfinite(v) and -2 ** 31 <= int(v) < 2 ** 31 else INT_MIN
        out.append(((v + 2 ** 31) % 2 ** 32) - 2 ** 31)
    return out


def read_mco(st: Part2, seg: bytes, ncomp: int) -> None:
    if len(seg) < 1:
        raise _err("MCO")
    stages = seg[0]
    if stages > 1:
        return
    if len(seg) != stages + 1:
        raise _err("MCO")
    st.dc = [0] * ncomp
    for i in seg[1:1 + stages]:
        if not st.mcc or st.mcc[0]["index"] != i:
            continue                        # `opj_j2k_add_mct` looks at the first record only
        rec = st.mcc[0]
        if rec["n"] != ncomp:
            continue
        if rec["deco"] is not None:
            d = st.mct[rec["deco"]]
            if len(d["data"]) != ELEMENT_SIZE[d["elem"]] * ncomp * ncomp:
                raise _err("MCO")
        if rec["offset"] is not None:
            o = st.mct[rec["offset"]]
            if len(o["data"]) != ELEMENT_SIZE[o["elem"]] * ncomp:
                raise _err("MCO")
            st.dc = _to_int32(o, ncomp)


def read_cbd(comps: list, seg: bytes) -> None:
    """Each component's precision and sign, replaced."""
    n = len(comps)
    if len(seg) != n + 2 or struct.unpack(">H", seg[:2])[0] != n:
        raise _err("CBD")
    for c, b in zip(comps, seg[2:]):
        c["sgnd"], c["prec"] = b >> 7, (b & 0x7F) + 1
        if c["prec"] > 31:
            raise _err("CBD")


def level_shift(buf: np.ndarray, dc: int, lo: int, hi: int) -> np.ndarray:
    """`opj_tcd_dc_level_shift_decode`: the 5/3 path adds in int32 (wrapping),
    the 9/7 path rounds (lrintf), adds in int64, and sends values beyond
    the int32 range to the clamp's ends."""
    if buf.dtype == np.float32:
        big = buf > np.float32(2 ** 31)
        small = buf < np.float32(-2 ** 31)
        vals = np.rint(np.where(big | small, 0, buf)).astype(np.int64) + dc
        return np.where(big, hi, np.where(small, lo, np.clip(vals, lo, hi)))
    vals = buf.astype(np.int64) + dc
    vals = ((vals + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    return np.clip(vals, lo, hi)
