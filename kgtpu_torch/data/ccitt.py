"""CCITT bilevel coding in TIFF (compressions 2, 3 and 4), as libtiff 4.7's
`tif_fax3.c` decodes it, in pure Python over a list of bits.

  * 2, modified Huffman (CCITT RLE): every row 1-D coded, no EOL, each row
    starting on a byte boundary;
  * 3, Group 3: each row after an EOL (eleven or more 0 bits and a 1,
    so fill bits before it are skipped); with T4Options bit 0 (2-D) a tag
    bit follows the EOL: 1 for a 1-D row, 0 for a 2-D row;
  * 4, Group 4: every row 2-D, no EOLs;
  * a 2-D row is coded against the row above (a white row above the first
    row of each strip): pass, horizontal and vertical (-3..3) modes, T.4's
    changing elements a0, a1, a2, b1, b2;
  * runs are the T.4 white and black terminating and make-up codes (and the
    extended make-up codes 1792-2560 of both colours); a row's runs start
    white; a black run is 1 bits;
  * FillOrder 2 takes each byte's bits least significant first.
The 0 / 1 samples then read as 1-bit grey (`data/tiff.py`): MinIsWhite or
MinIsBlack.  A stream whose codes do not decode, or whose row lengths do
not add up to the width, raises `UnsupportedImage`: libtiff fills such
rows by rules this port does not reproduce.  So does 32771 (RLEW): libtiff
aligns its rows to 16 bits of its own bit buffer, not of the data, so where
a row starts depends on how far the decoder had read ahead.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import unsupported

_WHITE_TERM = [
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"]
_WHITE_MAKEUP = [
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000", "010011011"]
_BLACK_TERM = [
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"]
_BLACK_MAKEUP = [
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"]
_EXT_MAKEUP = [
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"]
# 2-D modes: pass, horizontal, vertical a1 - b1 = -3..3
MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
         "000010": -2, "0000010": -3}


def _table(term: list[str], makeup: list[str]) -> dict:
    """{(length, code): run} of one colour: terminating 0-63, make-up 64 up."""
    out = {}
    for run, code in enumerate(term):
        out[(len(code), int(code, 2))] = run
    for k, code in enumerate(makeup + _EXT_MAKEUP):
        out[(len(code), int(code, 2))] = 64 * (k + 1)
    return out


RUNS = (_table(_WHITE_TERM, _WHITE_MAKEUP), _table(_BLACK_TERM, _BLACK_MAKEUP))
MODE_CODES = {(len(k), int(k, 2)): v for k, v in MODES.items()}


class _Bits:
    def __init__(self, data: bytes, lsb_first: bool):
        b = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little" if lsb_first
                          else "big")
        self.bits, self.pos = b.tolist(), 0

    def code(self, table: dict, longest: int = 13):
        """The next code of `table`, or raise."""
        v, bits, p = 0, self.bits, self.pos
        for n in range(1, longest + 1):
            if p + n > len(bits):
                break
            v = (v << 1) | bits[p + n - 1]
            hit = table.get((n, v))
            if hit is not None:
                self.pos = p + n
                return hit
        raise unsupported("CCITT data that does not decode (libtiff's recovery is not "
                          "ported)")

    def run(self, color: int) -> int:
        total = 0
        while True:
            r = self.code(RUNS[color])
            total += r
            if r < 64:
                return total

    def eol(self) -> bool:
        """Skip to just after the next EOL (11+ zeros and a 1); False at the
        end of the data."""
        bits, p, zeros = self.bits, self.pos, 0
        while p < len(bits):
            if bits[p]:
                if zeros >= 11:
                    self.pos = p + 1
                    return True
                zeros = 0
            else:
                zeros += 1
            p += 1
        self.pos = p
        return False

    def align(self, n: int) -> None:
        self.pos = -(-self.pos // n) * n


def _row_1d(bits: _Bits, w: int) -> list[int]:
    """Changing elements of a 1-D row."""
    changes, a0, color = [], 0, 0
    while a0 < w:
        a0 += bits.run(color)
        changes.append(a0)
        color ^= 1
    if a0 != w:
        raise unsupported("CCITT row whose runs do not add up to the width")
    return changes


def _row_2d(bits: _Bits, ref: list[int], w: int) -> list[int]:
    """Changing elements of a 2-D row against `ref` (the row above's; the
    colour turns black at even entries, white at odd ones)."""
    changes, a0, color = [], -1, 0
    while a0 < w:
        # b1: the first change on the reference row right of a0 to the
        # colour opposite a0's; b2 the change after it
        i = color
        while i < len(ref) and ref[i] <= a0:
            i += 2
        b1 = ref[i] if i < len(ref) else w
        b2 = ref[i + 1] if i + 1 < len(ref) else w
        mode = bits.code(MODE_CODES, 7)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            a1 = max(a0, 0) + bits.run(color)
            a2 = a1 + bits.run(color ^ 1)
            changes += [a1, a2]
            a0 = a2
        else:
            a0 = b1 + mode
            if a0 < 0 or a0 > w or changes and a0 < changes[-1]:
                raise unsupported("CCITT 2-D code off the row")
            changes.append(a0)
            color ^= 1
    if a0 != w:
        raise unsupported("CCITT row whose runs do not add up to the width")
    return changes


def _fill(changes: list[int], w: int) -> np.ndarray:
    """The row's samples: the colour flips at each change."""
    flips = np.zeros(w + 1, np.uint8)
    np.add.at(flips, np.minimum(changes, w), 1)
    return (np.cumsum(flips[:w]) & 1).astype(np.uint8)


def decode_ccitt(data: bytes, d, rows: int, w: int) -> np.ndarray:
    """One strip or tile of CCITT data -> [rows, w] 0 / 1 samples."""
    comp = d.comp
    bits = _Bits(data, d.get(266)[0] == 2 if 266 in d.tags else False)
    opts = d.tags.get(292, [0])[0] if comp == 3 else 0
    out = np.zeros((rows, w), np.uint8)
    ref: list[int] = []
    for r in range(rows):
        if comp == 2:
            changes = _row_1d(bits, w)
            bits.align(8)
        elif comp == 3:
            if not bits.eol():
                raise unsupported("Group 3 CCITT data that ends early")
            one_d = not opts & 1 or bits.bits[bits.pos] if bits.pos < len(bits.bits) else True
            if opts & 1:
                bits.pos += 1
            changes = _row_1d(bits, w) if one_d else _row_2d(bits, ref, w)
        else:
            changes = _row_2d(bits, ref, w)
        out[r] = _fill(changes, w)
        ref = changes
    return out
