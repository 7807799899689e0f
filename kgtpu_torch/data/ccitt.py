"""CCITT bilevel coding in TIFF (compressions 2, 3, 4 and 32771), decoded
as libtiff 4.7's `tif_fax3.c` / `tif_fax3.h` decode it, state for state, in
pure Python:

  * 2, modified Huffman (CCITT RLE), and 32771 (RLEW): every row 1-D coded,
    no EOL; after each row libtiff drops the bits left in its bit buffer
    down to a multiple of 8 (RLE) or 16 (RLEW), and for RLEW, with none
    left, a byte at an odd address (`Fax3DecodeRLE`): so where a row starts
    depends on how far the decoder had read ahead (`NeedBits8` /
    `NeedBits16` refill a byte or two at a time), which this module models;
  * 3, Group 3: each row after an EOL (`SYNC_EOL` skips to eleven 0 bits,
    whole 0 bytes, 0 bits and the 1); with T4Options bit 0 (2-D) a tag bit
    follows: 1 for a 1-D row, 0 for a 2-D row;
  * 4, Group 4: every row 2-D, no EOLs; an EOL (the EOFB) ends the strip;
  * a 2-D row is coded against the runs of the row above (a white row above
    the first row of each strip): pass, horizontal and vertical (-3..3)
    modes, over libtiff's arrays of alternating white / black run lengths;
  * codes are looked up in libtiff's tables (12 bits white, 13 black, 7 the
    2-D modes, built here as `mkg3states.c` builds them); FillOrder 2 takes
    each byte's bits least significant first.

libtiff's recovery is followed: a code that is in no table
(`Fax3Unexpected`) ends the row there; a row whose runs do not add up to
the width (`Fax3BadLength`) is cut, or filled white to the end
(`CLEANUP_RUNS`); the data ending inside a row (`Fax3PrematureEOF`) fills
that row so and leaves the rows after it 0, and the strip's read fails
(Group 4, RLE, or Group 3 in the strip's last row: libtiff 4.7.1's Group 3
decoders read on past the end of the data into the rows after, which this
port does not reproduce, so there it raises `UnsupportedImage`); Group 3
resynchronises on the next EOL, and the runs of a damaged row,
as `CLEANUP_RUNS` and `_TIFFFax3fillruns` leave them, are the next 2-D
row's reference.  The 0 / 1 samples then read as 1-bit grey
(`data/tiff.py`): MinIsWhite or MinIsBlack.
"""

from __future__ import annotations

import numpy as np

import functools

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
_S_NULL, _S_PASS, _S_HORIZ, _S_V0, _S_VR, _S_VL, _S_EXT, _S_TERMW, _S_TERMB, _S_MAKEUPW, \
    _S_MAKEUPB, _S_MAKEUP, _S_EOL = range(13)


def _fill_table(table: list, width: int, codes, state: int) -> None:
    """mkg3states.c's FillTable: every `width`-bit index whose low bits are
    a code (bits in reading order from the least significant) gets
    (state, code length, parameter)."""
    for code, param in codes:
        n = len(code)
        rev = int(code[::-1], 2) if n else 0
        for i in range(rev, 1 << width, 1 << n):
            table[i] = (state, n, param)


@functools.lru_cache(maxsize=1)
def tables() -> tuple[list, list, list]:
    """libtiff's TIFFFaxMainTable (7 bits), TIFFFaxWhiteTable (12) and
    TIFFFaxBlackTable (13)."""
    main = [(_S_NULL, 0, 0)] * 128
    _fill_table(main, 7, [("0001", 0)], _S_PASS)
    _fill_table(main, 7, [("001", 0)], _S_HORIZ)
    _fill_table(main, 7, [("1", 0)], _S_V0)
    _fill_table(main, 7, [("011", 1), ("000011", 2), ("0000011", 3)], _S_VR)
    _fill_table(main, 7, [("010", 1), ("000010", 2), ("0000010", 3)], _S_VL)
    _fill_table(main, 7, [("0000001", 0)], _S_EXT)
    _fill_table(main, 7, [("0000000", 0)], _S_EOL)
    ext = [(c, 64 * (28 + k)) for k, c in enumerate(_EXT_MAKEUP)]
    white = [(_S_NULL, 0, 0)] * 4096
    _fill_table(white, 12, [(c, 64 * (k + 1)) for k, c in enumerate(_WHITE_MAKEUP)], _S_MAKEUPW)
    _fill_table(white, 12, ext, _S_MAKEUP)
    _fill_table(white, 12, [(c, k) for k, c in enumerate(_WHITE_TERM)], _S_TERMW)
    _fill_table(white, 12, [("00000000000", 0)], _S_EOL)
    black = [(_S_NULL, 0, 0)] * 8192
    _fill_table(black, 13, [(c, 64 * (k + 1)) for k, c in enumerate(_BLACK_MAKEUP)], _S_MAKEUPB)
    _fill_table(black, 13, ext, _S_MAKEUP)
    _fill_table(black, 13, [(c, k) for k, c in enumerate(_BLACK_TERM)], _S_TERMB)
    _fill_table(black, 13, [("00000000000", 0)], _S_EOL)
    return main, white, black


class _EOF(Exception):
    """The data ran out where libtiff's NeedBits found no bit left."""


class _Overflow(Exception):
    """More runs than libtiff's run arrays hold: the decode stops there."""


class _Fax:
    """libtiff's decoder state over one strip or tile: the bit buffer
    (BitAcc, BitsAvail, LSB first), the read position and the run arrays."""

    def __init__(self, data: bytes, lsb_first: bool, lastx: int, two_d: bool):
        self.data = data if lsb_first else bytes(_REVERSE[b] for b in data)
        self.cp, self.acc, self.avail = 0, 0, 0
        self.lastx = lastx
        self.nruns = -(-(lastx + 1) // 32) * 32 * (2 if two_d else 1)
        self.eolcnt = 0

    def need(self, n: int, two: bool) -> None:
        """NeedBits8 (`two` False) / NeedBits16."""
        if self.avail >= n:
            return
        if self.cp >= len(self.data):
            if self.avail == 0:
                raise _EOF
            self.avail = n
            return
        self.acc |= self.data[self.cp] << self.avail
        self.cp += 1
        self.avail += 8
        if two and self.avail < n:
            if self.cp >= len(self.data):
                self.avail = n
            else:
                self.acc |= self.data[self.cp] << self.avail
                self.cp += 1
                self.avail += 8

    def bits(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, width: int, table: list, two: bool) -> tuple:
        self.need(width, two)
        ent = table[self.bits(width)]
        self.clr(ent[1])
        return ent

    def sync_eol(self) -> None:
        if self.eolcnt == 0:
            while True:
                self.need(11, True)
                if self.bits(11) == 0:
                    break
                self.clr(1)
        while True:
            self.need(8, False)
            if self.bits(8):
                break
            self.clr(8)
        while self.bits(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0


_REVERSE = [int(f"{b:08b}"[::-1], 2) for b in range(256)]


class _Row:
    """One row's runs as EXPAND1D / EXPAND2D write them into libtiff's run
    array `cur` (nruns entries, reused from row to row: what lies past
    `pa` is left from earlier rows, as in libtiff)."""

    def __init__(self, fax: _Fax, cur: list):
        self.fax, self.cur, self.pa, self.a0, self.rl = fax, cur, 0, 0, 0

    def set(self, x: int) -> None:                      # SETVALUE
        if self.pa >= self.fax.nruns:
            raise _Overflow
        self.cur[self.pa] = self.rl + x
        self.pa += 1
        self.a0 += x
        self.rl = 0

    def cleanup(self) -> None:                          # CLEANUP_RUNS
        lastx = self.fax.lastx
        if self.rl:
            self.set(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 -= self.cur[self.pa]
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.set(0)
                self.set(lastx - self.a0)
            elif self.a0 > lastx:
                self.set(lastx)
                self.set(0)

    def run(self, color: int, one_d: bool) -> bool:
        """One white or black run, make-up codes and all; False where the
        code is an EOL (EXPAND1D counts it) or in no table (the row ends)."""
        _, white, black = tables()
        fax = self.fax
        while True:
            if color:
                state, _, param = fax.lookup(13, black, True)
            else:
                state, _, param = fax.lookup(12, white, True)
            if state == (_S_TERMB if color else _S_TERMW):
                self.set(param)
                return True
            if state == _S_MAKEUP or state == (_S_MAKEUPB if color else _S_MAKEUPW):
                self.a0 += param
                self.rl += param
                continue
            if state == _S_EOL and one_d:
                fax.eolcnt = 1
            return False

    def expand_1d(self) -> None:                        # EXPAND1D
        lastx = self.fax.lastx
        try:
            while True:
                if not self.run(0, True) or self.a0 >= lastx:
                    break
                if not self.run(1, True) or self.a0 >= lastx:
                    break
                if self.cur[self.pa - 1] == 0 and self.cur[self.pa - 2] == 0:
                    self.pa -= 2
        except _EOF:
            self.cleanup()
            raise
        self.cleanup()

    def expand_2d(self, ref: list) -> None:             # EXPAND2D
        fax, lastx, nruns = self.fax, self.fax.lastx, self.fax.nruns
        main = tables()[0]
        pb = 1
        b1 = ref[0]

        def check_b1():
            nonlocal b1, pb
            if self.pa:
                while b1 <= self.a0 and b1 < lastx:
                    if pb + 1 >= nruns:
                        raise _Overflow
                    b1 += ref[pb] + ref[pb + 1]
                    pb += 2
        try:
            while self.a0 < lastx:
                if self.pa >= nruns:
                    raise _Overflow
                state, _, param = fax.lookup(7, main, False)
                if state == _S_PASS:
                    check_b1()
                    if pb + 1 >= nruns:
                        raise _Overflow
                    b1 += ref[pb]
                    self.rl += b1 - self.a0
                    self.a0 = b1
                    b1 += ref[pb + 1]
                    pb += 2
                elif state == _S_HORIZ:
                    first = self.pa & 1
                    if not self.run(first, False) or not self.run(first ^ 1, False):
                        break                       # Fax3Unexpected
                    check_b1()
                elif state in (_S_V0, _S_VR):
                    check_b1()
                    self.set(b1 - self.a0 + (param if state == _S_VR else 0))
                    if pb >= nruns:
                        raise _Overflow
                    b1 += ref[pb]
                    pb += 1
                elif state == _S_VL:
                    check_b1()
                    if b1 < self.a0 + param:
                        break                       # Fax3Unexpected
                    self.set(b1 - self.a0 - param)
                    pb -= 1
                    b1 -= ref[pb]
                elif state in (_S_EXT, _S_EOL):
                    self.cur[self.pa] = lastx - self.a0
                    self.pa += 1
                    if state == _S_EOL:
                        fax.need(4, False)
                        fax.clr(4)
                        fax.eolcnt = 1
                    break
                else:
                    break                           # Fax3Unexpected
            else:
                if self.rl:
                    if self.rl + self.a0 < lastx:
                        fax.need(1, False)
                        if not fax.bits(1):
                            self.cleanup()
                            return
                        fax.clr(1)
                    self.set(0)
        except _EOF:
            self.cleanup()
            raise
        self.cleanup()

    def fill(self) -> np.ndarray:
        """_TIFFFax3fillruns: the row's samples (white runs 0, black 1); runs
        past the width are cut to it in the array, and a 0 is added after
        an odd count."""
        lastx, cur = self.fax.lastx, self.cur
        n = self.pa
        if n & 1:
            cur[n] = 0
            n += 1
        row = np.zeros(lastx, np.uint8)
        x = 0
        for j in range(n):
            run = cur[j]
            if x + run > lastx or run > lastx:
                run = cur[j] = lastx - x
            if run and j & 1:
                row[x:x + run] = 1
            x += run
        return row


def decode_ccitt(data: bytes, d, rows: int, w: int, offset: int = 0) -> tuple[np.ndarray, bool]:
    """One strip or tile of CCITT data -> [rows, w] 0 / 1 samples, and
    whether libtiff's decoder succeeded (rows it did not reach are 0).
    `offset`: the data's offset in the file, whose parity RLEW's alignment
    reads.  The run arrays live on `d`, as libtiff keeps them for the
    file."""
    comp = d.comp
    lsb = d.get(266)[0] == 2 if 266 in d.tags else False
    two_d = bool(comp == 4 or comp == 3 and d.tags.get(292, [0])[0] & 1)
    fax = _Fax(data, lsb, w, two_d)
    arrays = getattr(d, "fax_runs", None)
    if arrays is None:
        arrays = d.fax_runs = [[0] * (fax.nruns + 1), [0] * (fax.nruns + 1)]
    cur, ref = arrays                       # Fax3PreDecode: a white row above
    ref[0], ref[1] = w, 0
    out = np.zeros((rows, w), np.uint8)
    for r in range(rows):
        row = _Row(fax, cur)
        try:
            if comp in (2, 32771):
                row.expand_1d()
            elif comp == 4:
                row.expand_2d(ref)
            else:
                try:
                    fax.sync_eol()
                    fax.need(1, False)
                except _EOF:
                    row.cleanup()
                    raise
                one_d = fax.bits(1) if two_d else 1
                if two_d:
                    fax.clr(1)
                if one_d:
                    row.expand_1d()
                else:
                    row.expand_2d(ref)
        except _EOF:
            if comp == 3 and r < rows - 1:
                # libtiff 4.7.1's Group 3 decoders read on past the end of
                # the strip's data into rows this port does not reproduce
                raise unsupported("Group 3 CCITT data that ends before its strip's last row")
            out[r] = row.fill()
            return out, False
        except _Overflow:
            return out, False
        out[r] = row.fill()
        if comp == 4 and fax.eolcnt:            # an EOFB: the strip ends
            return out, True
        if comp in (2, 32771):
            fax.clr(fax.avail % (8 if comp == 2 else 16))
            if comp == 32771 and fax.avail == 0 and (offset + fax.cp) & 1:
                fax.cp += 1
        elif two_d:
            if row.pa < fax.nruns:              # the imaginary change for reference
                cur[row.pa] = 0
            cur, ref = ref, cur
    return out, True
