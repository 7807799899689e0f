"""The AV1 symbol decoder (specification section 8.2), as libaom's
`od_ec_dec` runs it: a 64-bit window refilled a byte at a time, CDFs held
inverted (32768 - the specification's values, libaom's AOM_ICDF form) as
Python lists [icdf_0 .. icdf_{n-1} (= 0), counter].

`SymbolReader(data, start, end, disable_update)` decodes one tile's bytes
data[start:end].  libaom marks a tile corrupt ("Failed to decode tile
data"; cv2's imread then returns None) when, after any superblock, more
bytes have been consumed than the tile holds (`overflowed`), and at the
tile's end unless the padding is the specification's: the bit after the
last one read is 1, the rest of its byte and every later byte of the tile
0 (`trailing_ok`).
"""

from __future__ import annotations

WINDOW = 64
LOTS_OF_BITS = 0x4000


def icdf(cdf: list) -> list:
    """A specification-form CDF (cumulative values, then the counter) in the
    inverted form the reader adapts in place."""
    return [32768 - v for v in cdf[:-1]] + [0]


class SymbolReader:
    """One tile's symbol decoder: `symbol(cdf)`, `bool()`, `literal(n)`;
    the decoder state lives in the closures these are (the hot path reads
    and writes it as local variables, not attributes)."""

    def __init__(self, data: bytes, start: int, end: int, disable_update: bool = False):
        self.buf = data
        self.start = start
        self.end = end
        update = not disable_update
        dif = (1 << (WINDOW - 1)) - 1
        rng = 0x8000
        cnt = -15
        pos = start
        consumed = 1  # libaom's aom_reader_tell of a fresh decoder

        def refill():
            nonlocal dif, cnt, pos
            s = WINDOW - 9 - (cnt + 15)
            while s >= 0 and pos < end:
                dif ^= data[pos] << s
                pos += 1
                cnt += 8
                s -= 8
            if pos >= end:
                cnt = LOTS_OF_BITS

        def symbol(cdf: list) -> int:
            """read_symbol (section 8.2.6) with the CDF update."""
            nonlocal dif, rng, cnt, consumed
            n = len(cdf) - 1
            r = rng
            c = dif >> 48
            r8 = r >> 8
            v = r
            ret = -1
            m = 4 * n
            while True:
                ret += 1
                m -= 4
                u = v
                v = ((r8 * (cdf[ret] >> 6)) >> 1) + m
                if c >= v:
                    break
            r = u - v
            d = 16 - r.bit_length()
            rng = r << d
            dif = (((dif - (v << 48)) + 1) << d) - 1
            consumed += d
            cnt -= d
            if cnt < 0:
                refill()
            if update:
                count = cdf[n]
                rate = (3 if n == 2 else 4 if n == 3 else 5) + (count > 15) + (count > 31) + \
                    (n == 2)
                for i in range(ret):
                    cdf[i] += (32768 - cdf[i]) >> rate
                for i in range(ret, n - 1):
                    cdf[i] -= cdf[i] >> rate
                if count < 32:
                    cdf[n] = count + 1
            return ret

        def read_bool() -> int:
            """read_bool (section 8.2.3): an equiprobable bit."""
            nonlocal dif, rng, cnt, consumed
            r = rng
            v = ((r >> 8) << 7) + 4
            vw = v << 48
            if dif >= vw:
                r -= v
                dif -= vw
                ret = 0
            else:
                r = v
                ret = 1
            d = 16 - r.bit_length()
            rng = r << d
            dif = ((dif + 1) << d) - 1
            consumed += d
            cnt -= d
            if cnt < 0:
                refill()
            return ret

        def literal(n: int) -> int:
            """read_literal (section 8.2.5): n bits, most significant first."""
            x = 0
            for _ in range(n):
                x = (x << 1) | read_bool()
            return x

        def tell() -> int:
            return consumed

        refill()
        self.symbol, self.bool, self.literal, self._tell = symbol, read_bool, literal, tell

    def overflowed(self) -> bool:
        """aom_reader_has_overflowed."""
        return (self._tell() + 7) >> 3 > self.end - self.start

    def trailing_ok(self) -> bool:
        """check_trailing_bits_after_symbol_coder: the padding of section
        8.2.4 (exit_symbol) that libaom requires."""
        if self.overflowed():
            return False
        nb = self._tell()
        at = self.start + ((nb + 7) >> 3)
        pattern = 128 >> ((nb - 1) & 7)
        if self.buf[at - 1] & (2 * pattern - 1) != pattern:
            return False
        return not any(self.buf[at:self.end])
