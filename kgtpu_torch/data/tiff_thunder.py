"""ThunderScan-compressed TIFF (compression 32809), decoded as libtiff 4.7's
`tif_thunder.c` decodes it: 4-bit samples, each row coded on its own from
bytes whose two high bits pick the code:

  * 00: a run of the last pixel, the count in the low six bits (with
    libtiff's handling of a run that starts on an odd pixel: the byte it
    completes is what the run repeats);
  * 01: three 2-bit deltas from the last pixel (0, +1, skip, -1);
  * 10: two 3-bit deltas (0..3, skip, -3..-1);
  * 11: a raw pixel, the low four bits.

A row that ends short or long fails libtiff's ThunderDecode: what it wrote
is kept, the rest of the row is zero and the strip's later rows are not
decoded (0).  libtiff reads only 4-bit data so, of which cv2 reads the
palette kind (its grey is refused, as any 4-bit grey).
"""

from __future__ import annotations

_TWO = (0, 1, 0, -1)
_THREE = (0, 1, 2, 3, 0, -3, -2, -1)


def decode_thunder(data: bytes, rows: int, w: int) -> tuple[bytes, bool]:
    """One strip of `rows` rows of `w` pixels -> the packed 4-bit rows
    (ceil(w / 2) bytes each) and whether libtiff's decoder succeeded."""
    rowbytes = (w + 1) // 2
    buf = bytearray(rows * rowbytes + 1)
    bp, cc = 0, len(data)
    for r in range(rows):
        op0 = op = r * rowbytes
        last = npixels = 0

        def setpixel(v: int) -> None:
            nonlocal last, npixels, op
            last = v & 15
            if npixels < w:
                if npixels & 1:
                    buf[op] |= last
                    op += 1
                else:
                    buf[op] = last << 4
                npixels += 1
        while cc > 0 and npixels < w:
            n = data[bp]
            bp += 1
            cc -= 1
            code = n & 0xC0
            if code == 0x00:                    # a run of the last pixel
                n &= 0x3F
                if npixels & 1:
                    buf[op] |= last
                    last = buf[op]
                    op += 1
                    npixels += 1
                    n -= 1
                else:
                    last |= last << 4
                npixels += n
                if npixels <= w:
                    while n > 0:
                        buf[op] = last & 0xFF
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    buf[op] &= 0xF0
                last &= 15
            elif code == 0x40:
                for shift in (4, 2, 0):
                    delta = (n >> shift) & 3
                    if delta != 2:
                        setpixel(last + _TWO[delta])
            elif code == 0x80:
                for shift in (3, 0):
                    delta = (n >> shift) & 7
                    if delta != 4:
                        setpixel(last + _THREE[delta])
            else:
                setpixel(n)
        if npixels != w:
            end = op0 + (w + 1) // 2
            buf[op:end] = bytes(max(end - op, 0))
            return bytes(buf[:rows * rowbytes]), False
    return bytes(buf[:rows * rowbytes]), True

