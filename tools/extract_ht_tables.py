#!/usr/bin/env python
"""Write `kgtpu_torch/data/j2k_ht_tables.py`: the two CxtVLC decode tables
of ITU-T T.814 (HTJ2K) as OpenJPEG 2.5 lays them out, read from a
libopenjp2 shared library (by default the one PIL bundles):

    python tools/extract_ht_tables.py [--lib PATH] [--out PATH]

The tables are found through the code of `opj_t1_ht_decode_cblk` (its
RIP-relative `lea` instructions into .rodata), not at fixed offsets: the
two targets that hold 1024 well-formed 16-bit entries each, in the order
the function first uses them (the initial quad row's table, then the
others').  Each entry, indexed by (context << 7) | the next 7 bits of the
VLC stream, packs the codeword length (bits 0-2), u_off (3), the
significance pattern rho (4-7), e_1 (8-11) and e_k (12-15).  Checked
before anything is written: every non-zero entry has a length of 1 to 7;
the 2^(7 - length) indices that share a codeword's bits hold the same
entry; e_1 marks no sample outside e_k, and both only samples in rho;
context 0 has no codeword for rho = 0 (the MEL codes that case) while
every other context has one; and each table's (context, codeword) pairs
form a prefix code.  The port never opens a library: it reads the
literals this tool writes.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMBOL = b"opj_t1_ht_decode_cblk"


def default_lib() -> str:
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                  "libopenjp2*.so*"))
    if not libs:
        raise SystemExit("no libopenjp2 next to PIL; pass --lib")
    return libs[0]


def sections(elf: bytes) -> dict:
    """name -> (addr, offset, size) of a 64-bit little-endian ELF file."""
    if elf[:4] != b"\x7fELF" or elf[4] != 2 or elf[5] != 1:
        raise SystemExit("not a 64-bit little-endian ELF file")
    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", elf, 0x3A)
    heads = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + k * shentsize) for k in range(shnum)]
    names = heads[shstrndx][4]
    out = {}
    for h in heads:
        end = elf.index(b"\0", names + h[0])
        out[elf[names + h[0]:end].decode()] = (h[3], h[4], h[5])
    return out


def symbol(elf: bytes, secs: dict, name: bytes) -> tuple[int, int]:
    """(address, size) of a dynamic symbol."""
    _, symoff, symsize = secs[".dynsym"]
    _, stroff, _ = secs[".dynstr"]
    for k in range(0, symsize, 24):
        st_name, _, _, _, value, size = struct.unpack_from("<IBBHQQ", elf, symoff + k)
        if elf[stroff + st_name:stroff + st_name + len(name) + 1] == name + b"\0":
            return value, size
    raise SystemExit(f"{name.decode()} is not exported")


def rip_lea_targets(code: bytes, base: int) -> list[int]:
    """Targets of `lea disp32(%rip), %r64` (REX.W 8D, mod 00, r/m 101), in
    the order they appear."""
    out = []
    for i in range(len(code) - 7):
        if code[i] in (0x48, 0x4C) and code[i + 1] == 0x8D and code[i + 2] & 0xC7 == 0x05:
            disp, = struct.unpack_from("<i", code, i + 3)
            out.append(base + i + 7 + disp)
    return out


def check_table(t: list[int]) -> str | None:
    """Why `t` is not a CxtVLC decode table, or None."""
    if len(t) != 1024:
        return "not 1024 entries"
    codes: dict = {}
    for i, e in enumerate(t):
        c, bits = i >> 7, i & 0x7F
        if e == 0:
            continue
        n = e & 7
        rho, ek, e1 = (e >> 4) & 15, (e >> 12) & 15, (e >> 8) & 15
        if not 1 <= n <= 7:
            return f"entry {i}: codeword length {n}"
        if e1 & ~ek or ek & ~rho:
            return f"entry {i}: e_1 / e_k outside rho"
        cwd = bits & ((1 << n) - 1)
        for k in range(1 << (7 - n)):
            if t[(c << 7) | (k << n) | cwd] != e:
                return f"entry {i}: aliases of a codeword differ"
        codes.setdefault(c, {})[(cwd, n)] = e
    for c in range(8):
        got = codes.get(c, {})
        if not got:
            return f"context {c} has no codeword"
        has_zero = any((e >> 4) & 15 == 0 for e in got.values())
        if has_zero != (c != 0):
            return f"context {c}: rho = 0 {'coded' if has_zero else 'missing'}"
        words = sorted(got)
        for a, na in words:
            for b, nb in words:
                if (a, na) != (b, nb) and na <= nb and b & ((1 << na) - 1) == a:
                    return f"context {c}: codeword {a:b} is a prefix of {b:b}"
    return None


def extract(lib: str) -> tuple[list[int], list[int]]:
    elf = open(lib, "rb").read()
    secs = sections(elf)
    text_addr, text_off, _ = secs[".text"]
    ro_addr, ro_off, ro_size = secs[".rodata"]
    addr, size = symbol(elf, secs, SYMBOL)
    size = size or 0x8000
    code = elf[text_off + addr - text_addr:text_off + addr - text_addr + size]
    found: list[int] = []
    for target in rip_lea_targets(code, addr):
        if target in found or not ro_addr <= target <= ro_addr + ro_size - 2048:
            continue
        at = ro_off + target - ro_addr
        table = list(struct.unpack_from("<1024H", elf, at))
        if check_table(table) is None:
            found.append(target)
    if len(found) != 2:
        raise SystemExit(f"expected two CxtVLC tables in {SYMBOL.decode()}, found "
                         f"{[hex(a) for a in found]}")
    tables = [list(struct.unpack_from("<1024H", elf, ro_off + a - ro_addr)) for a in found]
    offs = [ro_off + a - ro_addr for a in found]
    print(f"{os.path.basename(lib)}: {SYMBOL.decode()} at {addr:#x}, tables at "
          f"{found[0]:#x} and {found[1]:#x} (file offsets {offs[0]:#x}, {offs[1]:#x})")
    return tables[0], tables[1]


def literal(name: str, t: list[int]) -> str:
    rows = [", ".join(f"0x{v:04X}" for v in t[k:k + 8]) for k in range(0, 1024, 8)]
    return f"{name} = (\n" + "".join(f"    {r},\n" for r in rows) + ")\n"


HEADER = '''"""The CxtVLC decode tables of ITU-T T.814 (HTJ2K, JPEG 2000 Part 15),
as OpenJPEG 2.5 lays them out in `ht_dec.c` (`vlc_tbl0` for the initial
quad row, `vlc_tbl1` for the other rows).  Written by
`tools/extract_ht_tables.py` from a libopenjp2 2.5 build; do not edit.

Index: (context << 7) | the next 7 bits of the VLC stream (taken from its
least significant end).  Entry: codeword length (bits 0-2; 0 where no
codeword matches), u_off (bit 3), the significance pattern rho (4-7, one
bit a sample of the quad: top-left, bottom-left, top-right,
bottom-right), e_1 (8-11) and e_k (12-15), the exponent-MSB patterns.
"""

'''


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lib", default=None)
    p.add_argument("--out", default=os.path.join(ROOT, "kgtpu_torch", "data",
                                                 "j2k_ht_tables.py"))
    a = p.parse_args(argv)
    t0, t1 = extract(a.lib or default_lib())
    with open(a.out, "w") as f:
        f.write(HEADER + literal("VLC_TBL0", t0) + "\n" + literal("VLC_TBL1", t1))
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
