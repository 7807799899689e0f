#!/usr/bin/env python
"""Hold the port's JPEG 2000 reader against cv2.imread on many random files,
outside the test gate (it takes minutes):

    python tools/probe_jpeg2000.py [--files 1000] [--maxsize 299] [--seed 0]
                                   [--workers 8] [--fma | --damage] [--dump DIR]

A third of the files is `variant_encoders.jpeg2000_random` (PIL's OpenJPEG
writer with random size, mode, content and options), a third
`variant_encoders.jpeg2000_random_styles` (libopenjp2 through ctypes, with
random code-block styles, precisions, layers and code-block sizes; each
encode in a forked child, as the encoder can corrupt its heap on noise with
TERMALL, and a child that dies counts as a refused draw) and a third
`variant_encoders.jpeg2000_ht_random` (HT code-blocks from the test writer:
random kinds, wavelets, code-blocks, tiles, precincts, progressions and
passes); each is read in
"color", "gray" and "unchanged" by cv2 and by
`kgtpu_torch.data.imread.read_image`, which
must give the same dtype, shape and values, or raise UnreadableImage where
cv2 returns None.  Prints the counts and every mismatch; exits 1 on any.
`--fma` instead reads the 9/7 files only, with the wavelet's lifting steps
fused (X(k) + (X(k-1) + X(k+1)) * c rounded once, as a compiler that
contracts a*b+c would build OpenJPEG), and prints how many differ from
cv2: the check that `data/j2k_dwt.py` keeps the separate multiply and add.
`--damage` reads each file after damaging it (bytes changed, the file cut,
or a run replaced by random bytes, anywhere: boxes, headers, packets; for
half the HT files, 1-3 bytes of the code-block data alone), which cv2
mostly refuses and the port must refuse alike.  `--dump DIR` writes each
file that mismatches there.  The report lists every read the port left as
`UnsupportedImage` (the file's kind and the message), for a later slice.
Needs cv2 and PIL (this CPU box), not the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("color", "gray", "unchanged")


def _fused_lift(x: np.ndarray, start: int, c: np.float32) -> None:
    """`j2k_dwt._lift` with the multiply and add fused (one rounding, in
    float64 from exact float32 operands)."""
    n = x.shape[1]
    k = np.arange(start, n, 2)
    if k.size:
        left = np.abs(k - 1)
        right = np.where(k + 1 < n, k + 1, 2 * n - 2 - (k + 1))
        s = (x[:, left] + x[:, right]).astype(np.float64)
        x[:, k] = (s * np.float64(c) + x[:, k].astype(np.float64)).astype(np.float32)


def _damage_blocks(data: bytes, rng) -> bytes:
    """1-3 bytes after the first SOD changed or with a bit flipped."""
    d = bytearray(data)
    i0 = data.index(b"\xff\x93") + 2
    for _ in range(int(rng.integers(1, 4))):
        j = int(rng.integers(i0, max(i0 + 1, len(d) - 2)))
        d[j] = int(rng.integers(0, 256)) if rng.random() < 0.5 else d[j] ^ (1 << int(
            rng.integers(0, 8)))
    return bytes(d)


def _damage(data: bytes, rng) -> bytes:
    d = bytearray(data)
    kind = int(rng.integers(0, 3))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
    elif kind == 1:
        d = d[:int(rng.integers(1, len(d)))]
    else:
        i = int(rng.integers(0, len(d)))
        run = rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
        d = d[:i] + bytearray(run) + d[i + int(rng.integers(0, 20)):]
    return bytes(d)


def _forked(fn):
    """fn run in a forked child, its bytes sent back through a pipe; a
    ValueError where the child fails or dies."""
    def run(*args, **kw):
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            os.close(r)
            try:
                data = fn(*args, **kw)
                with os.fdopen(w, "wb") as f:
                    f.write(data)
                os._exit(0)
            except BaseException:
                os._exit(3)
        os.close(w)
        with os.fdopen(r, "rb") as f:
            data = f.read()
        _, status = os.waitpid(pid, 0)
        if status:
            raise ValueError(f"the encoder failed or died (status {status})")
        return data
    return run


def _probe(args: tuple) -> tuple[int, int, int, list, list, int]:
    """(files written, modes cv2 reads, modes refused by both, mismatches,
    reads the port queues: UnsupportedImage and whether cv2 read them,
    files with a code-block style other than 0, HT files) for the files of
    one seed."""
    import cv2

    from kgtpu_torch.data import j2k_dwt
    from kgtpu_torch.data.imread import UnreadableImage, UnsupportedImage, read_image
    from tools.variant_encoders import (jpeg2000_ht_random, jpeg2000_opj, jpeg2000_random,
                                        jpeg2000_random_styles)
    seed, n, maxsize, fma, damage, dump = args
    encode = _forked(jpeg2000_opj)
    if fma:
        j2k_dwt._lift = _fused_lift
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    rng = np.random.default_rng(seed)
    written, read, refused, bad, queued, styled, ht = 0, 0, 0, [], [], 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.png")
        for k in range(n):
            is_ht = k % 3 == 2 and not fma
            if is_ht:
                data, info = jpeg2000_ht_random(rng, min(maxsize, 64))
            elif k % 3 == 1 and not fma:
                data, info = jpeg2000_random_styles(rng, maxsize, encode)
            else:
                data, info = jpeg2000_random(rng, maxsize)
            if data is None or fma and not info[3].get("irreversible"):
                continue
            if damage:
                data = _damage_blocks(data, rng) if is_ht and rng.random() < 0.5 else \
                    _damage(data, rng)
            written += 1
            ht += is_ht
            styled += bool(info[3].get("style"))
            with open(path, "wb") as f:
                f.write(data)
            for mode in MODES:
                try:
                    want = cv2.imread(path, flags[mode])
                except cv2.error:                   # over cv2's size limits
                    want = None
                try:
                    got = read_image(path, mode)
                except UnreadableImage as e:
                    got = e
                except UnsupportedImage as e:       # a queued variant
                    queued.append((info, mode, want is not None, str(e)[-80:]))
                    continue
                if want is None:
                    if isinstance(got, UnreadableImage):
                        refused += 1
                    else:
                        if dump:
                            with open(os.path.join(dump, f"{seed}_{written}.jp2"), "wb") as f:
                                f.write(data)
                        bad.append((info, mode, "read where cv2 returns None"))
                    continue
                if want.ndim == 3:
                    want = want[..., [2, 1, 0, 3][:want.shape[2]]]
                if isinstance(got, Exception) or got.dtype != want.dtype or \
                        got.shape != want.shape or not np.array_equal(got, want):
                    if dump:
                        with open(os.path.join(dump, f"{seed}_{written}.jp2"), "wb") as f:
                            f.write(data)
                    bad.append((info, mode, repr(got)[:80] if isinstance(got, Exception)
                                else "values differ"))
                else:
                    read += 1
    return written, read, refused, bad, queued, styled, ht


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--files", type=int, default=1000)
    p.add_argument("--maxsize", type=int, default=299)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--fma", action="store_true")
    p.add_argument("--damage", action="store_true")
    p.add_argument("--dump", default=None)
    a = p.parse_args(argv)
    per = 25
    jobs = [(a.seed * 100000 + k, min(per, a.files - k * per), a.maxsize, a.fma, a.damage,
             a.dump) for k in range(-(-a.files // per))]
    t = time.perf_counter()
    with ProcessPoolExecutor(a.workers) as ex:
        results = list(ex.map(_probe, jobs))
    written = sum(r[0] for r in results)
    read = sum(r[1] for r in results)
    refused = sum(r[2] for r in results)
    bad = [b for r in results for b in r[3]]
    queued = [q for r in results for q in r[4]]
    styled = sum(r[5] for r in results)
    ht = sum(r[6] for r in results)
    what = "9/7 files, the lifting fused" if a.fma else "damaged files" if a.damage else "files"
    print(f"{written} {what} (of {a.files} drawn; {styled} with code-block styles, {ht} HT), "
          f"{read} "
          f"reads equal to cv2's, {refused} "
          f"refused by both, {len(bad)} mismatches "
          f"({len({repr(b[0]) for b in bad})} files), {len(queued)} queued "
          f"(UnsupportedImage; cv2 reads {sum(q[2] for q in queued)} of them), "
          f"{time.perf_counter() - t:.0f} s")
    if a.fma:
        return 0
    for q in queued:
        print("UNSUPPORTED", q)
    for b in bad:
        print("MISMATCH", b)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
