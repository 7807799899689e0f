#!/usr/bin/env python
"""Hold the port's AVIF reader against cv2.imread on many random files,
outside the test gate (it takes minutes):

    python tools/probe_avif.py [--files 1000] [--maxsize 299] [--seed 0]
                               [--workers 8] [--damage] [--sequences] [--libaom]
                               [--dump DIR]

The files are `variant_encoders.avif_random`: cv2's writer (lossless at
quality 100 in 8, 10 and 12 bits, grey, colour and alpha, or lossy) and
PIL's (libavif 1.3 over aom: any quality, 4:2:0 / 4:2:2 / 4:4:4, grey and
alpha, aom's in-loop filters off or on, screen-content tuning, quantiser
matrices, tiles, 128x128 superblocks) and libaom's own in a container with
a random nclx (colour primaries, transfer, matrix coefficients, range; 8,
10 or 12 bits; its good-quality usage, which turns loop restoration on,
or its all-intra one; superres at a fixed denominator 9-16 in a share),
sizes 1 to --maxsize.  Each is read
in "color", "gray" and "unchanged" by cv2 and by
`kgtpu_torch.data.imread.read_image`, which must give the same dtype,
shape and values, or raise UnreadableImage where cv2 returns None.  The
only other outcome allowed is UnsupportedImage for a frame that needs a
post-filter still queued (film grain), a frame libavif would rescale to
its ispe, or a damaged header whose cv2 read is not defined; the report
counts those by name, and by filter, and how many reads were of frames
that loop restoration or superres filter.  `--damage` reads each file
after damaging it (bytes changed, the file cut, or a run replaced,
anywhere: boxes, headers, tile data); `--sequences` draws only PIL's image
sequences (`variant_encoders.avif_random_sequence`, RGB and RGBA), whose
track boxes a damage then hits far more often; `--libaom` draws only
libaom's encodes (`variant_encoders.avif_random_cicp`), where loop
restoration and superres come from.  Prints the counts and
every mismatch; exits 1 on any.  `--dump DIR` writes each mismatching file.
Needs cv2 and PIL (this CPU box), not the card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("color", "gray", "unchanged")


def damage(data: bytes, rng) -> bytes:
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


def probe(args: tuple) -> tuple:
    """(files, reads equal to cv2's, shared refusals, mismatches, refusals
    by filter named, files read equal whose frame needs loop restoration or
    superres) for the files of one seed."""
    import cv2

    from kgtpu_torch.data.imread import UnreadableImage, UnsupportedImage, read_image
    from tools.variant_encoders import avif_random, avif_random_cicp, avif_random_sequence
    seed, n, maxsize, dmg, dump, sequences, libaom = args
    draw = avif_random_sequence if sequences else avif_random
    if libaom:
        def draw(rng, maxsize):
            return avif_random_cicp(rng, *(int(v) for v in rng.integers(1, maxsize + 1, 2)))
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    rng = np.random.default_rng(seed)
    written, equal, refused, bad = 0, 0, 0, []
    queued: collections.Counter = collections.Counter()
    by_filter: collections.Counter = collections.Counter()
    filtered: collections.Counter = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.png")
        while written < n:
            data, info = draw(rng, maxsize)
            if data is None:
                continue
            if dmg:
                data = damage(data, rng)
            written += 1
            with open(path, "wb") as f:
                f.write(data)
            before = equal
            for mode in MODES:
                try:
                    want = cv2.imread(path, flags[mode])
                except cv2.error:
                    want = None
                try:
                    got = read_image(path, mode)
                except UnreadableImage as e:
                    got = e
                except UnsupportedImage as e:
                    m = re.search(r"needs (.*) is not ported", str(e))
                    if m is not None:
                        queued[m.group(1)] += 1
                        for name in m.group(1).split(", "):
                            by_filter[name] += 1
                    elif "ispe size differs" in str(e):
                        queued["libavif's rescale to ispe"] += 1
                    elif "not defined" in str(e):
                        queued["cv2's result not defined"] += 1
                    else:
                        bad.append((info, mode, f"unexpected UnsupportedImage: {e}"))
                    continue
                except Exception as e:  # noqa: BLE001 -- any other class is a fault
                    got = e
                if want is None:
                    if isinstance(got, UnreadableImage):
                        refused += 1
                        continue
                    why = "read where cv2 returns None" if not isinstance(got, Exception) \
                        else repr(got)[:100]
                elif isinstance(got, Exception):
                    why = repr(got)[:100]
                else:
                    if want.ndim == 3:
                        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
                    if got.dtype == want.dtype and got.shape == want.shape and \
                            np.array_equal(got, want):
                        equal += 1
                        continue
                    why = "values differ"
                if dump:
                    with open(os.path.join(dump, f"{seed}_{written}.avif"), "wb") as f:
                        f.write(data)
                bad.append((info, mode, why))
            if equal > before:
                for name in _filters(data):
                    filtered["read equal, frame needs " + name] += 1
    return written, equal, refused, bad, queued, by_filter, filtered


def _filters(data: bytes) -> list:
    """The post-filters of the file's primary frame that this slice ported
    (loop restoration, superres), or [] where it has none or no frame."""
    from kgtpu_torch.data import avif
    from kgtpu_torch.data.av1_obu import parse_frame, post_filters
    try:
        fh = parse_frame(avif.parse(data)[0].obus)[1]
    except Exception:  # noqa: BLE001 -- a damaged file: not counted
        return []
    return [f for f in post_filters(fh) if f in ("loop restoration", "superres")]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--files", type=int, default=1000)
    p.add_argument("--maxsize", type=int, default=299)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--damage", action="store_true")
    p.add_argument("--sequences", action="store_true")
    p.add_argument("--libaom", action="store_true")
    p.add_argument("--dump", default=None)
    a = p.parse_args(argv)
    if a.dump:
        os.makedirs(a.dump, exist_ok=True)
    t0 = time.time()
    per = max(1, a.files // (4 * a.workers))
    jobs = []
    left, s = a.files, a.seed * 100003
    while left > 0:
        jobs.append((s, min(per, left), a.maxsize, a.damage, a.dump, a.sequences, a.libaom))
        left -= per
        s += 1
    files = equal = refused = 0
    bad: list = []
    queued: collections.Counter = collections.Counter()
    by_filter: collections.Counter = collections.Counter()
    filtered: collections.Counter = collections.Counter()
    with ProcessPoolExecutor(a.workers) as ex:
        for w, e, r, b, q, f, lr in ex.map(probe, jobs):
            files, equal, refused = files + w, equal + e, refused + r
            bad += b
            queued.update(q)
            by_filter.update(f)
            filtered.update(lr)
    print(f"{files} {'sequences' if a.sequences else 'libaom files' if a.libaom else 'files'} "
          f"({'damaged' if a.damage else 'intact'}), {3 * files} reads: "
          f"{equal} equal to cv2's, {refused} refused by both, "
          f"{sum(queued.values())} UnsupportedImage, {len(bad)} mismatches "
          f"({time.time() - t0:.1f} s)")
    for k, v in sorted(queued.items()):
        print(f"  UnsupportedImage, {k}: {v}")
    for k, v in sorted(by_filter.items()):
        print(f"  UnsupportedImage naming {k} (alone or with others): {v}")
    for k, v in sorted(filtered.items()):
        print(f"  files {k}: {v}")
    for info, mode, why in bad[:50]:
        print("MISMATCH", mode, why, info)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
