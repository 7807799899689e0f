#!/usr/bin/env python
"""Hold the port's PNG, JPEG and TIFF readers against cv2.imread on many
damaged files, outside the test gate:

    python tools/probe_formats.py [--files 3000] [--seed 0] [--workers 8]
                                  [--kinds png,jpeg_baseline,...] [--dump DIR]

Each file is a small image (random size up to 96x128, smooth content with a
noisy band) written by cv2, PIL or `variant_encoders` in one of `KINDS`,
then cut at a random byte or given one to three random bytes anywhere
(headers, tables, entropy-coded data).  Each is read in "color", "gray" and
"unchanged" by cv2 and by `kgtpu_torch.data.imread.read_image`, which must
give the same dtype, shape and values, or raise UnreadableImage where cv2
returns None; any other exception is a mismatch.  UnsupportedImage (a case
cv2 reads and the port queues, see ROADMAP §1) is counted apart, as queued.
Prints the counts per kind and every mismatch; exits 1 on any.  `--dump DIR` writes each file
that mismatches there.  Needs cv2 and PIL, which the port itself never imports.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("color", "gray", "unchanged")
KINDS = ("png", "jpeg_baseline", "jpeg_progressive", "jpeg_arith", "jpeg_lossless",
         "tiff_lzw", "tiff_deflate", "tiff_packbits", "ccitt_g3", "ccitt_g4", "ccitt_rlew")


def _content(rng, h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[:h, :w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1).astype(np.uint8)
    r0 = int(rng.integers(0, h))
    a[r0:r0 + h // 6] = rng.integers(0, 256, a[r0:r0 + h // 6].shape)
    return a


def make(kind: str, rng) -> bytes:
    """One undamaged file of `kind`."""
    import cv2
    from PIL import Image

    from tools import variant_encoders as ve
    h, w = int(rng.integers(8, 97)), int(rng.integers(8, 129))
    a = _content(rng, h, w)
    if kind == "png":
        c = int(rng.integers(0, 3))
        if c == 2:
            buf = io.BytesIO()
            Image.fromarray(a).convert("P").save(buf, "PNG")
            return buf.getvalue()
        return cv2.imencode(".png", a[..., 0] if c else a)[1].tobytes()
    if kind.startswith("jpeg") and kind != "jpeg_lossless":
        sub = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + ("444", "420", "422")[
            int(rng.integers(0, 3))])
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(30, 100)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sub,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(kind != "jpeg_baseline")]
        if rng.random() < 0.3:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.integers(1, 5))]
        src = a[..., 0] if rng.random() < 0.25 else a
        data = cv2.imencode(".jpg", src, params)[1].tobytes()
        return ve.jpeg_arith(data) if kind == "jpeg_arith" else data
    if kind == "jpeg_lossless":
        planes = [a[..., 0]] if rng.random() < 0.3 else [a[..., k] for k in range(3)]
        return ve.jpeg_lossless(planes, int(rng.integers(1, 8)),
                                restart_rows=int(rng.integers(0, 2)) * 4)
    if kind == "tiff_lzw":
        return cv2.imencode(".tif", a)[1].tobytes()
    if kind in ("tiff_deflate", "tiff_packbits"):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "TIFF", compression={
            "tiff_deflate": "tiff_adobe_deflate", "tiff_packbits": "packbits"}[kind])
        return buf.getvalue()
    bw = a[..., 0] > 128
    if kind == "ccitt_rlew":
        return ve.tiff_ccitt_rlew(bw, fill_order=int(rng.integers(1, 3)))
    buf = io.BytesIO()
    Image.fromarray(bw).save(buf, "TIFF", compression={"ccitt_g3": "group3",
                                                       "ccitt_g4": "group4"}[kind])
    return buf.getvalue()


def damage(data: bytes, rng) -> bytes:
    """The file cut at a random byte, or one to three bytes changed."""
    d = bytearray(data)
    if rng.random() < 0.5:
        return bytes(d[:int(rng.integers(1, len(d)))])
    for _ in range(int(rng.integers(1, 4))):
        d[int(rng.integers(0, len(d)))] ^= int(rng.integers(1, 256))
    return bytes(d)


def _probe(args: tuple) -> dict:
    """{kind: [files, reads equal, refused by both, mismatches, queued
    (UnsupportedImage)]} for the files of one seed."""
    import cv2

    from kgtpu_torch.data.imread import UnreadableImage, UnsupportedImage, read_image
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    seed, n, kinds, dump = args
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    rng = np.random.default_rng(seed)
    out = {k: [0, 0, 0, [], []] for k in kinds}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.png")
        for i in range(n):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            data = damage(make(kind, rng), rng)
            rec = out[kind]
            rec[0] += 1
            with open(path, "wb") as f:
                f.write(data)
            for mode in MODES:
                try:
                    want = cv2.imread(path, flags[mode])
                except cv2.error:                   # over cv2's size limits
                    want = None
                try:
                    got = read_image(path, mode)
                except Exception as e:          # noqa: BLE001 - every class is reported
                    got = e
                if want is not None and want.ndim == 3:
                    want = want[..., [2, 1, 0, 3][:want.shape[2]]]
                if want is None and isinstance(got, UnreadableImage):
                    rec[2] += 1
                    continue
                if isinstance(got, UnsupportedImage):       # a variant the port queues
                    rec[4].append((seed, i, kind, mode, want is not None, str(got)[-60:]))
                    continue
                if want is not None and not isinstance(got, Exception) and \
                        got.dtype == want.dtype and got.shape == want.shape and \
                        np.array_equal(got, want):
                    rec[1] += 1
                    continue
                why = (f"{type(got).__name__}: {str(got).replace(path + ': ', '')[:70]}"
                       if isinstance(got, Exception)
                       else "read where cv2 returns None" if want is None
                       else "values differ")
                rec[3].append((seed, i, kind, mode, "cv2 reads" if want is not None
                               else "cv2 None", why))
                if dump:
                    with open(os.path.join(dump, f"{kind}_{seed}_{i}.bin"), "wb") as f:
                        f.write(data)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--files", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--kinds", default=",".join(KINDS))
    p.add_argument("--dump", default=None)
    a = p.parse_args(argv)
    kinds = tuple(a.kinds.split(","))
    per = 25
    jobs = [(a.seed * 100000 + k, min(per, a.files - k * per), kinds, a.dump)
            for k in range(-(-a.files // per))]
    t = time.perf_counter()
    with ProcessPoolExecutor(a.workers) as ex:
        results = list(ex.map(_probe, jobs))
    total = [0, 0, 0, 0, 0]
    bad = []
    for kind in kinds:
        rec = [sum(r[kind][j] for r in results) for j in range(3)]
        kb = [b for r in results for b in r[kind][3]]
        kq = [q for r in results for q in r[kind][4]]
        bad += kb
        total = [t0 + v for t0, v in zip(total, rec + [len(kb), len(kq)])]
        print(f"{kind:18s} {rec[0]:6d} files, {rec[1]:6d} reads equal, {rec[2]:6d} refused by "
              f"both, {len(kb):5d} mismatches, {len(kq):5d} queued")
    print(f"{total[0]} damaged files, {total[1]} reads equal to cv2's, {total[2]} refused by "
          f"both, {total[3]} mismatches, {total[4]} queued (UnsupportedImage, each a read "
          f"cv2 makes), {time.perf_counter() - t:.0f} s")
    for b in bad:
        print("MISMATCH", b)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
