"""Write the score-label glyph table that `kgtpu_torch/visualize.py` stamps.

kgtpu's `visualize.draw_instances` labels each box with
`cv2.putText(f"{score:.2f}", FONT_HERSHEY_SIMPLEX, 0.35, thickness 1)`.  The
only strings it draws are "0.00" ... "1.00".  cv2 5.0 renders them
anti-aliased: each character's coverage a (0..255) is blended into a pixel
as v <- (v * (255 - a) + c * a + 127) // 255, per channel, character after
character, so a pixel that two characters cover is blended twice.

This script renders each of the 101 strings with cv2 at a known origin on
uniform backgrounds, every background level against colours 0 and 255 and
every colour against background 0 (the three channels carry three such
probes a call), and finds for each pixel the one or two coverages whose
blends give every probe:

    assets_torch/glyphs_hershey_simplex_035.npz
        strings  [101] the strings, in order
        start    [102] int32: the pixels of strings[i] are rows start[i]:start[i + 1]
        offsets  [N, 2] int8 (dy, dx) from the text origin
        alpha    [N, 2] uint8, the coverages in blending order (0: no blend)

Run it from the repo root where cv2 is installed (the port itself never
imports cv2): python tools/make_torch_glyphs.py
"""

from __future__ import annotations

import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "assets_torch", "glyphs_hershey_simplex_035.npz")
ORIGIN = (40, 60)        # (x, y) on a canvas large enough for every string
SHAPE = (100, 140)


def blend(v, c, a):
    """One coverage blend, cv2 5.0's."""
    return (v * (255 - a) + c * a + 127) // 255


def probes() -> tuple[np.ndarray, np.ndarray]:
    """(background, colour) pairs: every level against 0 and 255, and every
    colour against 0."""
    lv = np.arange(256)
    bg = np.concatenate([lv, lv, np.zeros(256, np.int64)])
    col = np.concatenate([np.zeros(256, np.int64), np.full(256, 255), lv])
    return bg, col


def render(text: str, bg: np.ndarray, col: np.ndarray) -> np.ndarray:
    """[H, W, P] the string drawn on each probe's uniform background."""
    out = []
    for i in range(0, len(bg), 3):
        b = list(bg[i:i + 3]) + [0] * (3 - len(bg[i:i + 3]))
        c = list(col[i:i + 3]) + [0] * (3 - len(col[i:i + 3]))
        img = np.empty(SHAPE + (3,), np.uint8)
        img[:] = b
        cv2.putText(img, text, ORIGIN, cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                    tuple(int(v) for v in c), 1)
        out.append(img[..., :len(bg[i:i + 3])])
    return np.concatenate(out, -1).astype(np.int64)


def fit(obs: np.ndarray, bg: np.ndarray, col: np.ndarray) -> list[int]:
    """The coverages (one, or two in order) whose blends give obs [P]."""
    a = np.arange(256)
    one = blend(bg[None], col[None], a[:, None])                    # [256, P]
    hit = np.nonzero((one == obs).all(1))[0]
    if len(hit):
        return [int(hit[0])]
    # narrow the pairs on a few probes, then hold them against all
    few = np.linspace(0, len(bg) - 1, 24).astype(int)
    two = blend(one[:, None, few], col[None, None, few], a[None, :, None])
    for a1, a2 in np.argwhere((two == obs[few]).all(-1)):
        if (blend(one[a1], col, a2) == obs).all():
            return [int(a1), int(a2)]
    raise RuntimeError("no one- or two-blend fit")


def main() -> None:
    bg, col = probes()
    strings, start, offsets, alphas = [], [0], [], []
    for i in range(101):
        s = f"{i / 100:.2f}"
        obs = render(s, bg, col)
        touched = np.argwhere((obs != bg).any(-1))
        assert touched.min() > 0 and (touched.max(0) < np.asarray(SHAPE) - 1).all(), s
        for y, x in touched:
            al = fit(obs[y, x], bg, col)
            offsets.append((y - ORIGIN[1], x - ORIGIN[0]))
            alphas.append(al + [0] * (2 - len(al)))
        strings.append(s)
        start.append(len(offsets))
    np.savez_compressed(OUT, strings=np.asarray(strings), start=np.asarray(start, np.int32),
                        offsets=np.asarray(offsets, np.int8),
                        alpha=np.asarray(alphas, np.uint8))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {start[-1]} pixels)")


if __name__ == "__main__":
    main()
