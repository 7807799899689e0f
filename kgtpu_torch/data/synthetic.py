"""Synthetic blob-cell dataset: counterpart of `kgtpu/data/synthetic.py`
without cv2.

Deterministic per-index scenes of elliptical "cells" on a textured
background, generated on the fly, so training and evaluation need no
downloaded data.  The same seed gives the same scenes as kgtpu: the draws
come from NumPy's generator in kgtpu's order, and the cv2 calls are
replaced by `data/draw.py`'s exact copies.  The order of the draws depends
on the rasters (`synthetic_hard` draws one normal per covered pixel), so a
raster one pixel off would change every later draw of that image.

The one difference: `synthetic_hard`'s illumination field is a bicubic
upsample of an 8 x 8 grid, which cv2 hands to Intel IPP; `draw.
resize_cubic_f32` follows cv2's own code, which differs from IPP's in the
last bits of the f32 field.  The label maps are unaffected; a few image
pixels can differ by one.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data import draw


class SyntheticCells:
    """Map-style dataset: __getitem__ → {"image" uint8 HxWx3, "label_map" int32}.

    Three variants (``--dataset`` values):
      synthetic          3-12 mostly-disjoint ellipses — the smoke-test set
                         (saturated by the flagship: AP50 = 1.0 by round 2)
      synthetic_crowded  40-90 small touching cells — DSB-nuclei-like
                         density, the keypoint-grouping stress case
      synthetic_hard     the SURVEY.md §0.5 bright-field phenotype, built so
                         quality progress stays measurable (VERDICT r2 item
                         1): elongated cells (aspect up to 4:1), clustered
                         placement with heavy boundary contact and partial
                         occlusion, ~10x cell-size spread inside one image,
                         smooth illumination gradients + per-cell contrast
                         that can sit above OR below the local background,
                         intra-cell texture (nucleus spot, edge halo)
    """

    def __init__(self, size: int = 512, num_images: int = 64,
                 min_cells: int | None = None, max_cells: int | None = None,
                 seed: int = 0, crowded: bool = False, hard: bool = False):
        assert not (crowded and hard)
        self.size = size
        self.num_images = num_images
        # per-mode default counts, overridable (small-canvas tests use fewer)
        if min_cells is None:
            min_cells = 40 if crowded else (20 if hard else 3)
        if max_cells is None:
            max_cells = 90 if crowded else (48 if hard else 12)
        self.min_cells = min_cells
        self.max_cells = max_cells
        self.crowded = crowded
        self.hard = hard
        self.seed = seed
        self._cache: dict[int, dict] = {}

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, idx: int) -> dict:
        if idx in self._cache:   # deterministic per index → memoize
            return self._cache[idx]
        rng = np.random.default_rng(self.seed * 100_003 + idx)
        out = (self._gen_hard(rng, idx) if self.hard
               else self._gen_basic(rng, idx))
        self._cache[idx] = out
        return out

    def _gen_basic(self, rng, idx: int) -> dict:
        s = self.size
        img = rng.normal(90, 12, (s, s, 3)).clip(0, 255).astype(np.uint8)
        label = np.zeros((s, s), np.int32)

        n = int(rng.integers(self.min_cells, self.max_cells + 1))
        inst = 0
        lo = max(4, s // 64) if self.crowded else max(6, s // 32)
        hi = max(8, s // 20) if self.crowded else max(10, s // 6)
        for _ in range(n):
            ax = int(rng.integers(lo, hi))
            ay = int(rng.integers(lo, hi))
            cx = int(rng.integers(ax, s - ax))
            cy = int(rng.integers(ay, s - ay))
            ang = float(rng.uniform(0, 180))
            # skip if it would fully cover an existing instance
            probe = np.zeros((s, s), np.uint8)
            draw.fill_ellipse(probe, (cx, cy), (ax, ay), ang, 1)
            covered = probe.astype(bool)
            overlap = label[covered] > 0
            if overlap.mean() > 0.4:     # keep instances mostly distinct
                continue
            inst += 1
            label[covered] = inst
            shade = int(rng.integers(130, 220))
            cell = img[covered].astype(np.int32)
            img[covered] = np.clip(
                0.35 * cell + 0.65 * shade + rng.normal(0, 6, cell.shape),
                0, 255).astype(np.uint8)

        img = draw.gaussian_blur3(img)
        return {"image": img, "label_map": label,
                "id": f"synthetic_{idx:05d}"}

    def _gen_hard(self, rng, idx: int) -> dict:
        s = self.size
        # smooth illumination field: ramp + blurred low-frequency blobs
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        base = (80.0 + 40.0 * rng.uniform(-1, 1) * (xx - 0.5)
                + 40.0 * rng.uniform(-1, 1) * (yy - 0.5))
        blobs = rng.normal(0, 1, (8, 8)).astype(np.float32)
        base = base + 25.0 * draw.resize_cubic_f32(blobs, (s, s))
        img = (base[..., None]
               + rng.normal(0, 7, (s, s, 3))).clip(5, 250).astype(np.float32)
        label = np.zeros((s, s), np.int32)

        n = int(rng.integers(self.min_cells, self.max_cells + 1))
        # log-uniform minor semi-axis: ~10x size spread within one image
        b_lo, b_hi = max(3.0, s / 170), s / 14
        centers: list[tuple[float, float, float]] = []   # (cx, cy, reach)
        inst = 0
        for _ in range(n):
            b = float(np.exp(rng.uniform(np.log(b_lo), np.log(b_hi))))
            aspect = float(rng.uniform(1.0, 4.0))
            a = b * aspect
            ang = float(rng.uniform(0, 180))
            if centers and rng.uniform() < 0.6:
                # clustered placement: drop the new cell right against an
                # existing one so boundaries touch / partially occlude
                pcx, pcy, pr = centers[int(rng.integers(len(centers)))]
                d = (pr + 0.7 * (a + b) / 2) * rng.uniform(0.55, 1.05)
                th = rng.uniform(0, 2 * np.pi)
                cx, cy = pcx + d * np.cos(th), pcy + d * np.sin(th)
            else:
                cx = float(rng.uniform(a, s - a))
                cy = float(rng.uniform(a, s - a))
            cx = float(np.clip(cx, 2, s - 3))
            cy = float(np.clip(cy, 2, s - 3))
            probe = np.zeros((s, s), np.uint8)
            draw.fill_ellipse(probe, (round(cx), round(cy)),
                              (round(a), round(b)), ang, 1)
            covered = probe.astype(bool)
            area = int(covered.sum())
            if area < 12:
                continue
            # the new cell may occlude earlier ones, but may not erase them:
            # reject if it would cover > 40% of any existing instance
            hit = label[covered]
            veto = False
            for oid, cnt in zip(*np.unique(hit[hit > 0], return_counts=True)):
                total = int((label == oid).sum())
                if cnt > 0.4 * total or total - cnt < 12:
                    veto = True
                    break
            if veto:
                continue
            inst += 1
            label[covered] = inst
            centers.append((cx, cy, (a + b) / 2))
            # contrast above OR below local background, never near-zero
            local_bg = float(img[covered].mean())
            delta = float(rng.uniform(18, 75)) * (1 if rng.uniform() < 0.5
                                                  else -1)
            shade = np.clip(local_bg + delta, 10, 245)
            mix = rng.uniform(0.55, 0.8)
            cell = img[covered]
            img[covered] = (1 - mix) * cell + mix * shade \
                + rng.normal(0, 5, cell.shape)
            # nucleus spot + edge halo give intra-cell texture
            nuc = np.zeros((s, s), np.uint8)
            ncx = cx + rng.uniform(-0.3, 0.3) * a
            ncy = cy + rng.uniform(-0.3, 0.3) * b
            draw.fill_ellipse(nuc, (round(ncx), round(ncy)),
                              (max(round(a * 0.35), 1), max(round(b * 0.35), 1)),
                              ang, 1)
            nm = nuc.astype(bool) & covered
            img[nm] = img[nm] + (12 if delta < 0 else -12)
            ring = draw.dilate3(probe) - probe
            rm = ring.astype(bool) & (label == 0)
            img[rm] = np.clip(img[rm] - np.sign(delta) * 10, 5, 250)

        img = draw.gaussian_blur3(img.clip(0, 255).astype(np.uint8))
        return {"image": img, "label_map": label,
                "id": f"synthetic_{idx:05d}"}
