"""The port's synthetic generator (`kgtpu_torch/data/synthetic.py`) against
kgtpu's, and the registry's synthetic splits.

Tolerances: label maps exact for every variant, seed and index.  Images
exact for `synthetic` and `synthetic_crowded`.  `synthetic_hard` draws its
illumination field with cv2.resize(INTER_CUBIC) of a one-channel 8 x 8
grid, which cv2 hands to Intel IPP; the port computes cv2's own code path,
whose f32 field differs from IPP's in the last bits.  So its images may
differ by at most 1 on at most HARD_SHARE of their values: measured 178 of
37,748,736 values (4.7e-6, all off by one) over the 48 images of the
train, val and test splits at 512 x 512.
"""

import numpy as np
import pytest

from kgtpu.config import DataConfig as JaxDataConfig
from kgtpu.data.registry import build_dataset as jax_build_dataset
from kgtpu.data.synthetic import SyntheticCells as JaxSyntheticCells
from kgtpu_torch.config import DataConfig
from kgtpu_torch.data.registry import build_dataset
from kgtpu_torch.data.synthetic import SyntheticCells

HARD_SHARE = 1e-4
VARIANTS = {"synthetic": {}, "synthetic_crowded": {"crowded": True},
            "synthetic_hard": {"hard": True}}


def _assert_same(got, want, hard):
    assert got["id"] == want["id"]
    assert got["label_map"].dtype == want["label_map"].dtype == np.int32
    np.testing.assert_array_equal(got["label_map"], want["label_map"])
    assert got["image"].dtype == want["image"].dtype == np.uint8
    diff = np.abs(got["image"].astype(np.int32) - want["image"].astype(np.int32))
    if hard:
        assert diff.max() <= 1 and (diff > 0).mean() <= HARD_SHARE, (
            int(diff.max()), int((diff > 0).sum()))
    else:
        np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("seed", [0, 7, 13])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_synthetic_matches_kgtpu(variant, seed):
    """Three images at 128 x 128 per (variant, seed)."""
    kw = VARIANTS[variant]
    ours = SyntheticCells(size=128, num_images=3, seed=seed, **kw)
    theirs = JaxSyntheticCells(size=128, num_images=3, seed=seed, **kw)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _assert_same(ours[i], theirs[i], "hard" in kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_synthetic_matches_kgtpu_at_512(variant):
    kw = VARIANTS[variant]
    ours = SyntheticCells(size=512, num_images=2, seed=0, **kw)
    theirs = JaxSyntheticCells(size=512, num_images=2, seed=0, **kw)
    for i in range(2):
        _assert_same(ours[i], theirs[i], "hard" in kw)


def test_synthetic_counts_and_memo():
    """Explicit cell counts, and the per-index memo: a second read returns
    the same object."""
    ours = SyntheticCells(size=96, num_images=2, min_cells=1, max_cells=2, seed=3)
    theirs = JaxSyntheticCells(size=96, num_images=2, min_cells=1, max_cells=2, seed=3)
    _assert_same(ours[1], theirs[1], False)
    assert ours[1] is ours[1] and 1 <= ours[1]["label_map"].max() <= 2


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_registry_synthetic_splits_match_kgtpu(variant, split):
    """Split sizes and seeds (train: synthetic_train_images, seed 0; val:
    16, seed 7; test: 16, seed 13); the first image equal."""
    kw = dict(dataset=variant, input_size=96, synthetic_train_images=5)
    ours = build_dataset(DataConfig(**kw), split)
    theirs = jax_build_dataset(JaxDataConfig(**kw), split)
    assert isinstance(ours, SyntheticCells)
    assert (len(ours), ours.seed, ours.size, ours.crowded, ours.hard) == (
        len(theirs), theirs.seed, theirs.size, theirs.crowded, theirs.hard)
    _assert_same(ours[0], theirs[0], variant == "synthetic_hard")
