"""The port's augmenting loader (`kgtpu_torch/data/loader.py`) against
kgtpu's: `prepare_sample(augment=True)`, `make_batch`, `stack_batches`
and `batch_iterator`.

Tolerance: none where both iterators read the same in-memory dataset:
images, gains, biases, boxes, valid flags and uint16 label maps bitwise
equal, with rotation and elastic deformation on.  Through each package's
own generator the same holds, except that `synthetic_hard` images may
differ by one on a small share of values (tests/test_torch_synthetic.py).
"""

import numpy as np
import pytest

from kgtpu.config import DataConfig as JaxDataConfig
from kgtpu.data import loader as jl
from kgtpu.data.registry import build_dataset as jax_build_dataset
from kgtpu_torch.config import DataConfig
from kgtpu_torch.data import loader as tl
from kgtpu_torch.data.registry import build_dataset

KEYS = ("image", "img_gain", "img_bias", "boxes", "valid", "label_map")
AUG = dict(input_size=96, max_instances=16, rotate_deg=15.0, elastic_alpha=6.0,
           elastic_sigma=32.0, synthetic_train_images=8)


def _cfgs(**kw):
    kw = {**AUG, **kw}
    return DataConfig(**kw), JaxDataConfig(**kw)


def _in_memory(name, n=8, size=128):
    """kgtpu's generated images as a list: the same input for both loaders,
    at another size than the canvas (the affine rescales)."""
    ds = jax_build_dataset(JaxDataConfig(dataset=name, input_size=size,
                                         synthetic_train_images=n), "train")
    return [ds[i] for i in range(n)]


def _assert_batches_equal(got, want, image_tol=False):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if k == "image" and image_tol:
                d = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-4
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_hard"])
def test_batch_iterator_matches_kgtpu_in_memory(name):
    """Two epochs' worth of batches (the permutation wraps) from one
    in-memory dataset, rotation, elastic and colour jitter on."""
    data = _in_memory(name)
    cfg, jcfg = _cfgs()
    got = list(tl.batch_iterator(data, cfg, 3, seed=4, steps=5))
    want = list(jl.batch_iterator(data, jcfg, 3, seed=4, steps=5))
    _assert_batches_equal(got, want)
    assert got[0]["label_map"].dtype == np.uint16


@pytest.mark.parametrize("name", ["synthetic", "synthetic_hard"])
def test_batch_iterator_matches_kgtpu_generated(name):
    """The whole host path: each package's generator, then its loader."""
    cfg, jcfg = _cfgs(dataset=name)
    got = list(tl.batch_iterator(build_dataset(cfg), cfg, 4, seed=1, steps=3))
    want = list(jl.batch_iterator(jax_build_dataset(jcfg), jcfg, 4, seed=1, steps=3))
    _assert_batches_equal(got, want, image_tol=name == "synthetic_hard")


def test_batch_iterator_unshuffled_without_augment():
    data = _in_memory("synthetic")
    cfg, jcfg = _cfgs()
    got = list(tl.batch_iterator(data, cfg, 4, augment=False, shuffle=False, steps=3))
    want = list(jl.batch_iterator(data, jcfg, 4, augment=False, shuffle=False, steps=3))
    _assert_batches_equal(got, want)


def test_batch_iterator_does_not_depend_on_workers():
    data = _in_memory("synthetic")
    cfg, _ = _cfgs()
    one = list(tl.batch_iterator(data, cfg, 4, seed=2, steps=4, num_workers=1, prefetch=1))
    four = list(tl.batch_iterator(data, cfg, 4, seed=2, steps=4, num_workers=4))
    _assert_batches_equal(four, one)


@pytest.mark.parametrize("num_processes", [2, 4])
def test_batch_iterator_process_rows_make_the_global_batch(num_processes):
    data = _in_memory("synthetic")
    cfg, _ = _cfgs()
    whole = list(tl.batch_iterator(data, cfg, 4, seed=5, steps=3))
    parts = [list(tl.batch_iterator(data, cfg, 4, seed=5, steps=3, process_id=p,
                                    num_processes=num_processes))
             for p in range(num_processes)]
    joined = [{k: np.concatenate([p[i][k] for p in parts]) for k in KEYS}
              for i in range(3)]
    _assert_batches_equal(joined, whole)


def test_batch_iterator_refuses_bad_sizes():
    data = _in_memory("synthetic", n=3)
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="batch_size"):
        next(tl.batch_iterator(data, cfg, 4))
    with pytest.raises(ValueError, match="num_processes"):
        next(tl.batch_iterator(data, cfg, 3, num_processes=2))


@pytest.mark.parametrize("elastic", [0.0, 12.0])
def test_prepare_sample_augment_matches_kgtpu(elastic):
    """One generator shared by several samples: the same draws in the same
    order, so the generator ends in the same state."""
    data = _in_memory("synthetic_hard", n=4)
    cfg, jcfg = _cfgs(elastic_alpha=elastic, color_jitter=0.3)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for raw in data:
        got = tl.prepare_sample(raw, cfg, augment=True, image_only=False, rng=a)
        want = jl._prepare_sample(raw, jcfg, augment=True, rng=b)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    assert a.uniform() == b.uniform()
    with pytest.raises(ValueError, match="rng"):
        tl.prepare_sample(data[0], cfg, augment=True)


def test_make_batch_and_stack_match_kgtpu():
    data = _in_memory("synthetic")
    cfg, jcfg = _cfgs()
    got = [tl.make_batch(data, [3, 1, 6], cfg, True, rng=np.random.default_rng(s))
           for s in (0, 1)]
    want = [jl.make_batch(data, [3, 1, 6], jcfg, True, rng=np.random.default_rng(s))
            for s in (0, 1)]
    _assert_batches_equal(got, want)
    st, jst = tl.stack_batches(got), jl.stack_batches(want)
    for k in KEYS:
        assert st[k].shape == (2,) + got[0][k].shape
        np.testing.assert_array_equal(st[k], jst[k])
