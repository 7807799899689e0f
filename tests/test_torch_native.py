"""The port's compiled host ops (`kgtpu_torch/native.py` over
`kgtpu_torch/csrc/host_ops.cpp`, built with g++ at first use) against
kgtpu's (`kgtpu/native`) and against the port's own NumPy paths
(`data/transforms.py`, `evaluate.py`), on random label maps made from a
numpy seed: an empty map, sparse and large ids, area ties, slivers under 4
pixels, more instances than `max_instances`, duplicate and foreign ids in
`remap`, negative ids (background).

Tolerance: none.  Boxes, valid flags, remaps, renumbered maps and IoUs are
compared exactly, with their dtypes.

    python -m pytest tests/test_torch_native.py -q
"""

import numpy as np
import pytest

from kgtpu import evaluate as jax_eval
from kgtpu import native as jax_native
from kgtpu.data import transforms as jax_transforms
from kgtpu_torch import evaluate, native
from kgtpu_torch.data import transforms


@pytest.fixture(scope="module", autouse=True)
def lib():
    out = native.get_lib()
    assert out is not None, native.error
    assert jax_native.get_lib() is not None
    return out


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def painted(rng, h, w, ids, max_side=12):
    """Rectangles of the given ids painted in turn (later ones cover
    earlier)."""
    lab = np.zeros((h, w), np.int32)
    for i in ids:
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        lab[y:y + int(rng.integers(1, max_side)), x:x + int(rng.integers(1, max_side))] = i
    return lab


def maps(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros((17, 23), np.int32)
    if kind == "sparse_large_ids":
        ids = rng.choice(np.arange(1, 2_000_000), int(rng.integers(1, 30)), replace=False)
        return painted(rng, 40, 56, ids)
    if kind == "area_ties":
        lab = np.zeros((32, 48), np.int32)
        for k, i in enumerate(rng.permutation(np.arange(1, 13))):
            y, x = divmod(k, 6)
            lab[5 * y:5 * y + 3, 8 * x:8 * x + 4] = i         # 12 equal areas
        lab[20:24, 0:9] = 40                                  # and two of 36
        lab[26:30, 10:19] = 13
        return lab
    if kind == "slivers":
        lab = painted(rng, 30, 30, range(1, 10))
        for i in range(20, 26):                               # 1-5 pixels each
            ys, xs = rng.integers(0, 30, int(i - 19)), rng.integers(0, 30, int(i - 19))
            lab[ys, xs] = i
        return lab
    if kind == "many":
        return painted(rng, 64, 64, rng.permutation(np.arange(1, 150)), max_side=8)
    if kind == "negative":
        lab = painted(rng, 24, 24, range(1, 8))
        lab[rng.uniform(size=lab.shape) < 0.2] = -3
        return lab
    raise ValueError(kind)


KINDS = ["empty", "sparse_large_ids", "area_ties", "slivers", "many", "negative"]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("max_instances", [1, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_boxes_equal_kgtpu_native(kind, seed, max_instances):
    lab = maps(kind, seed)
    want = jax_native.boxes_from_label_map(lab, max_instances)
    _same(native.boxes_from_label_map(lab, max_instances), want)
    _same(transforms.boxes_from_label_map(lab, max_instances), want)
    _same(jax_transforms.boxes_from_label_map(lab, max_instances), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_numpy_boxes_and_renumbering_equal_the_compiled_ops(numpy_path, kind, seed):
    """The forced NumPy path gives the compiled op's results bit for bit."""
    lab = maps(kind, seed)
    for n in (1, 8, 64):
        got = transforms.boxes_from_label_map(lab, n)
        _same(got, jax_native.boxes_from_label_map(lab, n))
        want = jax_native.renumber_label_map(lab, got[2])
        out = transforms.renumber_label_map(lab, got[2])
        assert out.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_renumbering_equals_kgtpu_native(kind, seed):
    """The area-ranked remap, then remaps with duplicate ids, ids not in the
    map, zeros and negatives."""
    rng = np.random.default_rng(100 + seed)
    lab = maps(kind, seed)
    present = [int(i) for i in np.unique(lab) if i > 0] or [5]
    remaps = [transforms.boxes_from_label_map(lab, 16)[2],
              np.array([present[0], present[0], present[-1], 0], np.int32),
              rng.choice(present + [0, -2, 10 ** 7], 9).astype(np.int32),
              np.zeros(0, np.int32)]
    for remap in remaps:
        want = jax_native.renumber_label_map(lab, remap)
        for got in (native.renumber_label_map(lab, remap),
                    transforms.renumber_label_map(lab, remap),
                    jax_transforms.renumber_label_map(lab, remap)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_iou_equals_kgtpu_native(monkeypatch, kind, seed):
    """The dense f32 matrix, and the port's IoU of present ids on its
    compiled and NumPy paths."""
    rng = np.random.default_rng(200 + seed)
    gt = maps(kind, seed)
    pred = np.roll(gt, (1, -2), (0, 1))
    pred[rng.uniform(size=pred.shape) < 0.05] = 0
    pred = np.where(pred > 0, pred % 97 + 1, pred)
    want = jax_native.label_map_iou(pred, gt)
    got = native.label_map_iou(pred, gt)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    jiou, jp, jg = jax_eval.iou_from_label_maps(pred, gt)
    iou, p, g = evaluate.iou_from_label_maps(pred, gt)
    assert (p, g) == (jp, jg)
    np.testing.assert_array_equal(iou, jiou)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    iou_np, _, _ = evaluate.iou_from_label_maps(pred, gt)
    assert iou_np.dtype == iou.dtype
    np.testing.assert_array_equal(iou_np, iou)


def test_library_is_built_once_per_source_and_flags(lib):
    from kgtpu_torch.ops import _cuda
    path = _cuda.build("host_ops.cpp", host=True)
    assert path.startswith(_cuda.BUILD_DIR) and path == _cuda.build("host_ops.cpp", host=True)
    assert native.get_lib() is lib
