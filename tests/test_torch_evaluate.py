"""The port's evaluation and COCO export against kgtpu's, on random label
maps made from a seed.

kgtpu runs as it runs by default: `iou_from_label_maps` through its compiled
IoU op (`kgtpu/native`, built with g++), whose IoUs are f32.  Its NumPy
fallback divides in f64, which moves a match whose IoU lies within an f32
rounding of a threshold: one random image here (seed 2, image 2) scores
0.53 with the op and 0.5225 without, and the port must score 0.53, with its
own compiled op and with its NumPy path forced.

Tolerances: metrics and IoUs to 1e-12 (the same arithmetic); TP flags, RLE
counts, masks and COCO records exactly.
"""

import json

import numpy as np
import pytest

from kgtpu import coco_export as jax_coco
from kgtpu import evaluate as jax_eval
from kgtpu_torch import coco_export, evaluate

TOL = 1e-12


@pytest.fixture
def port_numpy_iou(monkeypatch):
    """The port without its compiled host ops, as on a machine without g++."""
    from kgtpu_torch import native
    monkeypatch.setattr(native, "get_lib", lambda: None)


def label_map(rng, h, w, n, max_side=14):
    """n rectangles and discs painted in turn (later ones cover earlier),
    some ids skipped, so ids are sparse and instances overlap."""
    lab = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[:h, :w]
    ids = np.sort(rng.choice(np.arange(1, 3 * n + 2), n, replace=False))
    for i in ids:
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(2, max_side)
        if rng.uniform() < 0.5:
            lab[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i
        else:
            lab[cy:cy + r, cx:cx + rng.integers(2, max_side)] = i
    return lab


def jitter(rng, gt):
    """A prediction near `gt`: shifted, some instances dropped, a few ghosts,
    renumbered to 1..P like test.py's output."""
    pred = np.roll(gt, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))), (0, 1))
    ids = [i for i in np.unique(pred) if i > 0]
    for i in ids:
        if rng.uniform() < 0.2:
            pred[pred == i] = 0
    ghost = label_map(rng, *gt.shape, int(rng.integers(0, 4)))
    pred = np.where((pred == 0) & (ghost > 0), ghost + 1000, pred)
    out = np.zeros_like(pred)
    for k, i in enumerate(i for i in np.unique(pred) if i > 0):
        out[pred == i] = k + 1
    return out


def records(seed, n_images=6, h=48, w=64):
    rng = np.random.default_rng(seed)
    recs = []
    for k in range(n_images):
        gt = label_map(rng, h, w, int(rng.integers(0, 12)))
        pred = jitter(rng, gt)
        if k == 0:
            pred = np.zeros_like(pred)                  # nothing predicted
        d = max(int(pred.max()), 1)
        scores = rng.uniform(0.1, 1.0, d + int(rng.integers(0, 3))).astype(np.float32)
        scores[rng.uniform(size=scores.size) < 0.2] = 0.5    # score ties
        recs.append({"pred_label": pred, "scores": scores, "gt_label": gt})
    ghosts = label_map(rng, h, w, 3)
    recs.append({"pred_label": ghosts, "gt_label": np.zeros((h, w), np.int32),
                 "scores": np.full(max(int(ghosts.max()), 1), 0.3, np.float32)})  # no GT
    return recs


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_protocols_match_kgtpu(seed):
    recs = records(seed)
    _close(evaluate.evaluate_dsb2018(recs), jax_eval.evaluate_dsb2018(recs))
    _close(evaluate.evaluate_coco(recs), jax_eval.evaluate_coco(recs))
    _close(evaluate.evaluate_aji(recs), jax_eval.evaluate_aji(recs))
    _close(evaluate.evaluate_pq(recs), jax_eval.evaluate_pq(recs))
    for t in (0.5, 0.75):
        _close(evaluate.evaluate_pq(recs, t), jax_eval.evaluate_pq(recs, t))
    with pytest.raises(ValueError):
        evaluate.evaluate_pq(recs, 0.4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_image_functions_match_kgtpu(seed):
    for rec in records(seed + 10):
        p, g, s = rec["pred_label"], rec["gt_label"], rec["scores"]
        iou, pid, gid = evaluate.iou_from_label_maps(p, g)
        jiou, jpid, jgid = jax_eval.iou_from_label_maps(p, g)
        assert (pid, gid) == (jpid, jgid)
        _close(iou, jiou)
        pm = evaluate.instance_masks_from_label_map(p)
        gm = evaluate.instance_masks_from_label_map(g)
        for a, b in zip(pm, jax_eval.instance_masks_from_label_map(p)):
            np.testing.assert_array_equal(a, b)
        _close(evaluate.mask_iou_matrix(pm, gm), jax_eval.mask_iou_matrix(pm, gm))
        ps = np.array([s[i - 1] for i in pid], np.float32)
        np.testing.assert_array_equal(evaluate.greedy_tp_flags(iou, ps),
                                      jax_eval.greedy_tp_flags(jiou, ps))
        _close(evaluate.dsb2018_image_score(iou, ps, len(gid)),
               jax_eval.dsb2018_image_score(jiou, ps, len(gid)))
        _close(evaluate.aji_image(p, g), jax_eval.aji_image(p, g))
        for a, b in zip(evaluate._pair_stats(p, g), jax_eval._pair_stats(p, g)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_iou_path_equals_kgtpu_default(port_numpy_iou, seed):
    """With the port's compiled op unavailable, its f32 NumPy quotients are
    kgtpu's default IoUs bit for bit, and every metric follows."""
    recs = records(seed + 20)
    for rec in recs:
        iou, pid, gid = evaluate.iou_from_label_maps(rec["pred_label"], rec["gt_label"])
        jiou, jpid, jgid = jax_eval.iou_from_label_maps(rec["pred_label"], rec["gt_label"])
        assert (pid, gid) == (jpid, jgid)
        if iou.size:
            assert iou.dtype == jiou.dtype == np.float32
        np.testing.assert_array_equal(iou, jiou)
    _close(evaluate.evaluate_dsb2018(recs), jax_eval.evaluate_dsb2018(recs))
    _close(evaluate.evaluate_coco(recs), jax_eval.evaluate_coco(recs))


@pytest.mark.parametrize("path", ["compiled", "numpy"])
def test_threshold_tie_scores_as_kgtpu_default(monkeypatch, path):
    """An image with a match whose IoU lies within an f32 rounding of a
    threshold scores what kgtpu scores by default (its compiled f32 IoU),
    not what kgtpu's f64 fallback scores, on both of the port's paths."""
    from kgtpu import native as jax_native
    from kgtpu_torch import native
    if path == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, native.error
    rec = [records(2)[2]]
    want = jax_eval.evaluate_dsb2018(rec)["mAP_dsb2018"]
    got = evaluate.evaluate_dsb2018(rec)["mAP_dsb2018"]
    assert got == want == pytest.approx(0.53, abs=TOL)
    monkeypatch.setattr(jax_native, "label_map_iou", lambda pred, gt: None)
    fallback = jax_eval.evaluate_dsb2018(rec)["mAP_dsb2018"]
    assert fallback == pytest.approx(0.5225, abs=TOL) and got != fallback


def test_empty_inputs_match_kgtpu():
    z = np.zeros((8, 8), np.int32)
    one = z.copy()
    one[2:5, 2:5] = 1
    for recs in ([], [{"pred_label": z, "gt_label": z, "scores": np.zeros(1, np.float32)}],
                 [{"pred_label": one, "gt_label": z, "scores": np.ones(1, np.float32)}],
                 [{"pred_label": z, "gt_label": one, "scores": np.zeros(1, np.float32)}]):
        for name in ("evaluate_dsb2018", "evaluate_coco", "evaluate_aji", "evaluate_pq"):
            _close(getattr(evaluate, name)(recs), getattr(jax_eval, name)(recs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_matches_kgtpu(seed):
    rng = np.random.default_rng(seed)
    masks = [rng.uniform(size=(13, 17)) < 0.3, np.zeros((5, 4), bool), np.ones((3, 6), bool),
             np.zeros((0, 0), bool)]
    lab = label_map(rng, 30, 40, 5)
    masks += [lab == i for i in np.unique(lab)]
    for m in masks:
        rle = coco_export.mask_to_rle(m)
        assert rle == jax_coco.mask_to_rle(m)
        assert sum(rle["counts"]) == m.size
        np.testing.assert_array_equal(coco_export.rle_to_mask(rle), jax_coco.rle_to_mask(rle))
        np.testing.assert_array_equal(coco_export.rle_to_mask(rle), m)


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_records_and_json_match_kgtpu(tmp_path, seed):
    """Slot-aligned records (label id i + 1 <-> boxes[i], scores[i]; ids past
    the scores are skipped) and the written file, exactly."""
    rng = np.random.default_rng(seed)
    per_image = []
    for k in range(3):
        lab = label_map(rng, 40, 50, int(rng.integers(0, 8)))
        d = max(int(lab.max()) - 1, 0)            # the largest id has no slot
        boxes = rng.uniform(0, 50, (d, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, d).astype(np.float32)
        per_image.append({"id": f"img{k}" if k else 7, "label_map": lab,
                          "boxes": boxes, "scores": scores})
        assert (coco_export.coco_results_for_image(per_image[-1]["id"], lab, boxes, scores, 2)
                == jax_coco.coco_results_for_image(per_image[-1]["id"], lab, boxes, scores, 2))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert coco_export.write_coco_json(a, per_image) == jax_coco.write_coco_json(b, per_image)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)
