"""The port's dataset readers against kgtpu's, sample by sample (id, image
and label map): COCO (polygons, uncompressed and compressed RLE, an RLE of
another size, crowd regions, both annotation layouts and the splits), the
neural-cells reader (label maps and per-instance mask folders in every
format, with a stray file that no reader can read), the image folder and
DSB2018 over files of every format; and the committed fixtures of
assets_torch/formats against kgtpu's references, as chip_smoke.py [12]
checks them on the card.

Tolerance: none.  Every comparison is exact.
"""

import json
import os
import warnings

import cv2
import numpy as np
import pytest
from PIL import Image

from kgtpu.data.coco import CocoDataset as JaxCoco
from kgtpu.data.coco import rle_counts_from_string as jax_rle_counts
from kgtpu.data.dsb2018 import DSB2018 as JaxDSB2018
from kgtpu.data.folder import ImageFolder as JaxImageFolder
from kgtpu.data.neural_cells import NeuralCells as JaxNeuralCells
from kgtpu_torch.data.coco import CocoDataset, rle_counts_from_string
from kgtpu_torch.data.dsb2018 import DSB2018
from kgtpu_torch.data.folder import ImageFolder
from kgtpu_torch.data.imread import read_image
from kgtpu_torch.data.neural_cells import NeuralCells
from tools.make_torch_format_assets import dataset_layout, fixtures, rle_encode, sha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = os.path.join(ROOT, "assets_torch", "formats")
REFERENCE = os.path.join(ROOT, "assets_torch", "kgtpu_reference_formats.npz")


def assert_same_samples(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for k in range(len(ours)):
        a, b = ours[k], theirs[k]
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["image"], b["image"], err_msg=a["id"])
        assert a["label_map"].dtype == b["label_map"].dtype
        np.testing.assert_array_equal(a["label_map"], b["label_map"], err_msg=a["id"])


def _blobs(rng, h, w, n):
    """A label map of n overlapping ellipses (later ones on top)."""
    lab = np.zeros((h, w), np.int32)
    for k in range(1, n + 1):
        cv2.ellipse(lab, (int(rng.integers(5, w - 5)), int(rng.integers(5, h - 5))),
                    (int(rng.integers(3, 12)), int(rng.integers(3, 9))),
                    float(rng.integers(0, 180)), 0, 360, k, -1)
    return lab


def _coco_tree(root, rng, layout):
    """Five images (JPEG, PNG, TIFF, BMP) with polygon (non-convex, several
    rings), RLE (plain and compressed), other-size RLE and crowd
    annotations; `layout` "single" (annotations.json, hash-split) or
    "split" (annotations/instances_<split>.json, file names found under
    images/)."""
    images, anns, aid = [], [], 1
    names = ["a.jpg", "b.png", "c.tif", "d.bmp", "e.jpeg"]
    sub = "images"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    for n, name in enumerate(names):
        h, w = 45 + 2 * n, 61 - n
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(root, sub, name), img)
        images.append({"id": n + 1, "file_name": name if layout == "split" else f"images/{name}",
                       "height": h, "width": w})
        lab = _blobs(rng, h, w, 6)
        for k in range(1, 7):
            m = lab == k
            if not m.any():
                continue
            if k % 3 == 0:
                seg = {"counts": rle_encode(m, compressed=k == 3), "size": [h, w]}
            else:
                cs, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_LIST,
                                         cv2.CHAIN_APPROX_NONE)
                seg = [c.reshape(-1).tolist() for c in cs]
                if k == 4:            # a non-convex star and a float ring too
                    cx, cy = w / 2, h / 2
                    star = []
                    for i in range(10):
                        r = (12 if i % 2 else 5) + 0.37
                        star += [cx + r * np.cos(i * np.pi / 5), cy + r * np.sin(i * np.pi / 5)]
                    seg.append(star)
                    seg.append([1, 1, 3])                       # too short: dropped
            anns.append({"id": aid, "image_id": n + 1, "iscrowd": 0, "segmentation": seg})
            aid += 1
        half = np.zeros((h // 2 + 1, w // 3), bool)
        half[2:9, 3:11] = True
        anns.append({"id": aid, "image_id": n + 1, "iscrowd": 0, "segmentation":
                     {"counts": rle_encode(half, True), "size": list(half.shape)}})
        anns.append({"id": aid + 1, "image_id": n + 1, "iscrowd": 1,
                     "segmentation": [[0, 0, 20, 0, 20, 20]]})
        anns.append({"id": aid + 2, "image_id": n + 1, "iscrowd": 0, "segmentation": []})
        aid += 3
    doc = {"images": images, "annotations": anns}
    if layout == "split":
        os.makedirs(os.path.join(root, "annotations"))
        for split in ("train", "val"):
            with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
                json.dump(doc, f)
    else:
        with open(os.path.join(root, "annotations.json"), "w") as f:
            json.dump(doc, f)


@pytest.mark.parametrize("layout", ["single", "split"])
def test_coco_matches_kgtpu(tmp_path, layout):
    rng = np.random.default_rng(len(layout))
    _coco_tree(str(tmp_path), rng, layout)
    splits = ("train", "val", "test")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in splits:
            ours, theirs = CocoDataset(str(tmp_path), split), JaxCoco(str(tmp_path), split)
            assert ours.ids == theirs.ids
            if len(theirs):
                assert_same_samples(ours, theirs)
    assert sum(len(CocoDataset(str(tmp_path), s)) for s in ("train", "val")) >= 5


def test_coco_rle_codec_matches_kgtpu():
    rng = np.random.default_rng(0)
    for _ in range(20):
        m = rng.random((int(rng.integers(1, 40)), int(rng.integers(1, 40)))) < rng.random()
        s = rle_encode(m, compressed=True)
        assert rle_counts_from_string(s) == jax_rle_counts(s) == rle_encode(m, False)


def _neural_tree(root, rng):
    """Images in every format; labels/ (uint16 PNG) for some ids, masks/
    folders for others, with masks in PNG, BMP, TIFF and JPEG, a stray text
    file and a subdirectory, which no reader reads."""
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    exts = [".png", ".tif", ".tiff", ".jpg", ".jpeg", ".bmp", ".png", ".tif"]
    for n, ext in enumerate(exts):
        iid = f"id{n}"
        h, w = 40 + n, 50 - n
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        path = os.path.join(root, "images", iid + ext)
        if ext in (".tif", ".tiff") and n % 2:
            Image.fromarray(img).save(path, compression="tiff_lzw")
        else:
            cv2.imwrite(path, img)
        lab = _blobs(rng, h, w, 5)
        if n < 4:
            cv2.imwrite(os.path.join(root, "labels", iid + ".png"), lab.astype(np.uint16))
            continue
        mdir = os.path.join(root, "masks", iid)
        os.makedirs(mdir)
        for k in range(1, 6):
            m = ((lab == k) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(mdir, f"m{k}" + (".png", ".bmp", ".tif", ".png",
                                                      ".jpg")[k - 1]), m)
        with open(os.path.join(mdir, "m3_notes.txt"), "w") as f:
            f.write("not an image\n")
        os.makedirs(os.path.join(mdir, "m4_dir"))
    with open(os.path.join(root, "images", "readme.txt"), "w") as f:
        f.write("skipped by the extension filter\n")


def test_neural_cells_matches_kgtpu(tmp_path):
    """Both layouts, every split, sample by sample; the stray file in masks/
    is skipped (cv2.imread -> None in kgtpu) and still takes its id."""
    _neural_tree(str(tmp_path), np.random.default_rng(5))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in ("train", "val", "test"):
            ours = NeuralCells(str(tmp_path), split)
            theirs = JaxNeuralCells(str(tmp_path), split)
            assert ours.paths == theirs.paths
            if len(theirs):
                assert_same_samples(ours, theirs)
    paths = NeuralCells(str(tmp_path), "train").paths + NeuralCells(str(tmp_path), "val").paths
    assert {os.path.splitext(p)[1] for p in paths} == {".png", ".tif", ".tiff", ".jpg",
                                                      ".jpeg", ".bmp"}


def test_folder_and_dsb2018_read_every_format_like_kgtpu(tmp_path):
    """ImageFolder over JPEG, TIFF (16-bit too), BMP and PNG files; DSB2018
    with masks in several formats and a stray file, which kgtpu skips."""
    rng = np.random.default_rng(9)
    folder = tmp_path / "f"
    os.makedirs(folder / "sub")
    for n, ext in enumerate([".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".png"]):
        img = rng.integers(0, 256, (33 + n, 47, 3)).astype(np.uint8)
        cv2.imwrite(str(folder / ("sub" if n % 2 else ".") / f"x{n}{ext}"),
                    img.astype(np.uint16) * 257 if ext == ".tiff" else img)
    assert_same_samples(ImageFolder(str(folder)), JaxImageFolder(str(folder)))
    dsb = tmp_path / "d"
    for iid in ("a", "b"):
        os.makedirs(dsb / iid / "images")
        os.makedirs(dsb / iid / "masks")
        cv2.imwrite(str(dsb / iid / "images" / f"{iid}.png"),
                    rng.integers(0, 256, (30, 40, 3)).astype(np.uint8))
        lab = _blobs(rng, 30, 40, 3)
        for k, ext in zip(range(1, 4), (".png", ".bmp", ".tif")):
            cv2.imwrite(str(dsb / iid / "masks" / f"m{k}{ext}"),
                        ((lab == k) * 255).astype(np.uint8))
        (dsb / iid / "masks" / "m2_notes.txt").write_text("stray")
    for split in ("train", "val"):
        ours, theirs = DSB2018(str(dsb), split), JaxDSB2018(str(dsb), split)
        assert ours.ids == theirs.ids
        if theirs.ids:
            assert_same_samples(ours, theirs)


def test_dsb2018_skips_a_mask_cv2_cannot_read(tmp_path):
    """A sample whose masks are a PNG and a 16-bit palette TIFF with a
    ColorMap, which cv2 cannot read: kgtpu's DSB2018 skips the TIFF, and so
    does the port's (it raises UnreadableImage for it), giving one
    instance."""
    from tools import variant_encoders as ve
    rng = np.random.default_rng(4)
    root = tmp_path / "d"
    os.makedirs(root / "a" / "images")
    os.makedirs(root / "a" / "masks")
    cv2.imwrite(str(root / "a" / "images" / "a.png"),
                rng.integers(0, 256, (24, 20, 3)).astype(np.uint8))
    lab = _blobs(rng, 24, 20, 2)
    cv2.imwrite(str(root / "a" / "masks" / "m1.png"), ((lab == 1) * 255).astype(np.uint8))
    cmap = {320: (ve.SHORT, rng.integers(0, 65536, 3 * 65536).tolist())}
    (root / "a" / "masks" / "m2.tif").write_bytes(
        ve.tiff_image(((lab == 2) * 65535).astype(np.uint16), 3, bits=16, tags=cmap))
    assert cv2.imread(str(root / "a" / "masks" / "m2.tif"), cv2.IMREAD_GRAYSCALE) is None
    ours, theirs = DSB2018(str(root), "train"), JaxDSB2018(str(root), "train")
    assert ours.ids == theirs.ids == ["a"]
    assert_same_samples(ours, theirs)
    assert np.unique(ours[0]["label_map"]).tolist() == [0, 1]


@pytest.fixture(scope="module")
def reference():
    return np.load(REFERENCE)


def test_committed_fixtures_decode_as_cv2(reference):
    """Every fixture of assets_torch/formats in every mode has the sha256,
    shape and dtype of cv2's decode (what chip_smoke.py [12](a) checks on
    the card's host)."""
    decodes = json.loads(str(reference["decode_json"]))
    assert {d["path"] for d in decodes} == set(fixtures(FORMATS))
    for d in decodes:
        got = read_image(os.path.join(FORMATS, d["path"]), d["mode"])
        assert (sha(got), list(got.shape), str(got.dtype)) == (
            d["sha256"], d["shape"], d["dtype"]), (d["path"], d["mode"])


@pytest.mark.parametrize("name", ["coco", "neural_cells"])
def test_committed_datasets_match_kgtpu(tmp_path, reference, name):
    """The coco and neural_cells trees built from the committed fixtures
    give, per split and sample, kgtpu's image and label map (by sha256)."""
    want = json.loads(str(reference["datasets_json"]))
    cls = {"coco": CocoDataset, "neural_cells": NeuralCells}[name]
    root = dataset_layout(FORMATS, str(tmp_path), name)
    for split in ("train", "val"):
        ds = cls(root, split=split)
        got = [{"id": s["id"], "image": sha(s["image"]),
                "label_map": sha(s["label_map"].astype(np.int32)),
                "shape": list(s["label_map"].shape)} for s in (ds[k] for k in range(len(ds)))]
        assert got == want[f"{name}/{split}"], split
