"""The port's host data path against kgtpu's: the PNG codec against cv2, the
eval-path resize against cv2's warpAffine, the dataset readers and the
inference loader against kgtpu's.

Tolerance: none.  Every comparison is exact (decoded pixels, label maps,
ids, image arrays): these are integer outputs of integer or f32 arithmetic
that the port reproduces operation for operation.
"""

import os
import struct
import warnings
import zlib

import cv2
import numpy as np
import pytest

from kgtpu.config import DataConfig as JaxDataConfig
from kgtpu.data.dsb2018 import DSB2018 as JaxDSB2018
from kgtpu.data.folder import ImageFolder as JaxImageFolder
from kgtpu.data.loader import _prepare_sample
from kgtpu.data.transforms import resize_sample as jax_resize_sample
from kgtpu_torch.config import DataConfig
from kgtpu_torch.data import png
from kgtpu_torch.data.dsb2018 import DSB2018
from kgtpu_torch.data.folder import ImageFolder
from kgtpu_torch.data.loader import prepare_sample
from kgtpu_torch.data.registry import build_dataset
from kgtpu_torch.data.transforms import resize_label_nearest, resize_sample

_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_CV_MODES = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def make_png(px, ctype, depth, filters, palette=None, trns=None, interlace=0):
    """A PNG file whose rows use `filters` in turn: the test's own encoder,
    written from the PNG specification (cv2 writes only some of these)."""
    h, w = px.shape[:2]
    ch = _CH[ctype]
    raw = (px.reshape(h, w, ch).astype(">u2").view(np.uint8) if depth == 16
           else px.reshape(h, w, ch).astype(np.uint8)).reshape(h, -1).astype(np.int32)
    bpp = max(ch * depth // 8, 1)
    rows = []
    for r in range(h):
        ft = filters[r % len(filters)]
        cur, prev = raw[r], (raw[r - 1] if r else np.zeros_like(raw[r]))
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1, _paeth(left, prev, ul)][ft]
        rows.append(np.concatenate([[ft], (cur - pred) & 255]).astype(np.uint8))
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                      0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes())) + \
        _chunk(b"IEND", b"")


def _cv2_read(path, mode):
    """cv2's read in the port's channel order (RGB / RGBA)."""
    want = cv2.imread(path, _CV_MODES[mode])
    if want.ndim == 3:
        want = cv2.cvtColor(want, cv2.COLOR_BGRA2RGBA if want.shape[2] == 4
                            else cv2.COLOR_BGR2RGB)
    return want


CASES = [(ct, d, tr) for ct in (0, 2, 4, 6) for d in (8, 16) for tr in (False,)] + [
    (3, 8, False), (3, 8, True)]
FILTERS = [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0, 3]]


@pytest.mark.parametrize("ctype,depth,trns", CASES)
@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: "f" + "".join(map(str, f)))
def test_png_read_matches_cv2(tmp_path, ctype, depth, trns, filters):
    """Every mode of `read_png` equals cv2.imread on every supported colour
    type, bit depth and row filter (smooth rows and noise, 37x53)."""
    rng = np.random.default_rng(ctype * 100 + depth + len(filters) + filters[0])
    h, w = 37, 53
    pal = tr = None
    if ctype == 3:
        pal = rng.integers(0, 256, (200, 3))
        px = rng.integers(0, 200, (h, w, 1))
        tr = bytes(rng.integers(0, 256, 150).astype(np.uint8)) if trns else None
    else:
        hi = 2 ** depth
        px = rng.integers(0, hi, (h, w, _CH[ctype]))
        px[:10] = (np.arange(w)[None, :, None] * 7 + np.arange(10)[:, None, None]) % hi
        px[10:14] = px[10:14, :, :1]               # grey pixels inside colour images
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(make_png(px, ctype, depth, filters, pal, tr))
    for mode in png.MODES:
        got, want = png.read_png(path, mode), _cv2_read(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("dtype,shape", [(np.uint16, (64, 80)), (np.uint8, (64, 80)),
                                         (np.uint8, (33, 47, 3)), (np.uint16, (20, 30, 3)),
                                         (np.uint8, (20, 31, 4))])
def test_png_write_reads_back_in_cv2(tmp_path, dtype, shape):
    """`write_png` output read by cv2.imread(IMREAD_UNCHANGED) is the array;
    the port reads cv2's own files back the same."""
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, arr)
    np.testing.assert_array_equal(_cv2_read(path, "unchanged"), arr)
    bgr = arr if arr.ndim == 2 else cv2.cvtColor(
        arr, cv2.COLOR_RGBA2BGRA if arr.shape[2] == 4 else cv2.COLOR_RGB2BGR)
    cv2.imwrite(path, bgr)
    np.testing.assert_array_equal(png.read_png(path, "unchanged"), arr)


def test_png_other_formats_raise(tmp_path):
    """The files this reader used to refuse read as cv2 reads them: a JPEG
    (through `imread.read_image`), an Adam7-interlaced and a 4-bit PNG
    (through `read_png` too), and since the variants were ported an
    arithmetic-coded JPEG, an RLE BMP and a 4x4-subsampled YCbCr TIFF.  The
    variant still queued (16-bit separate planes in "unchanged") raises
    naming its ROADMAP item; a corrupt
    chunk raises."""
    from test_torch_formats import make_bmp
    from test_torch_formats import make_png as make_any_png

    from kgtpu_torch.data.imread import QUEUED, UnsupportedImage, read_image
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, img)
    inter = str(tmp_path / "i.png")
    with open(inter, "wb") as f:
        f.write(make_any_png(img, 2, 8, interlace=1))
    low = str(tmp_path / "g4.png")
    with open(low, "wb") as f:
        f.write(make_any_png(rng.integers(0, 16, (8, 8)), 0, 4))
    for path in (jpg, inter, low):
        for mode in png.MODES:
            want = _cv2_read(path, mode)
            np.testing.assert_array_equal(read_image(path, mode), want)
            if path != jpg:
                np.testing.assert_array_equal(png.read_png(path, mode), want)
    ok, enc = cv2.imencode(".jpg", img)
    enc = enc.tobytes()
    at = enc.index(b"\xff\xc0")
    arith = str(tmp_path / "arith.jpg")
    with open(arith, "wb") as f:
        f.write(enc[:at + 1] + b"\xc9" + enc[at + 2:])
    rle = str(tmp_path / "rle.bmp")
    with open(rle, "wb") as f:
        f.write(make_bmp(np.zeros((8, 8)), 8, palette=np.zeros((256, 3)), compression=1))
    for path in (arith, rle):
        for mode in png.MODES:
            want = _cv2_read(path, mode)
            assert want is not None
            np.testing.assert_array_equal(read_image(path, mode), want)
    from tools.variant_encoders import tiff_image, tiff_ycbcr
    ycc = str(tmp_path / "y.tif")
    with open(ycc, "wb") as f:
        f.write(tiff_ycbcr(np.arange(64, dtype=np.uint8).reshape(8, 8), np.full((2, 2), 90),
                           np.full((2, 2), 200), 4, 4, rows_per_strip=8))
    for mode in png.MODES:
        np.testing.assert_array_equal(read_image(ycc, mode), _cv2_read(ycc, mode))
    planes = str(tmp_path / "p.tif")
    with open(planes, "wb") as f:
        f.write(tiff_image(np.full((6, 8, 3), 7, np.uint16), 2, bits=16, planar=2))
    assert cv2.imread(planes, cv2.IMREAD_UNCHANGED) is not None
    with pytest.raises(UnsupportedImage, match=QUEUED):
        read_image(planes, "unchanged")
    bad = str(tmp_path / "crc.png")
    data = bytearray(make_png(img, 2, 8, [0]))
    data[40] ^= 0xFF
    with open(bad, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(png.PNGFormatError, match="corrupt"):
        png.read_png(bad, "color")


def _nearest_pairs():
    rng = np.random.default_rng(0)
    fixed = [(517, 517, 512), (1000, 1000, 512), (400, 600, 128), (600, 400, 128),
             (260, 347, 512), (260, 347, 1024), (512, 512, 512), (96, 128, 128)]
    return fixed + [(int(a), int(b), int(c)) for a, b, c in zip(
        rng.integers(20, 1200, 40), rng.integers(20, 1200, 40),
        rng.choice([128, 256, 512, 1024], 40))]


def test_nearest_warp_sweep_matches_cv2():
    """`resize_label_nearest` equals kgtpu's cv2.warpAffine(INTER_NEAREST,
    BORDER_CONSTANT 0) with the scale matrix, on 48 size pairs including
    517->512, 1000->512 and 600x400->128 (each destination pixel's source
    pixel is read off a coordinate-coded map)."""
    for h, w, out in _nearest_pairs():
        lab = (np.arange(h * w).reshape(h, w) + 1).astype(np.float32)
        s = out / max(h, w)
        want = cv2.warpAffine(lab, np.array([[s, 0, 0], [0, s, 0]]), (out, out),
                              flags=cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT,
                              borderValue=0).astype(np.int64)
        got = resize_label_nearest((np.arange(h * w).reshape(h, w) + 1), out)
        assert int((got != want).sum()) == 0, (h, w, out)


@pytest.mark.parametrize("h,w,out", [(517, 517, 512), (1000, 1000, 512), (400, 600, 128),
                                     (512, 512, 512), (60, 90, 128)])
def test_resize_sample_matches_kgtpu(h, w, out):
    rng = np.random.default_rng(h + w)
    sample = {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
              "label_map": rng.integers(0, 300, (h, w)).astype(np.int32), "id": "x"}
    got, want = resize_sample(sample, out), jax_resize_sample(sample, out)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["label_map"], want["label_map"])
    assert got["label_map"].dtype == want["label_map"].dtype and got["id"] == "x"


def _write_rgb(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def test_image_folder_matches_kgtpu(tmp_path):
    """Same ids (nested paths flattened with '__', '~n' for repeats), order
    and pixels; a file of another format (here a JPEG, which used to raise
    when read) reads as kgtpu reads it."""
    rng = np.random.default_rng(3)
    for rel in ("a.png", "scan__1.png", "scan/1.png", "sub/deep/b.PNG", "c.png"):
        _write_rgb(str(tmp_path / rel), rng.integers(0, 256, (20, 30, 3), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "z.jpg"), rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    ours, theirs = ImageFolder(str(tmp_path)), JaxImageFolder(str(tmp_path))
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label_map"], b["label_map"])
    assert any("~" in i for i in ours._ids)


def make_dsb2018(root, ids, rng, size=(40, 56), masks=True):
    """A DSB2018 stage1 directory: RGB images and one binary mask PNG per
    instance (255 inside), overlapping instances included."""
    labels = {}
    for iid in ids:
        h, w = size
        _write_rgb(os.path.join(root, iid, "images", iid + ".png"),
                   rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        lab = np.zeros((h, w), np.int32)
        if masks:
            os.makedirs(os.path.join(root, iid, "masks"))
            for k in range(int(rng.integers(2, 6))):
                m = np.zeros((h, w), np.uint8)
                y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
                m[y:y + int(rng.integers(4, 12)), x:x + int(rng.integers(4, 12))] = 255
                cv2.imwrite(os.path.join(root, iid, "masks", f"m{k:02d}.png"), m)
                lab[m > 127] = k + 1
        labels[iid] = lab
    return labels


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dsb2018_matches_kgtpu(tmp_path, split):
    """The md5 split, the training-directory warning of split 'test', the
    images and the label maps painted from the masks."""
    rng = np.random.default_rng(5)
    make_dsb2018(str(tmp_path), [f"img{i:03d}" for i in range(30)], rng)
    with warnings.catch_warnings(record=True) as wa:
        warnings.simplefilter("always")
        ours = DSB2018(str(tmp_path), split=split)
    with warnings.catch_warnings(record=True) as wb:
        warnings.simplefilter("always")
        theirs = JaxDSB2018(str(tmp_path), split=split)
    assert ours.ids == theirs.ids and len(ours) > 0
    assert [str(w.message) for w in wa] == [str(w.message) for w in wb]
    assert (len(wa) == 1) == (split == "test")
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["id"] == b["id"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label_map"], b["label_map"])


@pytest.mark.parametrize("name,item", [("synthetic", 4), ("synthetic_hard", 4),
                                       ("synthetic_crowded", 4), ("coco", 10),
                                       ("neural_cells", 10)])
def test_registry_names_the_roadmap_item(tmp_path, name, item):
    """Every dataset kgtpu reads is ported: the synthetic names build
    kgtpu's test split (tests/test_torch_synthetic.py holds the images);
    coco and neural_cells, which used to raise naming their ROADMAP item,
    build their readers (tests/test_torch_datasets.py holds the samples)."""
    cfg = DataConfig(dataset=name, input_size=64)
    if item == 4:
        ds = build_dataset(cfg, split="test")
        assert (type(ds).__name__, len(ds), ds.seed, ds.size) == ("SyntheticCells", 16, 13, 64)
        return
    root = tmp_path / name
    img = np.zeros((16, 16, 3), np.uint8)
    if name == "coco":
        os.makedirs(root / "images")
        cv2.imwrite(str(root / "images" / "a.jpg"), img)
        with open(root / "annotations.json", "w") as f:
            f.write('{"images": [{"id": 1, "file_name": "a.jpg"}], "annotations": []}')
    else:
        os.makedirs(root / "images")
        cv2.imwrite(str(root / "images" / "a.tif"), img)
    ds = build_dataset(DataConfig(dataset=name, data_dir=str(root)), split="test")
    assert type(ds).__name__ == {"coco": "CocoDataset", "neural_cells": "NeuralCells"}[name]
    assert len(ds) == 1 and ds[0]["image"].shape == (16, 16, 3)


def test_registry_builds_the_ported_readers(tmp_path):
    rng = np.random.default_rng(6)
    make_dsb2018(str(tmp_path / "dsb"), ["a", "b"], rng, masks=False)
    ds = build_dataset(DataConfig(dataset="dsb2018", data_dir=str(tmp_path / "dsb")), "test")
    assert isinstance(ds, DSB2018) and ds.ids == ["a", "b"]
    ds = build_dataset(DataConfig(dataset="folder", data_dir=str(tmp_path / "dsb")), "test")
    assert isinstance(ds, ImageFolder) and len(ds) == 2
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset(DataConfig(dataset="nope"))


@pytest.mark.parametrize("image_only", [True, False])
@pytest.mark.parametrize("h,w", [(40, 56), (128, 128), (150, 90)])
def test_prepare_sample_matches_kgtpu(image_only, h, w):
    """The resized image, gain/bias, and (image_only=False) the area-ranked
    slots and renumbered label map; N = 4 slots drop the smallest."""
    rng = np.random.default_rng(h * w)
    label = np.zeros((h, w), np.int32)
    for k in range(6):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        label[y:y + int(rng.integers(2, 10)), x:x + int(rng.integers(2, 10))] = k + 3
    raw = {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
           "label_map": label, "id": "s"}
    got = prepare_sample(raw, DataConfig(input_size=128, max_instances=4),
                         image_only=image_only)
    want = _prepare_sample(raw, JaxDataConfig(input_size=128, max_instances=4),
                           augment=False, rng=np.random.default_rng(0),
                           image_only=image_only)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    # the augmenting path (ROADMAP item 4, done): kgtpu's with the same draws
    got = prepare_sample(raw, DataConfig(input_size=128, max_instances=4), augment=True,
                         image_only=image_only, rng=np.random.default_rng(1))
    want = _prepare_sample(raw, JaxDataConfig(input_size=128, max_instances=4),
                           augment=True, rng=np.random.default_rng(1),
                           image_only=image_only)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
