#!/usr/bin/env python
"""Make the image-format and dataset fixtures of the PyTorch port under
assets_torch/formats/, and kgtpu's references for them.

    python tools/make_torch_format_assets.py [--out assets_torch]

Runs on the CPU where cv2, PIL, jax and kgtpu are installed (after
tools/make_torch_eval_assets.py, whose synthetic_hard images and flagship it
reads), and writes:

  formats/jpeg/<id>.jpg        the 16 synthetic_hard test images as baseline
                               JPEG: cv2, quality 95, 4:2:0, a restart
                               interval of 8 MCUs
  formats/mixed/               4 of them, cut to their central 256x256, each
                               as progressive JPEG (cv2), tiled TIFF with
                               deflate and predictor 2 (written here: PIL
                               ignores tile=), LZW strip TIFF (PIL), 16-bit
                               RGB TIFF (cv2, deflate) and 24-bit BMP (cv2)
  formats/coco_annotations.json  COCO annotations over formats/jpeg (file
                               names images/<id>.jpg): each instance of the
                               label maps as polygons (its outer contours), as
                               uncompressed RLE (every 5th instance) or as
                               compressed RLE (every 7th), plus one iscrowd
                               region and one RLE of half the image size
  formats/neural_cells/        a neural-cells tree of 10 ids: images/ as
                               deflate TIFF (256x256 cuts of 10 more images),
                               labels/<id>.png (uint16) for 8 ids, masks/<id>/
                               for the other 2 (PNG, BMP and TIFF masks and a
                               stray text file that no reader can read)
  kgtpu_reference_formats.npz  `decode_json`: for every fixture and read mode,
                               the sha256, shape and dtype of cv2.imread's
                               result in RGB order (kgtpu's reads);
                               `labels_<dtype>`, `counts_<dtype>` and
                               `metrics_json`: kgtpu's own float32 and
                               bfloat16 runs of the flagship over
                               formats/jpeg, as kgtpu_reference.npz holds
                               them for the PNGs; `datasets_json`: the sha256
                               of the image and label map of every sample of
                               kgtpu's coco and neural_cells readers, per
                               split, on the layouts `dataset_layout` builds.

The fixtures and the reference together stay under 8 MiB.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MODES = ("color", "gray", "unchanged")
MIXED_IDS = 4
NEURAL_IDS = 10
NEURAL_MASK_IDS = 2


def sha(a) -> str:
    import numpy as np
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes()).hexdigest()


def tiled_tiff(path: str, img, tile: int = 128) -> None:
    """An 8-bit RGB TIFF in tiles, deflate with predictor 2 (PIL cannot
    write tiles); cv2 reading it back is the check that it is valid."""
    import numpy as np
    h, w, c = img.shape
    blocks = []
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            t = np.zeros((tile, tile, c), np.uint8)
            sub = img[y:y + tile, x:x + tile]
            t[:sub.shape[0], :sub.shape[1]] = sub
            d = t.astype(np.int16)
            d[:, 1:] = d[:, 1:] - t[:, :-1]
            blocks.append(zlib.compress((d & 255).astype(np.uint8).tobytes(), 9))
    data = bytearray(b"II*\0\0\0\0\0")
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b + b"\0" * (len(b) % 2)
    bits_at = len(data)
    data += struct.pack("<3H", 8, 8, 8) + b"\0\0"
    offs_at = len(data)
    data += struct.pack(f"<{len(blocks)}I", *offsets)
    cnts_at = len(data)
    data += struct.pack(f"<{len(blocks)}I", *[len(b) for b in blocks])
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, bits_at), (259, 3, 1, 8),
            (262, 3, 1, 2), (277, 3, 1, 3), (284, 3, 1, 1), (317, 3, 1, 2),
            (322, 3, 1, tile), (323, 3, 1, tile), (324, 4, len(blocks), offs_at),
            (325, 4, len(blocks), cnts_at)]
    ifd = len(data)
    data[4:8] = struct.pack("<I", ifd)
    data += struct.pack("<H", len(tags))
    for tag, typ, count, value in tags:
        if typ == 3 and count == 1:
            val = struct.pack("<HH", value, 0)
        else:                           # a LONG, or the offset of the values
            val = struct.pack("<I", value)
        data += struct.pack("<HHI", tag, typ, count) + val
    data += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(bytes(data))


def rle_encode(mask, compressed: bool):
    """COCO RLE of a bool mask: column-major runs, background first; the
    compressed form is pycocotools' string codec."""
    import numpy as np
    flat = mask.reshape(-1, order="F").astype(np.uint8)
    runs, cur, n = [], 0, 0
    for v in flat:
        if v == cur:
            n += 1
        else:
            runs.append(n)
            cur, n = v, 1
    runs.append(n)
    if not compressed:
        return runs
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def coco_annotations(labels: dict) -> dict:
    """annotations.json over formats/jpeg (see the module docstring)."""
    import cv2
    import numpy as np
    images, anns = [], []
    aid = 1
    for n, (iid, lab) in enumerate(sorted(labels.items())):
        h, w = lab.shape
        images.append({"id": n + 1, "file_name": f"images/{iid}.jpg", "height": h, "width": w})
        for k in range(1, int(lab.max()) + 1):
            m = lab == k
            if not m.any():
                continue
            if k % 7 == 0 or k % 5 == 0:
                seg = {"counts": rle_encode(m, compressed=k % 7 == 0), "size": [h, w]}
            else:
                cs, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                         cv2.CHAIN_APPROX_SIMPLE)
                seg = [c.reshape(-1).astype(float).tolist() for c in cs if len(c) >= 3]
                if not seg:
                    continue
            anns.append({"id": aid, "image_id": n + 1, "category_id": 1, "iscrowd": 0,
                         "segmentation": seg})
            aid += 1
        if n == 0:        # a crowd region, which the readers skip
            anns.append({"id": aid, "image_id": 1, "category_id": 1, "iscrowd": 1,
                         "segmentation": [[0, 0, 60, 0, 60, 60, 0, 60]]})
            aid += 1
        if n == 1:        # an RLE of half the size: resized to the image, nearest
            half = np.zeros((h // 2, w // 2), bool)
            half[10:40, 20:70] = True
            anns.append({"id": aid, "image_id": 2, "category_id": 1, "iscrowd": 0,
                         "segmentation": {"counts": rle_encode(half, True),
                                          "size": [h // 2, w // 2]}})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "cell"}]}


def dataset_layout(formats: str, tmp: str, name: str) -> str:
    """The data_dir of the coco or neural_cells dataset built from the
    committed fixtures under `tmp` (coco: annotations.json and images/ with
    formats/jpeg's files; neural_cells: formats/neural_cells as it is)."""
    if name == "neural_cells":
        return os.path.join(formats, "neural_cells")
    root = os.path.join(tmp, "coco")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    shutil.copy(os.path.join(formats, "coco_annotations.json"),
                os.path.join(root, "annotations.json"))
    for f in sorted(os.listdir(os.path.join(formats, "jpeg"))):
        shutil.copy(os.path.join(formats, "jpeg", f), os.path.join(root, "images", f))
    return root


def fixtures(formats: str) -> list[str]:
    """Every image fixture, relative to `formats`, in a fixed order."""
    out = []
    for sub in ("jpeg", "mixed", os.path.join("neural_cells", "images")):
        out += [os.path.join(sub, f) for f in sorted(os.listdir(os.path.join(formats, sub)))]
    masks = os.path.join(formats, "neural_cells", "masks")
    for d in sorted(os.listdir(masks)):
        out += [os.path.join("neural_cells", "masks", d, f)
                for f in sorted(os.listdir(os.path.join(masks, d))) if not f.endswith(".txt")]
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "assets_torch"))
    a = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from kgtpu import checkpoint, evaluate, native
    from kgtpu.config import Config
    from kgtpu.data.coco import CocoDataset
    from kgtpu.data.folder import ImageFolder
    from kgtpu.data.loader import _prepare_sample
    from kgtpu.data.neural_cells import NeuralCells
    from kgtpu.infer import build_infer_fn
    from kgtpu.models import KGNet
    from tools.make_torch_eval_assets import BATCH, FLAGSHIP, _score

    src = os.path.join(a.out, "synthetic_hard")
    formats = os.path.join(a.out, "formats")
    shutil.rmtree(formats, ignore_errors=True)
    for sub in ("jpeg", "mixed", "neural_cells/images", "neural_cells/labels"):
        os.makedirs(os.path.join(formats, sub))
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(src, "images")))
    bgr = {i: cv2.imread(os.path.join(src, "images", f"{i}.png"), cv2.IMREAD_COLOR) for i in ids}
    gt = {i: cv2.imread(os.path.join(src, "labels", f"{i}.png"), cv2.IMREAD_UNCHANGED)
          for i in ids}

    for i in ids:
        cv2.imwrite(os.path.join(formats, "jpeg", f"{i}.jpg"), bgr[i],
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_RST_INTERVAL, 8])
    mixed = os.path.join(formats, "mixed")
    for i in ids[:MIXED_IDS]:
        cut = np.ascontiguousarray(bgr[i][128:384, 128:384])
        cv2.imwrite(os.path.join(mixed, f"{i}_progressive.jpg"), cut,
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        tiled_tiff(os.path.join(mixed, f"{i}_tiled.tif"), cut[..., ::-1])
        Image.fromarray(cut[..., ::-1]).save(os.path.join(mixed, f"{i}_lzw.tif"),
                                             compression="tiff_lzw")
        cv2.imwrite(os.path.join(mixed, f"{i}_rgb16.tif"), cut.astype(np.uint16) * 257 + 3,
                    [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE])
        cv2.imwrite(os.path.join(mixed, f"{i}.bmp"), cut)

    with open(os.path.join(formats, "coco_annotations.json"), "w") as f:
        json.dump(coco_annotations(gt), f, separators=(",", ":"))

    nc = os.path.join(formats, "neural_cells")
    for n, i in enumerate(ids[MIXED_IDS:MIXED_IDS + NEURAL_IDS]):
        cid = f"cell_{n:02d}"
        cut = np.ascontiguousarray(bgr[i][128:384, 128:384])
        lab = gt[i][128:384, 128:384]
        Image.fromarray(cut[..., ::-1]).save(os.path.join(nc, "images", f"{cid}.tif"),
                                             compression="tiff_adobe_deflate")
        if n < NEURAL_IDS - NEURAL_MASK_IDS:
            cv2.imwrite(os.path.join(nc, "labels", f"{cid}.png"), lab.astype(np.uint16))
            continue
        mdir = os.path.join(nc, "masks", cid)
        os.makedirs(mdir)
        for k, v in enumerate(v for v in np.unique(lab) if v):
            m = ((lab == v) * 255).astype(np.uint8)
            ext = (".png", ".bmp", ".tif")[k % 3]
            cv2.imwrite(os.path.join(mdir, f"m{k:02d}{ext}"), m)
        with open(os.path.join(mdir, "m05_notes.txt"), "w") as f:
            f.write("not an image: the readers skip it\n")

    # cv2's decodes, in RGB order, as kgtpu's readers see them
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    decode = []
    for rel in fixtures(formats):
        for mode in MODES:
            img = cv2.imread(os.path.join(formats, rel), flags[mode])
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                                   else cv2.COLOR_BGR2RGB)
            decode.append({"path": rel, "mode": mode, "sha256": sha(img),
                           "shape": list(img.shape), "dtype": str(img.dtype)})

    native.label_map_iou = lambda pred, gt_: None          # kgtpu's NumPy IoU
    params, extra = checkpoint.restore_bundle(FLAGSHIP, use_ema=True)
    stored = checkpoint.decode_config(extra)
    folder = ImageFolder(os.path.join(formats, "jpeg"))
    result = {"decode_json": np.array(json.dumps(decode)),
              "ids": np.array([folder[i]["id"] for i in range(len(folder))])}
    metrics = {"source": "tools/make_torch_format_assets.py", "jax": jax.__version__,
               "cv2": cv2.__version__, "weights": "runs/kg_hard1024/model_99 (EMA)",
               "data": "assets_torch/formats/jpeg"}
    import dataclasses
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(Config(), model=dataclasses.replace(
            stored.model, compute_dtype=dtype))
        infer = build_infer_fn(KGNet(cfg=cfg.model), cfg)
        rng = np.random.default_rng(0)
        labels, counts, recs = [], [], []
        for start in range(0, len(folder), BATCH):
            raws = [folder[i] for i in range(start, min(start + BATCH, len(folder)))]
            imgs = np.stack([_prepare_sample(r, cfg.data, augment=False, rng=rng,
                                             image_only=True)["image"] for r in raws])
            o = infer(params, jnp.asarray(imgs))
            for k, raw in enumerate(raws):
                lab = np.asarray(o["label_map"][k]).astype(np.uint16)
                valid = np.asarray(o["valid"][k])
                kept = np.asarray(o["scores"][k])[valid]
                labels.append(lab)
                counts.append(int(valid.sum()))
                scores = np.zeros(max(int(lab.max()), len(kept), 1), np.float32)
                scores[:len(kept)] = kept
                recs.append({"pred_label": lab.astype(np.int32), "scores": scores,
                             "gt_label": gt[raw["id"]].astype(np.int32)})
        metrics[dtype] = _score(evaluate, recs)
        result[f"labels_{dtype}"] = np.stack(labels)
        result[f"counts_{dtype}"] = np.array(counts, np.int32)
        print(dtype, counts, json.dumps(metrics[dtype]))
    result["metrics_json"] = np.array(json.dumps(metrics))

    datasets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cls in (("coco", CocoDataset), ("neural_cells", NeuralCells)):
            root = dataset_layout(formats, tmp, name)
            for split in ("train", "val"):
                ds = cls(root, split=split)
                datasets[f"{name}/{split}"] = [
                    {"id": s["id"], "image": sha(s["image"]),
                     "label_map": sha(s["label_map"].astype(np.int32)),
                     "shape": list(s["label_map"].shape)}
                    for s in (ds[k] for k in range(len(ds)))]
    result["datasets_json"] = np.array(json.dumps(datasets))
    np.savez_compressed(os.path.join(a.out, "kgtpu_reference_formats.npz"), **result)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(formats)
                for f in fs) + os.path.getsize(os.path.join(a.out, "kgtpu_reference_formats.npz"))
    print(f"{len(decode)} decodes, datasets {[(k, len(v)) for k, v in datasets.items()]}, "
          f"{total / 2**20:.2f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
