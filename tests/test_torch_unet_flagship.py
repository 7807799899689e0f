"""The unet quality flagship through the port on the CPU in f32: the committed
EMA weights (assets_torch/unet_ema, converted from runs/kg_unet1024/model_99)
served by `python -m kgtpu_torch.cli.test` (in-process) on the first 2 of
the 16 committed 512x512 synthetic_hard images, alone and as the mask member
of the heterogeneous ensemble with the hourglass flagship
(assets_torch/flagship_ema, mean vote), held against kgtpu's committed f32
runs of the same flags (assets_torch/kgtpu_reference_unet.npz): every
instance count equal and at most 16 label-map pixels off per image (the
whole 16-image runs on this CPU: 0 or 1 off).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from kgtpu_torch.cli import test as test_cli
from kgtpu_torch.data.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets_torch")
PIXELS_OFF_TOL = 16
FLAGS = {"unet": ["--batch_size", "2"],
         "ensemble": ["--ensemble", os.path.join(ASSETS, "flagship_ema"), "--tta_vote", "mean",
                      "--test_scales", "1.0", "--batch_size", "2"]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_unet_flagship_equals_kgtpu_reference(tmp_path, name):
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference_unet.npz"))
    ids = [str(i) for i in ref["ids"]][:2]
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in ids:
        shutil.copy(os.path.join(ASSETS, "synthetic_hard", "images", f"{i}.png"), folder)
    out = str(tmp_path / "out")
    assert test_cli.main(["--dataset", "folder", "--data_dir", str(folder), "--weights",
                          os.path.join(ASSETS, "unet_ema"), "--use_ema",
                          "--compute_dtype", "float32", "--device", "cpu",
                          "--save_dir", out] + FLAGS[name]) == 0
    with open(os.path.join(out, "detections.json")) as f:
        det = json.load(f)
    assert det["ensemble"] == (FLAGS[name][1:2] if name == "ensemble" else [])
    got = {r["id"]: r for r in det["images"]}
    for k, i in enumerate(ids):
        assert got[i]["num_instances"] == int(ref[f"counts_{name}_float32"][k]) >= 15
        lab = read_png(os.path.join(out, f"{i}_label.png"), "unchanged")
        off = int((lab != ref[f"labels_{name}_float32"][k]).sum())
        assert off <= PIXELS_OFF_TOL, f"{i}: {off} label-map pixels off kgtpu's"


def test_unet_checkpoint_rebuilds_the_flagship_architecture():
    """The stored config is the trained one, and every tensor loads."""
    from kgtpu_torch import checkpoint
    from kgtpu_torch.models import KGNet
    sd, extra = checkpoint.restore_bundle(os.path.join(ASSETS, "unet_ema"), use_ema=True)
    cfg = checkpoint.decode_config(extra)
    m = cfg.model
    assert (m.backbone, m.base_channels, m.hg_depth, m.norm, m.compute_dtype) == (
        "unet", 128, 4, "group", "bfloat16")
    model = KGNet(m)
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 31_965_770
    assert all(v.dtype == torch.float32 for v in sd.values())
