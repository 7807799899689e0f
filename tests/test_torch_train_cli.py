"""The port's training CLI (`python -m kgtpu_torch.cli.train`) on the CPU at
tiny sizes: its flags and config against kgtpu's train.py parser, what
a run writes (checkpoints, metrics.jsonl, best.json
and the dataset statistics kgtpu's train.py stores), resume, init_from,
retention, and the learning gate of tests/test_e2e.py run through the CLI.

Tolerances: the statistics equal kgtpu's exactly (f32); a resumed run's
parameters, optimizer moments and count, step and EMA equal the
uninterrupted run's bitwise; the learning gate clears test_e2e.py's floors
(mAP_dsb2018 > 0.22, AP50 > 0.58 on 4 val images).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from kgtpu import config as jconfig
from kgtpu.data.registry import build_dataset as jax_build_dataset
from kgtpu.data.transforms import boxes_from_label_map as jax_boxes_from_label_map
from kgtpu_torch import checkpoint, evaluate
from kgtpu_torch import config as tconfig
from kgtpu_torch.cli import train
from kgtpu_torch.data.loader import prepare_sample
from kgtpu_torch.data.registry import build_dataset
from kgtpu_torch.infer import build_infer_fn
from kgtpu_torch.models import KGNet

TINY_FLAGS = ["--backbone", "hourglass_lite", "--num_stacks", "1", "--roi_size", "8",
              "--mask_size", "16", "--K", "32", "--max_detections", "32"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test: under the suite's workers the default
    pool oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_json(tmp_path_factory):
    """tiny_test_config with test_e2e.py's train settings, as --config."""
    c = tconfig.tiny_test_config()
    c = c.replace(data=dataclasses.replace(c.data, max_instances=12),
                  train=dataclasses.replace(c.train, lr_warmup_steps=20))
    path = str(tmp_path_factory.mktemp("cfg") / "tiny.json")
    with open(path, "w") as f:
        f.write(tconfig.config_to_json(c))
    return path


def _argv(tiny_json, save_dir, *extra):
    return (["--config", tiny_json, "--dataset", "synthetic", "--synthetic_n", "8",
             "--input_size", "64", "--batch_size", "2", "--steps_per_epoch", "2",
             "--save_dir", str(save_dir), "--device", "cpu"] + TINY_FLAGS + list(extra))


def _shared(a, b):
    out = {}
    for sec in ("model", "data", "group", "train", "infer"):
        da, db = dataclasses.asdict(getattr(a, sec)), dataclasses.asdict(getattr(b, sec))
        keys = sorted(set(da) & set(db))
        out[sec] = ({k: da[k] for k in keys}, {k: db[k] for k in keys})
    return out


def test_train_parser_takes_kgtpu_flags():
    """Every flag of train.py parses, with the same default."""
    tp, jp = tconfig.build_train_parser(), jconfig.build_train_parser()
    want = {s for a in jp._actions for s in a.option_strings}
    have = {s for a in tp._actions for s in a.option_strings}
    assert want <= have, sorted(want - have)
    jdests = {a.dest for a in jp._actions}
    assert {a.dest: a.default for a in jp._actions} == {
        a.dest: a.default for a in tp._actions if a.dest in jdests}


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "synthetic_hard", "--synthetic_n", "1024", "--batch_size", "4",
     "--aug_scale", "0.6,1.5", "--aug_elastic", "12,48", "--aug_rotate", "15",
     "--ema_decay", "0.999", "--lr", "1e-3", "--lr_schedule", "cosine",
     "--num_epochs", "7", "--steps_per_epoch", "11", "--save_dir", "/s",
     "--save_every", "0", "--keep_last", "3", "--eval_every", "2", "--resume",
     "--seed", "5", "--roi_size", "16", "--K", "64", "--conf_thresh", "0.3",
     "--max_box_size", "80", "--size_prune", "2", "--wh_head", "0"],
    ["--init_from", "/w", "--aug_elastic", "6", "--input_size", "256", "--resume", "/r"],
    ["--backbone", "unet", "--norm", "batch", "--remat", "--inter_inject", "--decode",
     "centernet", "--wh_head", "0"],
], ids=["defaults", "flagship", "init", "backbones"])
def test_config_from_train_args_matches_kgtpu(argv):
    got = tconfig.config_from_train_args(tconfig.build_train_parser().parse_args(argv))
    want = jconfig.config_from_train_args(jconfig.build_train_parser().parse_args(argv))
    for sec, (a, b) in _shared(got, want).items():
        assert a == b, sec


def test_config_base_keeps_what_has_no_flag():
    """--config supplies the settings without a flag; flags set the rest."""
    base = tconfig.tiny_test_config()
    cfg = tconfig.config_from_train_args(
        tconfig.build_train_parser().parse_args(["--lr", "0.01"]), base)
    assert (cfg.model.base_channels, cfg.model.hg_depth, cfg.data.max_instances) == (32, 2, 16)
    assert cfg.train.mask_train_rois == 4 and cfg.train.lr == 0.01
    assert cfg.model.backbone == "hourglass" and cfg.data.input_size == 512


@pytest.mark.parametrize("extra", [
    ["--backbone", "unet"], ["--backbone", "resnet_fpn"], ["--backbone", "hourglass_fast"],
    ["--norm", "batch"], ["--inter_inject", "--num_stacks", "2"],
    ["--remat", "--norm", "batch"], ["--decode", "centernet"],
], ids=lambda v: "_".join(a.lstrip("-") for a in v))
def test_other_backbones_norms_and_decoders_train_and_serve(tiny_json, tmp_path, extra):
    """Each configuration trains through the CLI (finite losses, a
    checkpoint whose stored config and tensors rebuild it, BatchNorm running
    stats moved by training) and serves its checkpoint through cli.test."""
    from kgtpu_torch.cli import test as test_cli
    from kgtpu_torch.data.png import write_png
    save = tmp_path / "w"
    summary = train.run(_argv(tiny_json, save, "--num_epochs", "1") + extra)
    assert summary["end_step"] == 2
    with open(save / "metrics.jsonl") as f:
        row = json.loads(f.readline())
    assert all(np.isfinite(row[k]) for k in ("loss", "loss_hm", "loss_mask")), row
    payload = checkpoint.restore(str(save))
    cfg = checkpoint.decode_config(payload["extra"])
    want = tconfig.config_from_train_args(tconfig.build_train_parser().parse_args(
        _argv(tiny_json, save) + extra), cfg)
    assert cfg.model == want.model and cfg.group.method == want.group.method
    model = KGNet(cfg.model)
    model.load_state_dict(payload["params"], strict=True)
    stats = [k for k in payload["params"] if k.endswith("running_var")]
    assert bool(stats) == (cfg.model.norm == "batch")
    assert all(not torch.equal(payload["params"][k], torch.ones_like(payload["params"][k]))
               for k in stats)
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(images / f"im{i}.png"), rng.integers(0, 256, (64, 64, 3), np.uint8))
    rc = test_cli.main(["--dataset", "folder", "--data_dir", str(images), "--weights",
                        str(save), "--input_size", "64", "--batch_size", "2",
                        "--device", "cpu", "--save_dir", str(tmp_path / "out")] +
                       (["--decode", "centernet"] if "centernet" in extra else []))
    assert rc == 0
    with open(tmp_path / "out" / "detections.json") as f:
        assert sorted(r["id"] for r in json.load(f)["images"]) == ["im0", "im1"]


def test_folder_dataset_is_refused(tiny_json, tmp_path):
    with pytest.raises(SystemExit, match="inference-only"):
        train.run(_argv(tiny_json, tmp_path / "w") + ["--dataset", "folder"])


def _kgtpu_stats(name, n, size, max_instances):
    """kgtpu train.py's dataset scan (train.py:155-181), on its own data."""
    ds = jax_build_dataset(jconfig.DataConfig(dataset=name, input_size=size,
                                              synthetic_train_images=n), "train")
    sides = []
    for i in range(len(ds)):
        lab = ds[i]["label_map"]
        bx, v, _ = jax_boxes_from_label_map(lab, max_instances)
        if v.sum():
            wh = np.maximum(bx[v > 0, 2] - bx[v > 0, 0], bx[v > 0, 3] - bx[v > 0, 1])
            sides.extend(wh * (size / max(lab.shape)))
    sides = np.asarray(sides, np.float32)
    return float(np.float32(sides.max())), float(np.float32(np.percentile(sides, 99)))


def test_cli_writes_checkpoints_metrics_best_and_stats(tiny_json, tmp_path):
    d = tmp_path / "run"
    out = train.run(_argv(tiny_json, d, "--num_epochs", "2", "--eval_every", "1",
                          "--ema_decay", "0.9"))
    assert sorted(os.listdir(d)) == ["best.json", "metrics.jsonl", "model_0", "model_1"]
    rows = [json.loads(line) for line in open(d / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [0, 1]
    for r in rows:
        assert {"loss", "loss_hm", "loss_off", "loss_wh", "loss_mask", "grad_norm",
                "val_mAP_dsb", "val_AP50", "val_mAP_dsb_ema", "val_PQ_ema",
                "img_per_sec", "host_rss_gb"} <= set(r) and np.isfinite(r["loss"])
    best = json.load(open(d / "best.json"))
    assert os.path.isdir(d / f"model_{best['epoch']}") and best == out["best"]
    assert out["end_step"] == 4 and out["eval"]["epoch"] == 1
    assert set(out["eval"]["label_maps"]) == {"raw", "ema"}
    assert out["eval"]["label_maps"]["ema"].shape == (16, 64, 64)

    extra = checkpoint.restore_extra(str(d / "model_1"))
    mx, p99 = _kgtpu_stats("synthetic", 8, 64, 12)
    assert extra["max_gt_box_side_px"] == mx and extra["p99_gt_box_side_px"] == p99
    assert extra["train_input_size"] == 64.0
    cfg = checkpoint.decode_config(extra)
    assert cfg.train.steps_per_epoch == 2 and cfg.model.base_channels == 32
    payload = checkpoint.restore(str(d / "model_1"))
    assert int(payload["step"]) == 4 and int(payload["epoch"]) == 1 and "ema" in payload


def _assert_payloads_equal(a, b):
    for k in ("params", "ema"):
        assert a[k].keys() == b[k].keys()
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n]), (k, n)
    for k in ("mu", "nu"):
        for n in a["opt"][k]:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert int(a["opt"]["count"]) == int(b["opt"]["count"])
    assert int(a["step"]) == int(b["step"]) and int(a["epoch"]) == int(b["epoch"])


def test_resume_equals_the_uninterrupted_run(tiny_json, tmp_path):
    """Two epochs in one run, and one epoch, then --resume for the second:
    bitwise the same parameters, optimizer state, step and EMA."""
    flags = ["--ema_decay", "0.9", "--lr", "2e-3", "--aug_rotate", "15"]
    train.run(_argv(tiny_json, tmp_path / "a", "--num_epochs", "2", *flags))
    train.run(_argv(tiny_json, tmp_path / "b", "--num_epochs", "1", *flags))
    out = train.run(_argv(tiny_json, tmp_path / "b", "--num_epochs", "2", "--resume", *flags))
    assert (out["start_epoch"], out["start_step"], out["end_step"]) == (1, 2, 4)
    _assert_payloads_equal(checkpoint.restore(str(tmp_path / "a" / "model_1")),
                           checkpoint.restore(str(tmp_path / "b" / "model_1")))


def test_resume_keeps_the_best(tiny_json, tmp_path):
    """A resumed run reads best.json back and replaces it only with a
    better value."""
    d = tmp_path / "run"
    train.run(_argv(tiny_json, d, "--num_epochs", "1", "--eval_every", "1"))
    with open(d / "best.json", "w") as f:
        json.dump({"epoch": 0, "metric": 2.0}, f)
    out = train.run(_argv(tiny_json, d, "--num_epochs", "2", "--eval_every", "1",
                          "--resume", str(d / "model_0")))
    assert out["best"] == {"epoch": 0, "metric": 2.0}
    assert json.load(open(d / "best.json")) == {"epoch": 0, "metric": 2.0}


def test_init_from_loads_the_weights_only(tiny_json, tmp_path):
    """With lr 0 the one step leaves the weights as loaded; the optimizer
    starts afresh (one update counted) at epoch 0."""
    train.run(_argv(tiny_json, tmp_path / "src", "--num_epochs", "2"))
    out = train.run(_argv(tiny_json, tmp_path / "ft", "--num_epochs", "1",
                          "--steps_per_epoch", "1", "--lr", "0",
                          "--init_from", str(tmp_path / "src")))
    assert (out["start_epoch"], out["start_step"], out["end_step"]) == (0, 0, 1)
    src = checkpoint.restore(str(tmp_path / "src" / "model_1"))
    got = checkpoint.restore(str(tmp_path / "ft" / "model_0"))
    for n, t in src["params"].items():
        assert torch.equal(got["params"][n], t), n
    assert int(got["opt"]["count"]) == 1 and int(got["epoch"]) == 0


@pytest.fixture
def nan_debugging_off():
    """--debug_nans switches the NaN checks on for the whole process: off
    again after the test, whatever it raised."""
    from kgtpu_torch.utils.debug import disable_nan_debugging
    yield
    disable_nan_debugging()


def test_debug_nans_trains_clean_and_stops_on_a_planted_nan(tiny_json, tmp_path,
                                                            nan_debugging_off):
    """--debug_nans: a clean run takes the steps of the run without it, to
    the bit; starting from weights with one NaN it stops with
    FloatingPointError at the first op that produces a NaN."""
    from kgtpu_torch.utils.debug import disable_nan_debugging
    args = ("--num_epochs", "1", "--steps_per_epoch", "1", "--rss_limit_gb", "0")
    train.run(_argv(tiny_json, tmp_path / "plain", *args))
    train.run(_argv(tiny_json, tmp_path / "checked", *args, "--debug_nans"))
    disable_nan_debugging()
    a = checkpoint.restore(str(tmp_path / "plain" / "model_0"))
    b = checkpoint.restore(str(tmp_path / "checked" / "model_0"))
    for n, t in a["params"].items():
        assert torch.equal(b["params"][n], t), n
    params = dict(a["params"])
    name = next(k for k in params if k.endswith("weight") and params[k].dim() == 4)
    params[name] = params[name].clone()
    params[name][0, 0, 0, 0] = float("nan")
    bad = checkpoint.write_payload(str(tmp_path / "nan"), 0, {"params": params})
    with pytest.raises(FloatingPointError, match="nan"):
        train.run(_argv(tiny_json, tmp_path / "ft", *args, "--init_from", bad,
                        "--debug_nans"))


def test_profile_dir_traces_the_first_epoch(tiny_json, tmp_path):
    """--profile_dir writes a Chrome trace of the first epoch's steps that
    holds the train step's ops."""
    prof = tmp_path / "prof"
    train.run(_argv(tiny_json, tmp_path / "w", "--num_epochs", "2", "--steps_per_epoch", "1",
                    "--rss_limit_gb", "0", "--profile_dir", str(prof)))
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)


def test_keep_last_prunes_and_spares_the_best(tiny_json, tmp_path):
    """--keep_last 2 over 5 epochs, evaluated every epoch: the run ends with
    the two newest checkpoints and the best one."""
    d = tmp_path / "run"
    out = train.run(_argv(tiny_json, d, "--num_epochs", "5", "--steps_per_epoch", "1",
                          "--eval_every", "1", "--keep_last", "2"))
    kept = sorted(int(p.split("_")[1]) for p in os.listdir(d) if p.startswith("model_"))
    assert kept == sorted({3, 4, out["best"]["epoch"]})


def test_learning_gate_through_the_cli(tiny_json, tmp_path):
    """tests/test_e2e.py's recipe through the CLI: tiny model, 96 x 96,
    lr 2e-3 with 20 warmup steps, 150 steps of batch 2 on `synthetic`
    (the same batches as test_e2e's iterator); the saved model scores its
    floors on 4 val images."""
    d = tmp_path / "run"
    train.run(["--config", tiny_json, "--dataset", "synthetic", "--input_size", "96",
               "--batch_size", "2", "--lr", "2e-3", "--num_epochs", "1",
               "--steps_per_epoch", "150", "--save_dir", str(d), "--device", "cpu"]
              + TINY_FLAGS)
    state_dict, extra = checkpoint.restore_bundle(str(d))
    cfg = checkpoint.decode_config(extra)
    model = KGNet(cfg.model)
    model.load_state_dict(state_dict)
    infer = build_infer_fn(model, cfg, device="cpu")
    val = build_dataset(cfg.data, split="val")
    recs = []
    for i in range(4):
        s = prepare_sample(val[i], cfg.data, image_only=False)
        out = infer(s["image"][None])
        recs.append({"pred_label": out["label_map"][0].numpy(),
                     "scores": out["scores"][0].numpy(), "gt_label": s["label_map"]})
    res = evaluate.evaluate_dsb2018(recs)
    assert res["mAP_dsb2018"] > 0.22, res
    coco = evaluate.evaluate_coco(recs)
    assert coco["AP50"] > 0.58, coco
