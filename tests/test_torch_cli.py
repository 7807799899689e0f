"""The port's config shim and CLIs against kgtpu's: argv -> Config, the JSON
of stored configs, `python -m kgtpu_torch.cli.test` against `test.py`,
`cli.eval` against `eval.py`, the headline bench's line, and the trained
flagship's label maps against kgtpu's committed reference.

Tolerances:
  * configs, ids, label PNGs, instance counts, COCO segmentations: exact;
  * boxes 1e-3 px and scores 1e-5 (the two packages' f32 convolutions sum
    in another order: tests/test_torch_infer.py);
  * COCO records' bbox 0.011 px and score 2e-5: the file rounds them to 2
    and 5 decimals, and a value 1e-3 px or 1e-5 away can round across;
  * eval JSON: equal, with kgtpu's NumPy IoU (its compiled IoU op rounds
    IoUs to f32; see test_torch_evaluate.py);
  * the flagship on 2 committed 512x512 images in f32: label maps and counts
    exactly equal to kgtpu's committed run (assets_torch/kgtpu_reference.npz).
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from kgtpu import checkpoint as jckpt
from kgtpu import config as jconfig
from kgtpu import train_lib as jtrain
from kgtpu_torch import config as tconfig
from kgtpu_torch.cli import bench as bench_cli
from kgtpu_torch.cli import eval as eval_cli
from kgtpu_torch.cli import test as test_cli
from kgtpu_torch.data.png import read_png
from tools.orbax_to_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets_torch")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run tiny shapes; with the suite's parallel workers on
    every core, torch's default thread pool per worker oversubscribes the
    machine (a 0.5 s test measured 40-50 s), so each test runs on one
    thread and restores the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARGVS = [
    [],
    ["--dataset", "folder", "--data_dir", "/d", "--weights", "/w", "--use_ema",
     "--batch_size", "16", "--input_size", "1024", "--K", "64", "--max_detections", "96",
     "--conf_thresh", "0.2", "--nms_iou", "0.4", "--max_box_size", "80",
     "--size_prune", "0", "--mask_chunk", "8", "--mask_rescore", "0.5", "--save_dir", "/o"],
    ["--dataset", "dsb2018", "--backbone", "hourglass_lite", "--num_stacks", "1",
     "--norm", "batch", "--decode", "centernet", "--wh_head", "0", "--roi_size", "16",
     "--inter_inject", "--synthetic_n", "12", "--test_scales", "0.75,1.0,1.25",
     "--test_flip", "--mask_size", "40"],
]


def _shared(a, b):
    """Fields of each section that both configs hold, as (a's, b's) dicts."""
    out = {}
    for sec in ("model", "data", "group", "train", "infer"):
        da, db = dataclasses.asdict(getattr(a, sec)), dataclasses.asdict(getattr(b, sec))
        keys = sorted(set(da) & set(db))
        out[sec] = ({k: da[k] for k in keys}, {k: db[k] for k in keys})
    return out


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "serving", "architecture"])
def test_test_flags_reach_config_like_kgtpu(argv):
    got = tconfig.config_from_test_args(tconfig.build_test_parser().parse_args(argv))
    want = jconfig.config_from_test_args(jconfig.build_test_parser().parse_args(argv))
    for sec, (a, b) in _shared(got, want).items():
        assert a == b, sec
    dests = tconfig.explicit_cli_dests(tconfig.build_test_parser(), argv)
    assert dests == jconfig.explicit_cli_dests(jconfig.build_test_parser(), argv)
    stored = jconfig.ModelConfig(backbone="hourglass_lite", num_stacks=1, base_channels=48,
                                 hg_depth=3, roi_size=8, mask_size=16, use_wh_head=False)
    port_stored = tconfig.ModelConfig(**dataclasses.asdict(stored))
    merged = tconfig.apply_model_overrides(
        port_stored, tconfig.build_test_parser().parse_args(argv), dests)
    jmerged = jconfig.apply_model_overrides(
        stored, jconfig.build_test_parser().parse_args(argv), dests)
    assert dataclasses.asdict(merged) == dataclasses.asdict(jmerged)


def test_parsers_take_kgtpu_flags():
    """Every flag of kgtpu's test and eval parsers parses in the port's."""
    for tp, jp in ((tconfig.build_test_parser(), jconfig.build_test_parser()),
                   (tconfig.build_eval_parser(), jconfig.build_eval_parser())):
        want = {s for a in jp._actions for s in a.option_strings}
        have = {s for a in tp._actions for s in a.option_strings}
        assert want <= have, sorted(want - have)
        assert {a.dest: a.default for a in jp._actions} == {
            a.dest: a.default for a in tp._actions if a.dest in {b.dest for b in jp._actions}}
    with pytest.raises(SystemExit):
        tconfig.config_from_test_args(tconfig.build_test_parser().parse_args(
            ["--test_scales", "0.75,1.25"]))


def _kgtpu_json(**sections):
    c = jconfig.Config()
    c = c.replace(**{k: dataclasses.replace(getattr(c, k), **v) for k, v in sections.items()})
    return jconfig.config_to_json(c)


def test_config_json_reads_kgtpu_configs():
    """kgtpu's JSON reads back with the same shared values, including the
    flagship's training settings; fields that change no result are dropped;
    the port's own JSON round-trips."""
    for s in (_kgtpu_json(), _kgtpu_json(
            data={"dataset": "synthetic_hard", "synthetic_train_images": 1024,
                  "rotate_deg": 15.0, "scale_range": (0.6, 1.5)},
            train={"lr_schedule": "cosine", "steps_per_epoch": 128, "ema_decay": 0.999,
                   "save_dir": "runs/x", "keep_last": 8, "eval_every_epochs": 10,
                   "resume": "latest", "steps_per_dispatch": 8, "num_devices": 4,
                   "target_renderer": "pallas"},
            model={"remat": True}, infer={"fused_norm": "auto"})):
        got, want = tconfig.config_from_json(s), jconfig.config_from_json(s)
        for sec, (a, b) in _shared(got, want).items():
            assert a == b, sec
        assert tconfig.config_from_json(tconfig.config_to_json(got)) == got
    with open(os.path.join(ASSETS, "flagship_ema", "model_99", "meta.json")) as f:
        flag = tconfig.config_from_json(json.load(f)["extra"]["config_json"])
    assert flag.data.rotate_deg == 15.0 and flag.train.ema_decay == 0.999


@pytest.mark.parametrize("section,field,value", [
    ("infer", "tta_vote", "max"), ("infer", "tile_size", 256),
    ("infer", "tta_vote_thresh", 0.3), ("infer", "tile_overlap", 8)])
def test_config_json_refuses_a_dropped_setting(section, field, value):
    """A kgtpu config's TTA and tiling settings read back with kgtpu's value;
    a field the port does not hold raises and names it; kgtpu's default
    config reads as the port's."""
    got = tconfig.config_from_json(_kgtpu_json(**{section: {field: value}}))
    assert getattr(getattr(got, section), field) == value
    raw = json.loads(_kgtpu_json())
    raw["model"]["future_knob"] = 1
    with pytest.raises(ValueError, match="model.future_knob"):
        tconfig.config_from_json(json.dumps(raw))
    assert tconfig.config_from_json(_kgtpu_json()) == tconfig.Config()


@pytest.mark.parametrize("flags,item", [
    (["--ngpus", "2"], "data parallelism"),
    (["--save_vis"], "debugging, profiling and visualisation"),
    (["--debug_nans"], "debugging, profiling and visualisation")])
def test_unported_paths_exit_naming_their_item(flags, item):
    """The refusal names the ROADMAP item by its title, which a re-anchor
    that renumbers the queue does not change."""
    with pytest.raises(SystemExit, match=f"ROADMAP §1: {item}"):
        test_cli.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("flags,message", [
    (["--ensemble", "/w2"], "--ensemble needs --weights (the mask member)"),
    (["--ensemble", "/w2", "--weights", "/w", "--tiled"], "--ensemble and --tiled are exclusive"),
    (["--tiled", "--test_scales", "0.75,1.0"], "--tiled and multi-scale --test_scales are exclusive"),
    (["--tiled", "--test_flip"], "--tiled and multi-scale --test_scales are exclusive")])
def test_conflicting_flags_exit_with_test_py_messages(flags, message):
    """test.py's refusals, with its messages, before anything is loaded."""
    with open(os.path.join(ROOT, "test.py")) as f:
        assert f'"{message}"' in f.read()
    with pytest.raises(SystemExit) as e:
        test_cli.main(flags + ["--device", "cpu"])
    assert str(e.value) == message


def _val_ids(n):
    """DSB2018 ids in its held-out bucket, which its 'test' split serves
    from a directory with masks."""
    ids = (f"cell_{i:03d}" for i in range(1000))
    return [i for i in ids if int(hashlib.md5(i.encode()).hexdigest(), 16) % 1000 < 100][:n]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"kgtpu_root_{name}",
                                                  os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two tiny checkpoints in both formats (kgtpu's random init from seeds 0
    and 1, with dataset stats that switch on the size-prior cap), three PNGs
    as a folder and as a DSB2018 directory with masks, and both test CLIs run
    over the folder with the first checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    jcfg = jconfig.tiny_test_config()
    for seed in (0, 1):
        state = jtrain.create_train_state(jcfg, jax.random.PRNGKey(seed))
        jw, tw = str(root / f"w_jax{seed or ''}"), str(root / f"w_torch{seed or ''}")
        jckpt.save(jw, epoch=2, state=state,
                   extra={"config_json": jckpt.encode_config(jcfg),
                          "max_gt_box_side_px": np.float32(60.0),
                          "train_input_size": np.float32(128.0)})
        convert(jw, tw)
    jw, tw = str(root / "w_jax"), str(root / "w_torch")
    rng = np.random.default_rng(0)
    folder, dsb = root / "folder", root / "dsb"
    folder.mkdir()
    for iid, (h, w) in zip(_val_ids(3), [(128, 128), (96, 128), (150, 120)]):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2)
        cv2.imwrite(str(folder / f"{iid}.png"), img)
        os.makedirs(dsb / iid / "images")
        shutil.copy(folder / f"{iid}.png", dsb / iid / "images" / f"{iid}.png")
        os.makedirs(dsb / iid / "masks")
        for k in range(4):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.integers(0, h - 30), rng.integers(0, w - 30)
            m[y:y + int(rng.integers(8, 30)), x:x + int(rng.integers(8, 30))] = 255
            cv2.imwrite(str(dsb / iid / "masks" / f"m{k}.png"), m)
    common = ["--dataset", "folder", "--data_dir", str(folder), "--input_size", "128",
              "--batch_size", "2", "--conf_thresh", "0.01", "--size_prune", "0"]
    jout, tout = str(root / "out_jax"), str(root / "out_torch")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "test.py"), *common, "--weights", jw,
         "--save_dir", jout, "--coco_json", os.path.join(jout, "coco.json")],
        env={**os.environ, "KGTPU_PLATFORM": "cpu", "KGTPU_COMPILE_CACHE": "off"},
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    os.makedirs(tout)
    assert test_cli.main(common + ["--weights", tw, "--save_dir", tout, "--device", "cpu",
                                   "--coco_json", os.path.join(tout, "coco.json"),
                                   "--profile_dir", str(root / "prof")]) == 0
    return {"jax": jout, "torch": tout, "dsb": str(dsb), "prof": str(root / "prof"),
            "root": root, "common": common}


VARIANTS = {
    "tta": ["--test_scales", "0.5,1.0", "--test_flip", "--tta_vote_thresh", "0.01"],
    "ensemble": ["--ensemble", "{w2}", "--tta_vote", "max"],
    "tiled": ["--tiled", "--input_size", "128", "--tile_size", "64", "--tile_overlap", "16"],
}


@pytest.fixture(scope="module")
def cli_variant_runs(cli_runs):
    """cli_runs' set-up again, through both test CLIs with each of VARIANTS'
    flags (the ensemble's second member is the seed-1 checkpoint, merged by
    the max vote; TTA's mean vote gates at the random weights' scores);
    kgtpu's three runs go in parallel."""
    root, common = cli_runs["root"], cli_runs["common"]
    procs, out = {}, {}
    for name, flags in VARIANTS.items():
        jout, tout = str(root / f"out_jax_{name}"), str(root / f"out_torch_{name}")
        jflags = [f.format(w2=str(root / "w_jax1")) for f in flags]
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "test.py"), *common, *jflags,
             "--weights", str(root / "w_jax"), "--save_dir", jout],
            env={**os.environ, "KGTPU_PLATFORM": "cpu", "KGTPU_COMPILE_CACHE": "off"},
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        out[name] = (jout, tout)
    for name, flags in VARIANTS.items():
        tflags = [f.format(w2=str(root / "w_torch1")) for f in flags]
        assert test_cli.main(common + tflags + ["--weights", str(root / "w_torch"),
                                                "--save_dir", out[name][1],
                                                "--device", "cpu"]) == 0
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return out


def _assert_same_results(jout, tout, min_instances, ensemble=((), ()), all_pasted=True,
                         pixels_off=0):
    """Two test CLIs' result dirs: detections.json's settings, ids and counts
    equal (its "ensemble" lists each CLI's own member paths), boxes to 1e-3
    px and scores to 1e-5, every label PNG equal but for at most
    `pixels_off` pixels; with all_pasted, the highest label id is the
    instance count."""
    with open(os.path.join(jout, "detections.json")) as f:
        want = json.load(f)
    with open(os.path.join(tout, "detections.json")) as f:
        got = json.load(f)
    assert (want.pop("ensemble"), got.pop("ensemble")) == tuple(map(list, ensemble))
    assert {k: v for k, v in got.items() if k != "images"} == {
        k: v for k, v in want.items() if k != "images"}
    assert [r["id"] for r in got["images"]] == [r["id"] for r in want["images"]]
    assert sum(r["num_instances"] for r in want["images"]) >= min_instances
    for g, w in zip(got["images"], want["images"]):
        assert g["num_instances"] == w["num_instances"]
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        for d in (jout, tout):
            with open(os.path.join(d, f"{w['id']}.json")) as f:
                rec = json.load(f)
            assert rec["id"] == w["id"] and rec["num_instances"] == w["num_instances"]
        lab_j = cv2.imread(os.path.join(jout, f"{w['id']}_label.png"), cv2.IMREAD_UNCHANGED)
        lab_t = cv2.imread(os.path.join(tout, f"{w['id']}_label.png"), cv2.IMREAD_UNCHANGED)
        assert lab_t.dtype == lab_j.dtype == np.uint16
        if pixels_off:
            assert lab_t.shape == lab_j.shape and (lab_t != lab_j).sum() <= pixels_off
        else:
            np.testing.assert_array_equal(lab_t, lab_j)
        assert int(lab_t.max()) == w["num_instances"] or not all_pasted


def test_cli_test_matches_kgtpu_test_py(cli_runs):
    jout, tout = cli_runs["jax"], cli_runs["torch"]
    _assert_same_results(jout, tout, min_instances=6)
    with open(os.path.join(jout, "coco.json")) as f:
        cj = json.load(f)
    with open(os.path.join(tout, "coco.json")) as f:
        ct = json.load(f)
    assert len(ct) == len(cj) > 0
    for a, b in zip(ct, cj):
        assert (a["image_id"], a["category_id"], a["segmentation"]) == (
            b["image_id"], b["category_id"], b["segmentation"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=0.011)
        assert abs(a["score"] - b["score"]) <= 2e-5
    with open(os.path.join(cli_runs["prof"], "trace.json")) as f:
        assert json.load(f)["traceEvents"]               # --profile_dir's torch.profiler trace


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cli_tta_ensemble_tiled_match_kgtpu_test_py(cli_variant_runs, variant):
    """--test_scales 0.5,1.0 --test_flip, --ensemble and --tiled write
    test.py's results (tiled: ids renumbered to 1..P, boxes and scores
    aligned to them).  With TTA a kept instance may paste no pixel, and a
    label map may differ in 2 of its 16384 pixels: the half-scale boxes'
    f32 error doubles on the way to the base grid (7e-5 px here, 1.5e-5 at
    one scale), and a mask value that close to the 0.5 threshold flips one
    pixel (seen once: cell_006, pixel (98, 74))."""
    jout, tout = cli_variant_runs[variant]
    members = ((w,) for w in ("w_jax1", "w_torch1")) if variant == "ensemble" else ((), ())
    root = os.path.dirname(jout)
    _assert_same_results(jout, tout, min_instances=6,
                         ensemble=[[os.path.join(root, w) for w in m] for m in members],
                         all_pasted=variant != "tta", pixels_off=2 if variant == "tta" else 0)


@pytest.mark.parametrize("protocol", ["dsb2018", "all"])
def test_cli_eval_matches_kgtpu_eval_py(cli_runs, protocol, monkeypatch, capsys):
    """eval.py (in-process, kgtpu's NumPy IoU) and cli.eval print equal JSON
    on kgtpu's outputs, and on the port's own outputs cli.eval prints what
    eval.py printed on kgtpu's."""
    from kgtpu import native
    monkeypatch.setattr(native, "label_map_iou", lambda pred, gt: None)
    monkeypatch.setenv("KGTPU_COMPILE_CACHE", "off")
    kgtpu_eval = _load_script("eval")
    out = {}
    for name in ("jax", "torch"):
        argv = ["--pred_dir", cli_runs[name], "--dataset", "dsb2018", "--gt_dir",
                cli_runs["dsb"], "--protocol", protocol]
        monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
        kgtpu_eval.main()
        want = capsys.readouterr().out.strip().splitlines()[-1]
        assert eval_cli.main(argv) == 0
        got = capsys.readouterr().out.strip().splitlines()[-1]
        assert got == want
        out[name] = json.loads(got)
    assert out["torch"] == out["jax"]
    assert out["jax"]["num_images"] == 3
    with pytest.raises(SystemExit, match="no ground truth"):
        eval_cli.main(["--pred_dir", cli_runs["torch"], "--dataset", "folder"])


def test_flagship_label_maps_equal_kgtpu_reference(tmp_path):
    """The trained flagship (committed EMA weights) through cli.test on the
    CPU in f32, on the first 2 of the 16 committed 512x512 images: label maps
    and instance counts exactly kgtpu's committed f32 run."""
    ref = np.load(os.path.join(ASSETS, "kgtpu_reference.npz"))
    ids = [str(i) for i in ref["ids"]][:2]
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in ids:
        shutil.copy(os.path.join(ASSETS, "synthetic_hard", "images", f"{i}.png"), folder)
    out = str(tmp_path / "out")
    assert test_cli.main(["--dataset", "folder", "--data_dir", str(folder), "--weights",
                          os.path.join(ASSETS, "flagship_ema"), "--use_ema",
                          "--compute_dtype", "float32", "--batch_size", "2",
                          "--device", "cpu", "--save_dir", out]) == 0
    with open(os.path.join(out, "detections.json")) as f:
        det = {r["id"]: r for r in json.load(f)["images"]}
    for k, i in enumerate(ids):
        assert det[i]["num_instances"] == int(ref["counts_float32"][k]) >= 15
        lab = read_png(os.path.join(out, f"{i}_label.png"), "unchanged")
        np.testing.assert_array_equal(lab, ref["labels_float32"][k])


def test_bench_line_has_its_keys(monkeypatch, capsys):
    """The bench's JSON line on the CPU at tiny_test_config's size: every key,
    a CPU run named as such (no mfu, device "cpu"), FLOPs from
    FlopCounterMode, and the spread of the fixed 5 repeats."""
    monkeypatch.setattr(bench_cli, "Config", tconfig.tiny_test_config)
    for name, value in (("BATCH", 2), ("PINNED_DETS", 4), ("ITERS", 1),
                        ("DECODE_GROUP_BATCH", 2)):
        monkeypatch.setattr(bench_cli, name, value)
    assert bench_cli.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "e2e_images_per_sec_128" and line["unit"] == "img/s"
    assert line["value_min"] <= line["value"] <= line["value_max"]
    assert line["repeats"] == bench_cli.REPEATS == 5
    assert line["vs_baseline"] is None and line["mfu"] is None
    assert (line["backend"], line["device"]) == ("cpu", "cpu")
    assert line["gflops_per_img"] > 0 and line["decode_group_ms_per_img"] > 0
    assert line["batch"] == 2 and line["pinned_dets_per_img"] == 4
    assert (line["decode_group_ms_per_img_min"] <= line["decode_group_ms_per_img"]
            <= line["decode_group_ms_per_img_max"])
