"""The host-RSS watchdog of the port's training CLI against kgtpu's
train.py: `kgtpu_torch/utils/host.py` against `kgtpu/utils/host.py`, both
trainers at default flags (--rss_limit_gb -1: 75% of MemTotal) with the
host's RSS reported above the limit, and a real re-exec.

The two trainers must restart at the same epochs, after the same saves,
with the same resume flags, and never after the last epoch.  Before this
port, `cli.train` refused --rss_limit_gb > 0 and never restarted.
"""

import json
import os
import runpy
import subprocess
import sys

import pytest

import kgtpu.utils.host as jhost
from kgtpu_torch import config as tconfig
from kgtpu_torch.cli import train
from kgtpu_torch.utils import host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--dataset", "synthetic", "--synthetic_n", "8", "--input_size", "64",
         "--batch_size", "2", "--steps_per_epoch", "1", "--num_epochs", "3",
         "--save_every", "2", "--backbone", "hourglass_lite", "--num_stacks", "1",
         "--roi_size", "8", "--mask_size", "16", "--K", "32", "--max_detections", "32",
         "--ngpus", "1"]


@pytest.mark.parametrize("argv", [
    ["train.py", "--num_epochs", "5"], ["train.py", "--resume", "/old/ckpt", "-x"],
    ["train.py", "--resume=/old/ckpt"], ["train.py", "--resume", "--seed", "3"],
    ["-m", "kgtpu_torch.cli.train", "--resume", "latest"], ["train.py", "--resume"]])
def test_restart_argv_matches_kgtpu(argv):
    assert host.restart_argv(argv) == jhost.restart_argv(argv)
    assert host.restart_argv(argv).count("--resume") == 1


def test_rss_and_default_limit_match_kgtpu():
    assert 0.01 < host.host_rss_gb() < 200
    assert host.default_rss_limit_gb() == jhost.default_rss_limit_gb()
    lim = host.default_rss_limit_gb()
    assert lim == 0.0 or lim > host.host_rss_gb()


def _watch(module, monkeypatch, save_dir):
    """Report the RSS above the default limit at every epoch boundary, and
    record each re-exec instead of making it: (epoch just finished,
    checkpoints on disk, argv)."""
    calls = []

    def metrics_lines():
        path = os.path.join(save_dir, "metrics.jsonl")
        return sum(1 for _ in open(path)) if os.path.exists(path) else 0

    def reexec(argv):
        ckpts = sorted(d for d in os.listdir(save_dir) if d.startswith("model_"))
        calls.append((metrics_lines() - 1, ckpts, list(argv)))

    monkeypatch.setattr(module, "host_rss_gb", lambda: module.default_rss_limit_gb() + 1.0)
    monkeypatch.setattr(module, "reexec", reexec)
    return calls


@pytest.fixture(scope="module")
def kgtpu_restarts(tmp_path_factory):
    """kgtpu's train.py, in this process, at default watchdog flags."""
    save_dir = str(tmp_path_factory.mktemp("kgtpu"))
    mp = pytest.MonkeyPatch()
    calls = _watch(jhost, mp, save_dir)
    argv = [os.path.join(ROOT, "train.py")] + FLAGS + ["--save_dir", save_dir]
    mp.setattr(sys, "argv", argv)
    mp.setenv("KGTPU_COMPILE_CACHE", "off")
    try:
        runpy.run_path(argv[0], run_name="__main__")
    finally:
        mp.undo()
    return calls, sorted(d for d in os.listdir(save_dir) if d.startswith("model_"))


def test_port_restarts_where_kgtpu_does(kgtpu_restarts, monkeypatch, tmp_path):
    """Same epochs (0 and 1 of 3; none after the last), same checkpoints on
    disk at each restart (epoch 0 is off the --save_every 2 grid, so the
    watchdog saves it first), same resume flags; the port re-execs itself
    as a module."""
    cfg = str(tmp_path / "tiny.json")
    with open(cfg, "w") as f:
        f.write(tconfig.config_to_json(tconfig.tiny_test_config()))
    save_dir = str(tmp_path / "w")
    calls = _watch(host, monkeypatch, save_dir)
    port_flags = FLAGS + ["--save_dir", save_dir, "--config", cfg, "--device", "cpu"]
    train.run(port_flags)
    want, want_final = kgtpu_restarts
    assert [(e, c) for e, c, _ in calls] == [(e, c) for e, c, _ in want] == [
        (0, ["model_0"]), (1, ["model_0", "model_1"])]
    for (_, _, ours), (_, _, theirs) in zip(calls, want):
        assert ours == ["-m", "kgtpu_torch.cli.train", *port_flags, "--resume"]
        assert theirs == [os.path.join(ROOT, "train.py"), *FLAGS, "--save_dir", theirs[-2],
                          "--resume"]
    assert sorted(d for d in os.listdir(save_dir) if d.startswith("model_")) == want_final


def test_watchdog_reexecs_and_resumes(tmp_path):
    """A real restart: `python -m kgtpu_torch.cli.train` with a limit below
    any process's RSS re-execs once, after epoch 0 of 2 (never after the
    last), and the new process resumes at epoch 1 and exits 0."""
    cfg = str(tmp_path / "tiny.json")
    with open(cfg, "w") as f:
        f.write(tconfig.config_to_json(tconfig.tiny_test_config()))
    save_dir = str(tmp_path / "w")
    argv = [sys.executable, "-m", "kgtpu_torch.cli.train", "--config", cfg,
            "--device", "cpu", "--save_dir", save_dir, "--rss_limit_gb", "0.001",
            "--num_epochs", "2"] + [a for a in FLAGS if a not in ("--num_epochs", "3")]
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("re-exec'ing with --resume") == 1, r.stderr[-3000:]
    assert "at epoch 1" in r.stderr.split("re-exec'ing")[1]
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
