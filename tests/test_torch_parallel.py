"""The port's data parallelism (`kgtpu_torch.parallel`, the `gb=` paths of
`train_lib`, `devices=` of `infer.py`, `--ngpus` / `--coordinator` of the
CLIs) on the CPU: gloo ranks in real processes, CPU shards in threads.

One 2-rank group is spawned for the module (`_dp_worker`), and each check
reads what it wrote:
  * the data-parallel step against one process on the global batch, with
    tests/test_train.py's bounds for kgtpu's sharded step (loss rtol 2e-4,
    params atol 2e-4); the gap is printed;
  * norm=batch: the running stats (global-batch statistics, sync-BN) and the
    EMA, atol 2e-4 (test_train.py:90-125);
  * the k = 2 multi-step under data parallelism (test_train.py:247-285);
  * `broadcast_scalar` and `all_hosts_max`.
Serving: `build_infer_fn` and `build_tiled_infer_fn` over two CPU devices
equal the unsharded call exactly (label maps, score maps, boxes, scores,
validity, and the mask probabilities of valid slots; test_infer.py:37, 73,
test_tiling.py:110).  CLIs: two `--coordinator` processes (as
test_multihost.py runs train.py) end with one metrics.jsonl line whose loss
is within 2e-4 of a one-process run, and one checkpoint that restores;
`--ngpus 2` gives the same run; `cli.test --ngpus 2` (single-scale and
tiled) writes the label maps of `--ngpus 1`.

This module imports no jax: the ranks import it to find their entry point.
Every process started here has a timeout and is killed if it outlives it.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kgtpu_torch import checkpoint, train_lib
from kgtpu_torch.config import config_to_json, tiny_test_config
from kgtpu_torch.data.loader import make_batch
from kgtpu_torch.data.png import read_png
from kgtpu_torch.data.registry import build_dataset
from kgtpu_torch.infer import build_infer_fn, build_tiled_infer_fn
from kgtpu_torch.models import build_model
from kgtpu_torch.parallel import launch, make_mesh, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GLOBAL_B = 4
SIDE = 64
K = 2
TIMEOUT_S = 300
# test_torch_infer.py's low thresholds: random weights then find boxes
LOW_THRESH = dict(kp_score_thresh=0.05, center_thresh=0.05, score_thresh=0.02,
                  center_tol=1.0, size_prune=10.0)
TINY_FLAGS = ["--backbone", "hourglass_lite", "--num_stacks", "1", "--roi_size", "8",
              "--mask_size", "16", "--K", "32", "--max_detections", "32"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(norm: str = "group"):
    c = tiny_test_config()
    return c.replace(model=dataclasses.replace(c.model, norm=norm),
                     data=dataclasses.replace(c.data, input_size=SIDE),
                     train=dataclasses.replace(c.train, lr_warmup_steps=1, ema_decay=0.9,
                                               batch_size=GLOBAL_B))


def _global_batches(cfg, k: int) -> list[dict]:
    ds = build_dataset(cfg.data)
    rng = np.random.default_rng(0)
    return [make_batch(ds, list(range(GLOBAL_B * j, GLOBAL_B * (j + 1))), cfg.data,
                       augment=False, rng=rng) for j in range(k)]


def _run(cfg, gb, multi: bool) -> dict:
    """One step (or a k-step call) from seed 0 on the global batches (this
    rank's rows with `gb`): metrics and every state tensor."""
    state = train_lib.create_train_state(cfg, seed=0, device="cpu")
    batches = _global_batches(cfg, K if multi else 1)
    if gb is not None:
        batches = [{k: v[gb.rank * (GLOBAL_B // gb.world):(gb.rank + 1) * (GLOBAL_B // gb.world)]
                    for k, v in b.items()} for b in batches]
    b, n = batches[0]["valid"].shape
    cpu = torch.device("cpu")
    draws = [train_lib.step_draws(cfg, torch.Generator().manual_seed(11 + j), b, n, cpu, gb)
             for j in range(len(batches))]
    if multi:
        stacked = {key: np.stack([x[key] for x in batches]) for key in batches[0]}
        metrics = train_lib.make_train_multi_step(cfg, K, gb)(
            state, stacked, torch.stack([d[0] for d in draws]),
            torch.stack([d[1] for d in draws]))
    else:
        metrics = train_lib.train_step(state, train_lib.batch_to_device(batches[0], cpu),
                                       *draws[0], cfg, gb)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "params": [p.detach().clone() for p in state.model.parameters()],
            "buffers": [t.clone() for t in state.model.buffers()],
            "ema": [e.clone() for e in state.ema], "step": state.step}


CASES = {"group": ("group", False), "batch": ("batch", False), "multi": ("group", True)}


def _dp_worker(rank: int, world: int, coordinator: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    multihost.initialize(coordinator, world, rank, "cpu", timeout_s=TIMEOUT_S)
    try:
        out = {"broadcast": multihost.broadcast_scalar(10.0 + rank),
               "max": multihost.all_hosts_max(0.5 + rank),
               "main": multihost.is_main()}
        for name, (norm, multi) in CASES.items():
            gb = multihost.global_batch()
            out[name] = _run(_cfg(norm), gb, multi)
            out[name]["collectives"] = gb.collectives
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()
    return 0


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results, and the one-process reference of each case."""
    out_dir = str(tmp_path_factory.mktemp("dp"))
    codes = launch.spawn(_dp_worker, WORLD, (out_dir,), timeout_s=TIMEOUT_S)
    assert codes == [0] * WORLD, codes
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(WORLD)]
    ref = {name: _run(_cfg(norm), None, multi) for name, (norm, multi) in CASES.items()}
    return ranks, ref


def _gap(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["group", "multi"])
def test_dp_step_matches_one_process(dp, case):
    """The ranks agree bitwise with each other (one global update) and with
    the one-process step at kgtpu's sharded-step bounds."""
    ranks, ref = dp
    got, want = ranks[0][case], ref[case]
    for r in ranks[1:]:
        assert _gap(r[case]["params"], got["params"]) == 0
        assert all(torch.equal(r[case]["metrics"][k], got["metrics"][k]) for k in got["metrics"])
    gap = _gap(got["params"], want["params"])
    loss_rel = float(((got["metrics"]["loss"] - want["metrics"]["loss"]).abs()
                      / want["metrics"]["loss"].abs()).max())
    print(f"{case}: loss rel gap {loss_rel:.3g}, params max abs gap {gap:.3g}")
    np.testing.assert_allclose(got["metrics"]["loss"].numpy(), want["metrics"]["loss"].numpy(),
                               rtol=2e-4)
    assert gap <= 2e-4
    assert got["step"] == want["step"] == (K if case == "multi" else 1)
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k].numpy(), want["metrics"][k].numpy(),
                                   rtol=2e-4, err_msg=k)


def test_dp_collectives_per_step(dp):
    """One step: a num_pos sum per stack, the metrics' sum and ONE flat
    gradient all-reduce; the multi-step, that per step."""
    ranks, _ = dp
    assert ranks[0]["group"]["collectives"] == 3
    assert ranks[0]["multi"]["collectives"] == 3 * K


def test_dp_batchnorm_stats_and_ema(dp):
    """Sync-BN: the running stats are the global batch's, not one rank's."""
    ranks, ref = dp
    got, want = ranks[0]["batch"], ref["batch"]
    assert got["buffers"] and _gap(got["buffers"], ranks[1]["batch"]["buffers"]) == 0
    gap_stats, gap_ema = _gap(got["buffers"], want["buffers"]), _gap(got["ema"], want["ema"])
    print(f"batch: running stats gap {gap_stats:.3g}, EMA gap {gap_ema:.3g}")
    assert gap_stats <= 2e-4 and gap_ema <= 2e-4
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(want["metrics"]["loss"]),
                               rtol=2e-4)


def test_broadcast_scalar_and_all_hosts_max(dp):
    ranks, _ = dp
    assert [r["broadcast"] for r in ranks] == [10.0, 10.0]
    assert [r["max"] for r in ranks] == [1.5, 1.5]
    assert [r["main"] for r in ranks] == [True, False]
    assert multihost.broadcast_scalar(3.25) == 3.25 and multihost.all_hosts_max(2.0) == 2.0


# --------------------------------------------------------------------------
# serving over two CPU devices
# --------------------------------------------------------------------------

def _assert_same_outputs(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if k == "masks":       # a skipped slot chunk: 0.5 where no slot is valid
            v = a["valid"][..., None, None].expand_as(a[k])
            assert torch.equal(a[k][v], b[k][v])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mask_chunk", [32, 8])
def test_sharded_infer_equals_unsharded(mask_chunk):
    c = tiny_test_config()
    cfg = c.replace(infer=dataclasses.replace(c.infer, mask_chunk=mask_chunk),
                    group=dataclasses.replace(c.group, **LOW_THRESH))
    model = build_model(cfg.model, seed=0, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    want = build_infer_fn(model, cfg, device="cpu")(imgs)
    devices = make_mesh(2, "cpu")
    assert devices == [torch.device("cpu")] * 2
    got = build_infer_fn(model, cfg, devices=devices)(imgs)
    assert int(want["valid"].sum()) > 0
    _assert_same_outputs(got, want)
    with pytest.raises(ValueError, match="divide"):
        build_infer_fn(model, cfg, devices=devices)(imgs[:3])


def test_sharded_tiled_equals_unsharded():
    c = tiny_test_config()
    cfg = c.replace(infer=dataclasses.replace(c.infer, tile_size=128, tile_overlap=32),
                    group=dataclasses.replace(c.group, **LOW_THRESH))
    model = build_model(cfg.model, seed=0, device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    want = build_tiled_infer_fn(model, cfg, (224, 224), device="cpu", tile_batch=2)(img)
    got = build_tiled_infer_fn(model, cfg, (224, 224), devices=make_mesh(2, "cpu"),
                               tile_batch=2)(img)
    assert int(want["valid"].sum()) > 0
    _assert_same_outputs(got, want)
    with pytest.raises(ValueError, match="multiple"):
        build_tiled_infer_fn(model, cfg, (224, 224), devices=make_mesh(2, "cpu"), tile_batch=3)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_json(tmp_path_factory):
    c = tiny_test_config()
    c = c.replace(data=dataclasses.replace(c.data, max_instances=12),
                  train=dataclasses.replace(c.train, lr_warmup_steps=1))
    path = str(tmp_path_factory.mktemp("cfg") / "tiny.json")
    with open(path, "w") as f:
        f.write(config_to_json(c))
    return path


def _train_argv(tiny_json, save_dir, *extra):
    return (["--config", tiny_json, "--dataset", "synthetic", "--synthetic_n", "8",
             "--input_size", str(SIDE), "--batch_size", str(GLOBAL_B), "--num_epochs", "1",
             "--steps_per_epoch", "2", "--steps_per_dispatch", "2", "--rss_limit_gb", "0",
             "--save_dir", str(save_dir), "--device", "cpu"] + TINY_FLAGS + list(extra))


def _procs(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side (one torch thread each); their output,
    after every one exited 0.  None outlives TIMEOUT_S."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "kgtpu_torch.cli.train", *c], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:     # never leave a rank waiting in a collective
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def cli_runs(tiny_json, tmp_path_factory):
    """The same 2-step run (one dispatch of k = 2) in one process, on two
    --coordinator processes, and as --ngpus 2."""
    base = tmp_path_factory.mktemp("cli")
    port = launch.free_port()
    _procs([_train_argv(tiny_json, base / "one")]
           + [_train_argv(tiny_json, base / "mh", "--coordinator", f"localhost:{port}",
                          "--num_hosts", "2", "--host_id", str(i)) for i in range(2)]
           + [_train_argv(tiny_json, base / "ngpus", "--ngpus", "2")])
    return {name: base / name for name in ("one", "mh", "ngpus")}


def _metrics(save_dir) -> list[dict]:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_coordinator_processes_train(cli_runs):
    mh, one = _metrics(cli_runs["mh"]), _metrics(cli_runs["one"])
    assert len(mh) == 1 and np.isfinite(mh[0]["loss"])
    print(f"loss: two processes {mh[0]['loss']}, one process {one[0]['loss']}")
    np.testing.assert_allclose(mh[0]["loss"], one[0]["loss"], rtol=2e-4)
    assert sorted(os.listdir(cli_runs["mh"])) == ["metrics.jsonl", "model_0"]
    state = train_lib.create_train_state(tiny_test_config(), device="cpu")
    restored = checkpoint.restore(os.path.join(cli_runs["mh"], "model_0"), state=state)
    assert restored["epoch"] == 0 and state.step == 2


def test_ngpus_spawned_ranks_train_the_same(cli_runs):
    """--ngpus 2 on the CPU: two gloo ranks from one launcher, the same
    result as two --coordinator hosts."""
    a, b = _metrics(cli_runs["ngpus"]), _metrics(cli_runs["mh"])
    drop = ("img_per_sec", "host_rss_gb")
    assert [{k: v for k, v in r.items() if k not in drop} for r in a] == \
        [{k: v for k, v in r.items() if k not in drop} for r in b]
    pa = checkpoint.restore(os.path.join(cli_runs["ngpus"], "model_0"))
    pb = checkpoint.restore(os.path.join(cli_runs["mh"], "model_0"))
    for section in ("params", "ema"):
        for name, t in pa.get(section, {}).items():
            assert torch.equal(t, pb[section][name]), name


@pytest.mark.parametrize("tiled", [False, True])
def test_cli_test_ngpus_equals_one_device(cli_runs, tmp_path, tiled):
    from kgtpu_torch.cli import test as test_cli
    flags = ["--dataset", "synthetic", "--input_size", "128" if tiled else str(SIDE),
             "--weights", str(cli_runs["one"] / "model_0"), "--batch_size", "4",
             "--device", "cpu", "--conf_thresh", "0.01"]
    if tiled:
        flags += ["--tiled", "--tile_size", "64", "--tile_overlap", "16"]
    outs = {}
    for n in (1, 2):
        save = tmp_path / f"n{n}"
        assert test_cli.main(flags + ["--ngpus", str(n), "--save_dir", str(save)]) == 0
        outs[n] = save
    names = sorted(f for f in os.listdir(outs[1]) if f.endswith("_label.png"))
    assert names and names == sorted(f for f in os.listdir(outs[2]) if f.endswith("_label.png"))
    for f in names:
        assert np.array_equal(read_png(str(outs[1] / f)), read_png(str(outs[2] / f))), f
    with open(outs[1] / "detections.json") as f1, open(outs[2] / "detections.json") as f2:
        assert json.load(f1) == json.load(f2)
