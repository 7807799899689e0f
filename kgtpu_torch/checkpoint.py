"""Checkpoints in the port's own format: counterpart of `kgtpu/checkpoint.py`.

A checkpoint is a directory `<save_dir>/model_<epoch>` holding

  tensors.pt  a `torch.save` of tensors only, read back with
              `torch.load(weights_only=True)`:
                {"params": {name: tensor},          the model's state_dict
                                                    (BatchNorm running stats
                                                    included)
                 "ema":    {name: tensor},          the parameters' EMA, when
                                                    the run keeps one
                 "opt":    {"mu": {name: tensor}, "nu": {name: tensor},
                            "count": 0-d int64},    the `Optimizer`'s state
                 "step": 0-d int64, "epoch": 0-d int64}
              ("ema", "opt" and "step" are absent from params-only files);
  meta.json   {"format": FORMAT, "extra": {...}}: the free-form extras, such
              as "config_json" (`encode_config`), "max_gt_box_side_px" and
              "train_input_size" (read by `predictor.size_prior_fallback`).

Tensor names are the model's parameter names, so the optimizer moments and
the EMA load by name.  A save writes a temporary directory and renames it
into place, so a reader never sees half a checkpoint; `save(block=False)`
copies the tensors to the host at once and writes them on a thread that
`wait()` joins.  `resolve` accepts a run directory (its latest epoch), a
`model_<epoch>` path, or `<dir>/best` (the epoch in `best.json`); `prune`
keeps the newest epochs, the best.json epoch and the pinned.json epochs.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading

import numpy as np
import torch

from kgtpu_torch.config import Config, config_from_json, config_to_json

FORMAT = "kgtpu_torch-checkpoint-1"
TENSORS = "tensors.pt"
META = "meta.json"
_NAME = re.compile(r"^model_(\d+)$")

_writers: list[threading.Thread] = []
_writers_lock = threading.Lock()


def wait() -> None:
    """Block until every `save(..., block=False)` is on disk; re-raises the
    first error a writer met."""
    with _writers_lock:
        pending = list(_writers)
        _writers.clear()
    errors = []
    for t in pending:
        t.join()
        errors += t.errors
    if errors:
        raise errors[0]


def _jsonable(extra: dict | None) -> dict:
    """Extras as JSON values: strings stay, arrays and numpy scalars become
    numbers or lists."""
    out = {}
    for k, v in (extra or {}).items():
        if isinstance(v, (str, bool, int, float)) or v is None:
            out[k] = v
        else:
            a = np.asarray(v)
            out[k] = a.item() if a.ndim == 0 else a.tolist()
    return out


def _names(model: torch.nn.Module) -> list[str]:
    return [n for n, _ in model.named_parameters()]


def _host(tensors: list[torch.Tensor], names: list[str]) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in zip(names, tensors)}


def state_payload(state) -> dict:
    """The tensors of a `train_lib.TrainState`, copied to the host."""
    names = _names(state.model)
    opt = state.optimizer
    payload = {
        "params": {k: v.detach().to("cpu", copy=True)
                   for k, v in state.model.state_dict().items()},
        "opt": {"mu": _host(opt.mu, names), "nu": _host(opt.nu, names),
                "count": torch.tensor(opt.count, dtype=torch.int64)},
        "step": torch.tensor(state.step, dtype=torch.int64),
    }
    if state.ema is not None:
        payload["ema"] = _host(state.ema, names)
    return payload


def _write(path: str, payload: dict, extra: dict) -> None:
    parent = os.path.dirname(path)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    os.chmod(tmp, 0o755)
    try:
        torch.save(payload, os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, META), "w") as f:
            json.dump({"format": FORMAT, "extra": extra}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_payload(save_dir: str, epoch: int, payload: dict,
                  extra: dict | None = None, block: bool = True) -> str:
    """Write `payload` (the tensors.pt dict, without "epoch") as
    save_dir/model_<epoch>, replacing one that exists.  Returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(save_dir, f"model_{epoch}"))
    payload = {**payload, "epoch": torch.tensor(epoch, dtype=torch.int64)}
    extra = _jsonable(extra)
    if block:
        _write(path, payload, extra)
        return path

    def run():
        try:
            _write(path, payload, extra)
        except Exception as e:   # noqa: BLE001 - handed to wait()
            t.errors.append(e)

    t = threading.Thread(target=run, name=f"checkpoint-{epoch}", daemon=False)
    t.errors = []
    with _writers_lock:
        _writers.append(t)
    t.start()
    return path


def save(save_dir: str, epoch: int, state, extra: dict | None = None,
         block: bool = True) -> str:
    """Write a `train_lib.TrainState` (parameters, optimizer moments and
    count, step, EMA) and `extra` as save_dir/model_<epoch>.  block=False
    returns once the tensors are on the host; `wait()` before reading it."""
    return write_payload(save_dir, epoch, state_payload(state), extra, block)


def encode_config(cfg: Config) -> str:
    """Config -> the "config_json" extra that makes a checkpoint
    self-describing."""
    return config_to_json(cfg)


def decode_config(extra: dict) -> Config | None:
    """The Config stored by `encode_config`, or None when there is none."""
    blob = extra.get("config_json")
    return None if blob is None else config_from_json(blob)


def latest_path(save_dir: str) -> str | None:
    if not os.path.isdir(save_dir):
        return None
    best, best_e = None, -1
    for d in os.listdir(save_dir):
        m = _NAME.match(d)
        if m and int(m.group(1)) > best_e:
            best, best_e = d, int(m.group(1))
    return os.path.join(save_dir, best) if best else None


def prune(save_dir: str, keep_last: int) -> list[str]:
    """Delete all but the keep_last highest-epoch model_<epoch> dirs, sparing
    the epoch in best.json and every epoch listed in pinned.json (temporary
    dirs of saves in flight do not match model_<epoch>).  Returns the
    deleted paths."""
    if keep_last <= 0 or not os.path.isdir(save_dir):
        return []
    epochs = sorted(int(_NAME.match(d).group(1))
                    for d in os.listdir(save_dir) if _NAME.match(d))
    protect = set(epochs[-keep_last:])
    marker = os.path.join(save_dir, "best.json")
    if os.path.isfile(marker):
        with open(marker) as f:
            protect.add(int(json.load(f)["epoch"]))
    pins = os.path.join(save_dir, "pinned.json")
    if os.path.isfile(pins):
        with open(pins) as f:
            protect.update(int(e) for e in json.load(f))
    deleted = []
    for e in epochs:
        if e not in protect:
            p = os.path.join(save_dir, f"model_{e}")
            shutil.rmtree(p, ignore_errors=True)
            deleted.append(p)
    return deleted


def resolve(path_or_dir: str) -> str:
    """A run directory (-> its latest model_<epoch>), a model_<epoch> path,
    or `<dir>/best` (-> the epoch recorded in <dir>/best.json)."""
    p = os.path.abspath(path_or_dir)
    if os.path.basename(p).startswith("model_"):
        return p
    if os.path.basename(p) == "best":
        marker = os.path.join(os.path.dirname(p), "best.json")
        if not os.path.isfile(marker):
            raise FileNotFoundError(
                f"{marker} not found: 'best' needs a run that tracked its best "
                "epoch (best.json)")
        with open(marker) as f:
            best = json.load(f)
        return os.path.join(os.path.dirname(p), f"model_{best['epoch']}")
    latest = latest_path(p)
    if latest is None:
        raise FileNotFoundError(f"no model_<epoch> checkpoints under {p}")
    return os.path.abspath(latest)


def _read(path: str) -> tuple[dict, dict]:
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    payload = torch.load(os.path.join(path, TENSORS), map_location="cpu",
                         weights_only=True)
    return payload, meta.get("extra", {})


def _copy_in(dst: list[torch.Tensor], names: list[str], src: dict) -> None:
    with torch.no_grad():
        for n, t in zip(names, dst):
            t.copy_(src[n])


def restore(path_or_dir: str, state=None) -> dict:
    """Without `state`: the payload ({"params", "step", "epoch", ...} and
    "extra").  With a `train_lib.TrainState`: loads parameters, optimizer
    moments and count, step and EMA into it in place (on its device) and
    returns {"state": state, "epoch": int}."""
    payload, extra = _read(resolve(path_or_dir))
    if state is None:
        return {**payload, "extra": extra}
    if "opt" not in payload:
        raise ValueError("a params-only checkpoint cannot resume a train state; "
                         "use init_params_from")
    names = _names(state.model)
    state.model.load_state_dict(payload["params"], strict=True)
    opt = state.optimizer
    _copy_in(opt.mu, names, payload["opt"]["mu"])
    _copy_in(opt.nu, names, payload["opt"]["nu"])
    opt.count = int(payload["opt"]["count"])
    state.step = int(payload["step"])
    if state.ema is not None:
        _copy_in(state.ema, names, payload.get("ema", payload["params"]))
    return {"state": state, "epoch": int(payload["epoch"])}


def restore_bundle(path_or_dir: str, use_ema: bool = False) -> tuple[dict, dict]:
    """(state_dict, extra) for inference: the EMA parameters when use_ema and
    the checkpoint has them, else the parameters.  The EMA covers parameters
    only: a BatchNorm model's running stats come from the raw state_dict
    either way, as kgtpu pairs its EMA params with the live batch_stats."""
    payload, extra = _read(resolve(path_or_dir))
    ema = payload.get("ema") if use_ema else None
    if ema is None:
        return payload["params"], extra
    return {**payload["params"], **ema}, extra


def restore_extra(path_or_dir: str) -> dict:
    """The extras alone."""
    with open(os.path.join(resolve(path_or_dir), META)) as f:
        return json.load(f).get("extra", {})


def restore_params(path_or_dir: str, use_ema: bool = False) -> dict:
    """The inference state_dict (see restore_bundle)."""
    return restore_bundle(path_or_dir, use_ema=use_ema)[0]


def init_params_from(state, path_or_dir: str, use_ema: bool = False):
    """Fine-tuning init: load only the network weights into a fresh train
    state; optimizer, step and epoch stay as they are, and the EMA restarts
    from the loaded weights.  A different architecture exits with the first
    differing names and shapes."""
    params = restore_params(path_or_dir, use_ema=use_ema)
    have = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:8]
        raise SystemExit("--init_from checkpoint does not match the model being "
                         f"trained; first differing entries: {diff}")
    state.model.load_state_dict(params, strict=True)
    if state.ema is not None:
        with torch.no_grad():
            for e, p in zip(state.ema, state.model.parameters()):
                e.copy_(p)
    return state
