#!/usr/bin/env python
"""Convert a kgtpu (orbax) checkpoint to the PyTorch port's format.

    python tools/orbax_to_torch.py runs/kg_hard1024/model_99 out_dir \\
        [--use_ema] [--params_only]

Runs where jax, orbax and kgtpu are installed; the port reads the result
without them (`kgtpu_torch.checkpoint`, `Predictor.from_checkpoint`,
`python -m kgtpu_torch.cli.test --weights out_dir`).  Writes
out_dir/model_<epoch>, at the source's epoch:

  * default: the whole train state: parameters, EMA when the source has
    one, the Adam moments and count, and the step, so a port run can resume;
  * --params_only: the parameters alone, f32, for serving; with --use_ema
    they are the source's EMA parameters.

Every flax leaf maps onto a port parameter (`kgtpu_torch.convert`), for
every backbone and norm; a BatchNorm model's batch_stats become the
running-stat buffers of the parameters (raw or EMA, as kgtpu serves them);
the moments map like the parameters they belong to.  The stored config is read
with the port's `config_from_json` (which refuses a setting the port would
drop) and stored again in the port's form, with the dataset stats extras.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, dst_dir: str, use_ema: bool = False, params_only: bool = False) -> str:
    import jax
    import numpy as np
    import torch

    from kgtpu import checkpoint as jckpt
    from kgtpu.config import config_to_json
    from kgtpu_torch import checkpoint
    from kgtpu_torch.config import config_from_json
    from kgtpu_torch.convert import flax_to_state_dict

    if use_ema and not params_only:
        raise SystemExit("--use_ema needs --params_only: a whole train state keeps "
                         "both the parameters and their EMA")
    jax.config.update("jax_platforms", "cpu")
    payload = jckpt._restore_numpy(jckpt.resolve(src))
    extra = {k: np.asarray(v) for k, v in (payload.get("extra") or {}).items()}
    stored = jckpt.decode_config(extra)
    if stored is None:
        raise SystemExit(f"{src} has no stored config; the converter needs the "
                         "architecture it was trained with")
    cfg = config_from_json(config_to_json(stored))

    def sd(tree):
        return flax_to_state_dict(jax.tree.map(np.asarray, tree), cfg.model)

    params = payload["params"]
    if use_ema:
        if payload.get("ema_params") is None:
            raise SystemExit(f"{src} has no EMA parameters")
        params = payload["ema_params"]
    # a BatchNorm model's running stats go with the parameters, raw or EMA
    stats = payload.get("batch_stats")
    out = {"params": sd(params if stats is None
                        else {"params": params, "batch_stats": stats})}
    if not params_only:
        adam = payload["opt_state"][1][0]
        out["opt"] = {"mu": sd(adam["mu"]), "nu": sd(adam["nu"]),
                      "count": torch.tensor(int(adam["count"]), dtype=torch.int64)}
        out["step"] = torch.tensor(int(payload["step"]), dtype=torch.int64)
        if payload.get("ema_params") is not None:
            out["ema"] = sd(payload["ema_params"])
    extra["config_json"] = checkpoint.encode_config(cfg)
    return checkpoint.write_payload(dst_dir, int(payload["epoch"]), out, extra)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="orbax checkpoint (model_<epoch> or its run dir)")
    p.add_argument("dst_dir", help="directory to write model_<epoch> into")
    p.add_argument("--use_ema", action="store_true",
                   help="write the EMA parameters (with --params_only)")
    p.add_argument("--params_only", action="store_true",
                   help="write the parameters alone (serving)")
    a = p.parse_args(argv)
    print(convert(a.src, a.dst_dir, a.use_ema, a.params_only))
    return 0


if __name__ == "__main__":
    sys.exit(main())
