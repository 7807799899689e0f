#!/usr/bin/env bash
# A/B of the port between a parent tree and this one, on one card, in
# turns parent, change, change, parent (the turns repeated `rounds` times):
#
#   serve  the headline bench (`python3 -m kgtpu_torch.cli.bench`);
#   train  the eager train step of chip_smoke.py [6]'s protocol (the
#          default Config, batch 8, 512x512, one seeded batch, 30 timed
#          steps after a first, TF32 off): img/s over the 30 steps and the
#          median step ms.
#
#   git archive <parent> kgtpu_torch | tar -x -C <dir>
#   bash tools/bench_ab.sh <dir> <out.jsonl> [serve|train] [rounds]
#
# Each run's JSON line goes, tagged with its tree, to <out.jsonl>; the
# card's name and power limit come first.  For train a last line gives each
# tree's median, min and max and a two-sided Mann-Whitney U test of the two
# trees' img/s and step ms.
set -euo pipefail
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out=$(realpath -m "$2")
what=${3:-serve}
rounds=${4:-1}
mkdir -p "$(dirname "$out")"
: > "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out"

train_run() {  # <tree dir>: one eager-step run in a fresh process
  python3 - "$1" "$here" <<'EOF'
import json
import sys
import time

tree, here = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import numpy as np
import torch

import kgtpu_torch
if not kgtpu_torch.__file__.startswith(tree):
    raise RuntimeError(f"imported {kgtpu_torch.__file__}, not {tree}'s")
from kgtpu_torch import train_lib
from kgtpu_torch.config import Config
from kgtpu_torch.ops import gaussian

sys.path.insert(1, here)
import chip_smoke

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
gaussian.build()
cfg = Config()
batch = train_lib.batch_to_device(chip_smoke.train_batch(np, cfg, 8, seed=3), "cuda")
state = train_lib.create_train_state(cfg, seed=0)
step = train_lib.make_train_step(cfg)
g = torch.Generator(device="cuda").manual_seed(1)
wall = []
for _ in range(31):
    t = time.perf_counter()
    step(state, batch, g)
    torch.cuda.synchronize()
    wall.append(time.perf_counter() - t)
print(json.dumps({"train_img_per_s": 8 * 30 / sum(wall[1:]),
                  "step_ms_median": 1e3 * float(np.median(wall[1:]))}))
EOF
}

for _ in $(seq "$rounds"); do
  for tree in parent change change parent; do
    dir=$here
    [ "$tree" = parent ] && dir=$parent
    if [ "$what" = train ]; then
      line=$(train_run "$dir" | tail -n 1)
    else
      line=$(cd "$dir" && python3 -m kgtpu_torch.cli.bench | tail -n 1)
    fi
    echo "{\"tree\": \"$tree\", \"$what\": $line}" | tee -a "$out"
  done
done

if [ "$what" = train ]; then
  python3 - "$out" <<'EOF' | tee -a "$out"
import json
import sys

import numpy as np
from scipy.stats import mannwhitneyu

runs = [json.loads(line) for line in open(sys.argv[1]) if line.startswith("{")]
out = {}
for key in ("train_img_per_s", "step_ms_median"):
    vals = {t: [r["train"][key] for r in runs if r["tree"] == t] for t in ("parent", "change")}
    out[key] = {t: {"median": float(np.median(v)), "min": min(v), "max": max(v), "n": len(v)}
                for t, v in vals.items()}
    out[key]["mann_whitney_p"] = float(mannwhitneyu(vals["parent"], vals["change"]).pvalue)
print(json.dumps({"summary": out}))
EOF
fi
