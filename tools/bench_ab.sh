#!/usr/bin/env bash
# A/B of the port's headline bench (`python3 -m kgtpu_torch.cli.bench`)
# between a parent tree and this one, on one card, in turns:
# parent, change, change, parent.
#
#   git archive <parent> kgtpu_torch | tar -x -C <dir>
#   bash tools/bench_ab.sh <dir> <out.jsonl>
#
# Each run's JSON line goes, tagged with its tree, to <out.jsonl>; the
# card's name and power limit come first.
set -euo pipefail
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out=$(realpath -m "$2")
mkdir -p "$(dirname "$out")"
: > "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out"
for tree in parent change change parent; do
  dir=$here
  [ "$tree" = parent ] && dir=$parent
  line=$(cd "$dir" && python3 -m kgtpu_torch.cli.bench | tail -n 1)
  echo "{\"tree\": \"$tree\", \"bench\": $line}" | tee -a "$out"
done
