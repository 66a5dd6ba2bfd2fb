#!/usr/bin/env bash
# Two sets of runs of one cell with the same seeds, each run its own
# process as the driver makes it, every result line kept for spread.py:
#   bash h100_bench/tools/sets.sh WORKLOAD SECONDS OUT.jsonl SEED...
set -u
W=$1; S=$2; OUT=$3; shift 3
for set in 1 2; do
  for seed in "$@"; do
    line=$(python3 h100_bench/run.py --workload "$W" --seed "$seed" --seconds "$S" --trace 0 | tail -n 1)
    if [ -z "$line" ]; then
      echo "sets.sh: $W seed $seed printed no result" >&2
      continue
    fi
    echo "{\"set\": $set, \"seed\": $seed, \"line\": $line}" >> "$OUT"
  done
done
