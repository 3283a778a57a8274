#!/bin/bash
# The spread of one cell on the card: two sets of runs on the same seeds, then
# traced runs on fresh seeds, each run a process of its own, as the check makes
# them. Run from the root of a checkout:
#
#   bash perf_h100/sets.sh <out dir> <cell> <first seed> [runs a set: 6] [traced: 3]
#
# Each run's standard output and error go to <out dir>/<cell>.<set>.<seed>.{out,err};
# the last line of each run is echoed.
set -u
out=$1 cell=$2 first=$3 runs=${4:-6} traced=${5:-3}
seconds=$(python3 -c "import json; print(json.load(open('BENCHMARK.json'))['run_seconds'])")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/$cell.card.txt"
one() {  # set seed trace
  python3 perf_h100/run.py --workload "$cell" --seed "$2" --seconds "$seconds" --trace "$3" \
    > "$out/$cell.$1.$2.out" 2> "$out/$cell.$1.$2.err"
  echo "$cell $1 $2 rc=$? $(tail -n 1 "$out/$cell.$1.$2.out" | cut -c1-600)"
}
for set in A B; do
  for ((i = 0; i < runs; i++)); do one $set $((first + i)) 0; done
done
for ((i = 0; i < traced; i++)); do one T $((first + runs + i)) 1; done
