#!/usr/bin/env bash
# The runs a cell's bound is set from, on this machine's card: two sets of
# runs at BENCHMARK.json's run_seconds with the same seeds in both sets
# (A0.., then B0..), then a traced run for each trace seed. Each run's
# output goes to <out-dir>/<run>.out and .err; one line a run is printed.
#
#   bash portbench/sets.sh <cell> <out-dir> <seed>... [-- <trace seed>...]
#
# Run from the root of a checkout.
set -u
W=$1; O=$2; shift 2
mkdir -p "$O"
S=(); while [ $# -gt 0 ] && [ "$1" != "--" ]; do S+=("$1"); shift; done
[ $# -gt 0 ] && shift
T=("$@")
L=$(python3 -c "import json; print(json.load(open('BENCHMARK.json'))['run_seconds'])")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
one() {
  python3 portbench/run.py --workload "$W" --seed "$1" --seconds "$L" --trace "$2" \
    > "$O/$3.out" 2> "$O/$3.err"
  echo "$3 seed $1 rc=$? $(tail -n1 "$O/$3.out" | cut -c1-400)"
}
for set in A B; do
  i=0; for s in "${S[@]}"; do one "$s" 0 "$set$i"; i=$((i + 1)); done
done
i=0; for s in "${T[@]}"; do one "$s" 1 "T$i"; i=$((i + 1)); done
