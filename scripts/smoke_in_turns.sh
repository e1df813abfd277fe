#!/bin/bash
# Runs chip_smoke.py in each given checkout in turn, each building its
# kernels afresh, and prints each run's exit code and command seconds; the
# runs' output goes to OUT_DIR/LABEL.log and .err. Two trees compared on one
# card run in turns: parent, change, change, parent.
#
#   scripts/smoke_in_turns.sh OUT_DIR DIR:LABEL [DIR:LABEL ...]
set -u
out=$(realpath "$1"); shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for arg in "$@"; do
  dir=${arg%%:*}; label=${arg##*:}
  cd "$dir" || exit 1
  rm -rf build
  t0=$(date +%s.%N)
  python3 chip_smoke.py > "$out/$label.log" 2> "$out/$label.err"
  rc=$?
  t1=$(date +%s.%N)
  cd - > /dev/null
  echo "$label rc=$rc command_s=$(python3 -c "print($t1 - $t0)")"
  tail -1 "$out/$label.log" | cut -c1-200
done
