#!/bin/bash
# Run chip_smoke.py of two checkouts of the PyTorch port on one card, in
# turns (A, B, B, A per round), and keep each run's output.
#
#   bash scripts/torch_smoke_ab.sh PARENT_DIR [OUT_DIR] [ROUNDS]
#
# PARENT_DIR is a checkout of the commit to compare with (unpack it with
# `git archive <commit> | tar -x -C PARENT_DIR` into a git-ignored
# directory); this checkout is the other.  ROUNDS (default 1) rounds give
# 2 * ROUNDS runs of each.  Each run's output goes to
# OUT_DIR/{parent,change}<n>.log (default build/smoke_ab), the card's
# name and power limit to OUT_DIR/card.txt.  Exits non-zero if any run
# failed.
set -u
parent=$1
out=${2:-build/smoke_ab}
rounds=${3:-1}
here=$(pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
status=0
for ((r = 0; r < rounds; r++)); do
  a=$((2 * r + 1))
  b=$((2 * r + 2))
  for run in parent:$a change:$a change:$b parent:$b; do
    tree=${run%%:*}
    n=${run##*:}
    dir=$here
    [ "$tree" = parent ] && dir=$parent
    (cd "$dir" && python3 chip_smoke.py) > "$out/$tree$n.log" 2>&1
    rc=$?
    echo "$tree$n rc=$rc"
    [ $rc -ne 0 ] && status=1
  done
done
exit $status
