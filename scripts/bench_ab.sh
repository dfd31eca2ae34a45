#!/bin/bash
# Run benchmark cells on two checkouts of the PyTorch port on one card, in
# turns, and keep each run's output and last line.
#
#   bash scripts/bench_ab.sh PARENT_DIR OUT_DIR TRACE WORKLOAD:SEED[,SEED...] [WORKLOAD:SEEDS ...]
#
# PARENT_DIR is a checkout of the commit to compare with (unpack it with
# `git archive <commit> | tar -x -C PARENT_DIR` into a git-ignored
# directory); this checkout is the other.  Each seed is one round of two
# runs on that seed, parent first on the 1st, 3rd, ... seed of a cell and
# second on the others (parent, change, change, parent, ...).  TRACE is
# run.py's --trace (0 or 1).  Each run's standard output and error go to
# OUT_DIR/<workload>.<side>.<seed>.t<trace>.{out,err}, its last line with
# the side, seed and wall to OUT_DIR/runs.jsonl, the card's name and power
# limit to OUT_DIR/card.txt.  The kernels are built first, into this
# checkout's build/kernels, which the parent's links to (the same sources
# give the same build), so no run's set-up holds a build.  Exits non-zero
# if any run failed.
set -u
parent=$(cd "$1" && pwd)
out=$2
trace=$3
shift 3
here=$(pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$out/card.txt"
mkdir -p "$here/build/kernels" "$parent/build"
[ -e "$parent/build/kernels" ] || ln -s "$here/build/kernels" "$parent/build/kernels"
python3 -c "from spatialrgpt_tpu_torch.ops import _build; _build.lib()" || exit 1
status=0
for cell in "$@"; do
  workload=${cell%%:*}
  i=0
  seeds=${cell#*:}
  for seed in ${seeds//,/ }; do
    sides="parent change"
    [ $((i % 2)) -eq 1 ] && sides="change parent"
    for side in $sides; do
      dir=$here
      [ "$side" = parent ] && dir=$parent
      base="$out/$workload.$side.$seed.t$trace"
      t0=$(date +%s.%N)
      (cd "$dir" && python3 benchmark/run.py --workload "$workload" --seed "$seed" --seconds 40 --trace "$trace") \
        > "$base.out" 2> "$base.err"
      rc=$?
      wall=$(awk "BEGIN { print $(date +%s.%N) - $t0 }")
      last=$(tail -n 1 "$base.out")
      [ $rc -ne 0 ] || [ -z "$last" ] && last=null
      echo "{\"workload\": \"$workload\", \"side\": \"$side\", \"seed\": $seed, \"trace\": $trace, \"rc\": $rc, \"wall\": $wall, \"result\": $last}" >> "$out/runs.jsonl"
      echo "$workload $side $seed t$trace rc=$rc wall=$wall $(grep -h '^traced calls' "$base.err")"
      [ $rc -ne 0 ] && status=1
    done
    i=$((i + 1))
  done
done
exit $status
