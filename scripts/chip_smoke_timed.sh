#!/bin/bash
# Run chip_smoke.py of a checkout and keep its output with the seconds
# since the start at each line (the phase end times of PERF.md §5).
#
#   bash scripts/chip_smoke_timed.sh [CHECKOUT] [OUT_PREFIX]
#
# CHECKOUT defaults to this one (a checkout of another tree: unpack it
# with `git archive <tree> | tar -x -C DIR` into a git-ignored DIR);
# OUT_PREFIX (default build/smoke, from here) gets OUT_PREFIX.txt,
# the output as printed, and OUT_PREFIX_stamps.txt, each line's first 160
# characters after its elapsed seconds.  Exits with chip_smoke.py's code.
set -o pipefail
tree=${1:-.}
prefix=${2:-build/smoke}
case $prefix in /*) ;; *) prefix=$(pwd)/$prefix ;; esac
mkdir -p "$(dirname "$prefix")"
cd "$tree" || exit 2
python3 chip_smoke.py 2>&1 | python3 -c "
import sys, time
t = time.time()
with open(sys.argv[1], 'w') as f:
    for line in sys.stdin:
        sys.stdout.write(line)
        sys.stdout.flush()
        f.write(f'{time.time() - t:.1f} {line[:160].rstrip()}\n')
        f.flush()
" "${prefix}_stamps.txt" > "$prefix.txt"
