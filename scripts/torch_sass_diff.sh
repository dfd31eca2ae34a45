#!/bin/bash
# Compare the machine code (SASS) of kernels in the port's kernel library
# of two checkouts, on a machine with the CUDA toolkit.
#
#   bash scripts/torch_sass_diff.sh PARENT_DIR OUT_DIR PARENT_FN:THIS_FN ...
#
# Builds (or reuses) the library of PARENT_DIR and of this checkout, dumps
# each named kernel's SASS with cuobjdump (mangled names; a kernel whose
# template arguments changed between the two trees has two names), strips
# addresses and encodings, and prints per pair the instruction counts and
# the number of differing lines (0: the same code).  The dumps go to
# OUT_DIR.  Exits non-zero if a kernel is missing from either library.
set -u
parent=$1
out=$2
shift 2
mkdir -p "$out"
objdump=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump
lib_of() { (cd "$1" && python3 -c "from spatialrgpt_tpu_torch.ops import _build; print(_build.build())"); }
P=$(lib_of "$parent") || exit 1
C=$(lib_of .) || exit 1
sass() {  # library, function -> one instruction per line
  "$objdump" -sass -fun "$2" "$1" 2>/dev/null | grep -E '^\s+/\*[0-9a-f]{4}\*/' |
    sed -E 's|^\s+/\*[0-9a-f]+\*/\s*||; s|\s*/\*.*||; s|\s*;.*||'
}
status=0
for pair in "$@"; do
  pf=${pair%%:*}
  cf=${pair##*:}
  sass "$P" "$pf" > "$out/parent_$pf.sass"
  sass "$C" "$cf" > "$out/this_$cf.sass"
  np=$(wc -l < "$out/parent_$pf.sass")
  nc=$(wc -l < "$out/this_$cf.sass")
  [ "$np" -eq 0 ] || [ "$nc" -eq 0 ] && status=1
  echo "$cf: parent $np instructions, this tree $nc, differing lines" \
    "$(diff "$out/parent_$pf.sass" "$out/this_$cf.sass" | grep -c '^[<>]')"
done
exit $status
