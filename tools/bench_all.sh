#!/bin/bash
# The bench cell matrix on the card, fused kernels against plain XLA.
#
#   bash tools/bench_all.sh                   # every cell, both paths
#   BENCH_PATHS=1 bash tools/bench_all.sh     # the kernel rows only
#
# One bench.py process per row, run one after another (one JAX process per
# card).  Each row prints bench.py's JSON line (device included) to stdout
# and appends it to $BENCH_OUT (default bench_all.jsonl, gitignored).
# BENCH_PALLAS=0 rows are the plain XLA path (metric tagged "-xla").
set -u
cd "$(dirname "$0")/.."
OUT=${BENCH_OUT:-bench_all.jsonl}
PATHS=${BENCH_PATHS:-1 0}

run() {
  echo "# $*"
  timeout 900 env "$@" python bench.py | tee -a "$OUT" \
    || echo "{\"error\": \"$*\"}" | tee -a "$OUT"
}

for path in $PATHS; do
  run BENCH_PALLAS=$path BENCH_MODE=ped
  run BENCH_PALLAS=$path BENCH_MODE=borders
  run BENCH_PALLAS=$path BENCH_MODE=borders BENCH_ENV_ANALYTIC=1
  run BENCH_PALLAS=$path BENCH_MODE=obstacles
  run BENCH_PALLAS=$path BENCH_MODE=urban
  run BENCH_PALLAS=$path BENCH_MODE=ensemble
  run BENCH_PALLAS=$path BENCH_MODE=ped BENCH_LAW=powerlaw
  run BENCH_PALLAS=$path BENCH_MODE=ped BENCH_LAW=helbing
done
# ORCA is plain jnp on both paths (no pair kernel); one row
run BENCH_MODE=ped BENCH_LAW=orca
# the cutoff regime: the kernel's 30 m cutoff against XLA's all-pairs (XLA
# has no cutoff path; 100 steps keep its O(N^2) row affordable)
run BENCH_MODE=ped BENCH_N=50000 BENCH_CUTOFF=30
case " $PATHS " in
  *" 0 "*) run BENCH_PALLAS=0 BENCH_MODE=ped BENCH_N=50000 BENCH_STEPS=100 ;;
esac
