#!/bin/bash
# Full regression suite with per-file process isolation.
#
# Why: the one-process suite can die mid-run in an order/state-dependent
# XLA:CPU compiler segfault (backend_compile_and_load, observed at
# tests/test_viz.py::test_cilqr_demo_cli_smoke after the long
# test_pallas_kernel/test_sharding block -- the same file passes alone in
# seconds; NOTES.md "XLA:CPU segfault family"). Running
# each test file in a fresh interpreter removes the cross-file compiler
# state the crash needs and contains any future instance to one file's
# result instead of killing the whole net.
#
# Cost: each process re-jits its own programs (no cross-file jit cache),
# but the cache sharing between files was minimal anyway (different
# shapes); measured wall time is comparable to the one-process run.
#
# Usage: bash tools/run_suite.sh [extra pytest args...]
# Exit: 0 iff every file passed.
cd "$(dirname "$0")/.."
rc=0
for f in tests/test_*.py; do
  t0=$SECONDS
  if ! python -m pytest "$f" -q "$@"; then
    echo "FAILED: $f"
    rc=1
  fi
  echo "== $f done in $((SECONDS-t0))s"
done
exit $rc
