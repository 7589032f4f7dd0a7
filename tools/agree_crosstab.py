"""Per-row f64-agreement cross-tab from a validation dump.

Reads a ``validate_kernel.py --dump`` npz plus the per-row f64
statuses in tools/f64_anchors.json and prints the 2x2 contingency of
(kernel matches f64 truth) x (XLA f32 matches f64 truth) over the full
batch — the row-level evidence behind the conv-gate form
(gap_truth(kernel) <= max(0.03, gap_truth(xla)); docs/PARITY.md 4b):
if the kernel's wrong rows are mostly rows the f32 XLA build also gets
wrong (shared f32 decision-boundary chaos), the kernel's aggregate gap
measures build chaos, not kernel error.

Usage:
  python tools/validate_kernel.py --scenario scenario_three_bend --dump dump
  python tools/agree_crosstab.py dump/val_scenario_three_bend.npz
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    path = sys.argv[1]
    name = os.path.basename(path).replace("val_", "").replace(".npz", "")
    d = np.load(path)
    with open(os.path.join(REPO, "tools", "f64_anchors.json")) as f:
        a = json.load(f)[name]
    assert int(a["batch"]) == int(d["batch"]) and int(a["seed"]) == int(d["seed"])
    truth = np.array([int(c) for c in a["status_rows"]])
    k_ok = d["stat_k"] == truth
    r_ok = d["stat_r"] == truth
    n = len(truth)
    print(f"{name}: batch {n}, f64 conv {a['conv']:.4f}")
    print(f"  kernel matches f64:      {k_ok.sum():4d} ({k_ok.mean():.3f})")
    print(f"  xla f32 matches f64:     {r_ok.sum():4d} ({r_ok.mean():.3f})")
    print(f"  both match:              {(k_ok & r_ok).sum():4d}")
    print(f"  kernel-only wrong:       {(~k_ok & r_ok).sum():4d}")
    print(f"  xla-only wrong:          {(k_ok & ~r_ok).sum():4d}")
    print(f"  both wrong:              {(~k_ok & ~r_ok).sum():4d}")
    kw = ~k_ok
    if kw.any():
        shared = (kw & ~r_ok).sum() / kw.sum()
        print(f"  of kernel-wrong rows, fraction XLA also wrong: {shared:.3f}")
    # iteration-count context on the disagreeing rows: boundary rows
    # oscillate near max_iter / the lambda ceiling
    it_k = d["it_k"]
    print(f"  mean iters: kernel-wrong rows {it_k[kw].mean():.1f} vs "
          f"kernel-right rows {it_k[k_ok].mean():.1f}")


if __name__ == "__main__":
    main()
