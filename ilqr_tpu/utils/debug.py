"""Numerical debugging aids.

The reference has no sanitizers (SURVEY.md section 5 "Race detection"); the
device-side equivalents are NaN trapping and cross-sharding determinism
checks -- the failure modes a data-parallel numerical code actually has.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import jax


@contextlib.contextmanager
def nan_checking():
    """Enable jax_debug_nans within a scope (errors pinpoint the op that
    produced the first NaN)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_sharding_determinism(fn: Callable, sharded_args, replicated_fn: Callable,
                               replicated_args, atol: float = 0.0) -> dict:
    """Run the same computation sharded and unsharded; report max deviations.

    Returns {leaf_path: max_abs_diff}. atol=0 demands bitwise determinism
    (valid for row-partitioned batches with no cross-row reductions).
    """
    out_sh = jax.tree.map(np.asarray, fn(*sharded_args))
    out_re = jax.tree.map(np.asarray, replicated_fn(*replicated_args))
    flat_sh, _ = jax.tree.flatten(out_sh)
    flat_re, _ = jax.tree.flatten(out_re)
    report = {}
    for i, (a, b) in enumerate(zip(flat_sh, flat_re)):
        d = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))) if a.size else 0.0
        report[f"leaf{i}"] = d
        if d > atol:
            raise AssertionError(
                f"sharded vs replicated mismatch at leaf {i}: max|diff|={d} > {atol}")
    return report
