"""Wall-clock timing + profiling helpers.

Reference has two ``TicToc`` variants (include/utils.hpp:77-91 returning
seconds, include/utils.hpp:234-248 returning milliseconds). Here one class
covers both, plus JAX-aware device timing that brackets with
``block_until_ready`` so asynchronous dispatch doesn't lie to the timer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


class TicToc:
    def __init__(self) -> None:
        self.tic()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        """Elapsed seconds."""
        return time.perf_counter() - self._start

    def toc_ms(self) -> float:
        """Elapsed milliseconds."""
        return 1000.0 * self.toc()


def time_jax(fn: Callable, *args, warmup: int = 1, iters: int = 10, **kwargs) -> float:
    """Median wall seconds per call of a jitted fn, blocking on outputs."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    samples = []
    for _ in range(iters):
        t = TicToc()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        samples.append(t.toc())
    samples.sort()
    return samples[len(samples) // 2]


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context (device-side equivalent of the reference's
    per-solve TicToc logging, SURVEY.md section 5)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
