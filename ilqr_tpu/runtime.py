"""Process set-up shared by the entry points (bench.py, chip_smoke.py, the
apps and the tools). Library modules never call it: importing the package
changes no JAX setting.

- Compile cache: where ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it
  itself and nothing here overrides it; otherwise the cache lives in a fixed
  ``.jax_cache/`` at the checkout root, so a second run of the same program
  finds what the first compiled.
- No hidden fallback: an entry point runs on the GPU, or on the CPU only
  when the user asked for it with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Mapping, Optional

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".jax_cache")


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory an entry point must set as JAX's compile cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses it), else the
    fixed checkout-root ``.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def cpu_requested() -> bool:
    platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return platforms.strip().lower() == "cpu"


def platform() -> str:
    """"gpu" when JAX sees a GPU, "cpu" when the CPU was asked for
    explicitly; anything else exits non-zero."""
    if cpu_requested():
        return "cpu"
    try:
        if jax.devices("gpu"):
            return "gpu"
    except RuntimeError:
        pass
    sys.exit("no GPU found; set JAX_PLATFORMS=cpu to run on the CPU")


def setup(x64: bool = False) -> str:
    """Configure JAX for an entry point; returns the platform."""
    cache = compile_cache_dir()
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)
    if x64:
        jax.config.update("jax_enable_x64", True)
    return platform()


def engine_for(platform_name: str) -> str:
    """Default solve engine: the fused kernel on the GPU, the XLA engine on
    the CPU (the kernel's interpreter is a test vehicle, not a path)."""
    return "kernel" if platform_name == "gpu" else "xla"


def device_info() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()
