"""Process set-up shared by the entry points (cli, bench.py, chip_smoke.py)."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# Fixed, git-ignored compile-cache directory in the checkout. The path is
# part of the cache key, so it must not move between runs.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a stable directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing here overrides it. Otherwise the cache lives in
    :data:`CACHE_DIR`. Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
