"""Timing + structured metrics (replaces the reference's ad-hoc harnesses).

The reference timed with three different mechanisms scattered through the
code (chrono repeat-until-100ms main.cpp:62-74, gettimeofday-until-10s
GaussDePyramid-pThread.h:310-326, MPI_Wtime mpitest.cpp:40,95) and printed
unstructured lines. Here: one steady-state timer built on
`jax.block_until_ready`, an optional jax.profiler trace context, and a
JSONL metrics writer whose records use the BASELINE.md metric names.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Callable

import jax


def steady_state_ms(
    fn: Callable[[], Any],
    min_seconds: float = 1.0,
    warmup: int = 2,
) -> float:
    """Mean wall ms per call, repeated until ``min_seconds`` accumulated.

    The reference's repeat-until-threshold pattern (main.cpp:66-73).
    This wall-clock version measures end-to-end host-visible latency,
    dispatch included, which is what pipeline-level benchmarks want;
    `chained_slope_ms` measures device time per iteration instead.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    runs = 0
    while time.perf_counter() - t0 < min_seconds:
        jax.block_until_ready(fn())
        runs += 1
    return (time.perf_counter() - t0) / runs * 1e3


def chained_slope_ms(
    step: Callable[[Any], Any],
    example: Any,
    chain_lo: int = 50,
    chain_hi: int = 400,
    repeats: int = 4,
    median_of: int = 1,
    min_hi_total_ms: float | None = None,
) -> float:
    """Per-iteration device ms for ``step`` (an array -> scalar fn).

    Builds `lax.scan` chains of two lengths whose carry is perturbed by
    the step's scalar result (a data dependency XLA cannot elide or
    hoist), forces each total with a scalar fetch, and returns the slope —
    fixed dispatch and transfer overhead cancels exactly, so the result
    is device time without the host cost the product path pays.

    Two robustness knobs for fast ops, where fixed per-call overhead
    rivals the chain totals themselves:

    * ``min_hi_total_ms``: after a pilot measurement, stretch both chain
      lengths so the hi-chain total is at least this many ms — slope
      noise falls as 1/chain. The scan is compiled once per length, so
      longer chains cost runtime only (~no extra compile).
    * ``median_of``: take the median of several independent slope
      estimates (each best-of-``repeats``), rejecting residual outliers.
    """
    from jax import lax

    def make(chain: int):
        @jax.jit
        def chained(x):
            def body(c, _):
                return c + 1e-30 * step(c), None
            c, _ = lax.scan(body, x, None, length=chain)
            return c.sum()

        float(chained(example))  # compile + warm
        return chained

    def total_ms(chained) -> float:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(chained(example))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    if min_hi_total_ms is not None:
        pilot = make(chain_hi)
        t = total_ms(pilot)
        if t < min_hi_total_ms:
            scale = int(min_hi_total_ms / max(t, 1e-3)) + 1
            chain_lo, chain_hi = chain_lo * scale, chain_hi * scale

    lo_fn, hi_fn = make(chain_lo), make(chain_hi)
    slopes = []
    for _ in range(max(median_of, 1)):
        slopes.append(
            max((total_ms(hi_fn) - total_ms(lo_fn)) / (chain_hi - chain_lo),
                0.0)
        )
    slopes.sort()
    return slopes[len(slopes) // 2]


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """jax.profiler trace context (Perfetto-compatible) when log_dir set."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class MetricsWriter:
    """JSONL metrics sink (stdout by default, file if path given)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stdout
        self._owned = path is not None

    def write(self, metric: str, value: float, unit: str, **extra) -> None:
        rec = {"metric": metric, "value": value, "unit": unit, **extra}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owned:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
