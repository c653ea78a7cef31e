"""Smoke tests for the timing/metrics utilities."""

import json

import jax.numpy as jnp

from sift_parallel_optimization.utils.profiling import (
    MetricsWriter,
    chained_slope_ms,
    steady_state_ms,
)


def test_chained_slope_nonnegative_and_finite():
    x = jnp.ones((64, 64))
    ms = chained_slope_ms(
        lambda c: (c * 1.0001).sum(), x, chain_lo=5, chain_hi=20, repeats=1
    )
    assert ms >= 0.0
    assert ms < 1e3


def test_steady_state_ms_runs():
    x = jnp.ones((32, 32))
    ms = steady_state_ms(lambda: (x * 2.0).sum(), min_seconds=0.05, warmup=1)
    assert 0 < ms < 1e3


def test_metrics_writer_jsonl(tmp_path):
    p = tmp_path / "m.jsonl"
    with MetricsWriter(str(p)) as w:
        w.write("a_metric", 1.5, "ms", extra=3)
        w.write("b_metric", 2.0, "fps")
    recs = [json.loads(l) for l in p.read_text().splitlines()]
    assert recs[0] == {"metric": "a_metric", "value": 1.5, "unit": "ms",
                       "extra": 3}
    assert recs[1]["metric"] == "b_metric"
