"""Mesh-size scaling sweep — the reference's Timing_ThreadCount, generalized.

The reference swept pthread THREAD_COUNT = 1..7 and printed seconds-per-
pass CSV (GaussDePyramid-pThread.h:310-326). Here the knob is the mesh:
the same sharded program is timed at mesh sizes 1..N and scaling
efficiency t1 / (n * tn) is reported. Each mesh size runs in a fresh
subprocess because the virtual device count
(``--xla_force_host_platform_device_count``) is fixed at backend init.

The children stay pinned to the CPU backend: one JAX process per card,
so a sweep of processes must not open the accelerator. The sweep is a
regression net for the sharded program, not a device measurement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from sift_parallel_optimization.utils.profiling import MetricsWriter

_CHILD = textwrap.dedent(
    """
    import os, sys, json, time
    n = int(sys.argv[1]); size = int(sys.argv[2]); batch = int(sys.argv[3])
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp, numpy as np
    from sift_parallel_optimization.models.frontend import sift_config
    from sift_parallel_optimization.parallel.frontend import (
        batched_extract_features,
    )
    from sift_parallel_optimization.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=n, n_spatial=1)
    cfg = sift_config(size, max_octaves=4)
    frames = jnp.asarray(
        np.random.default_rng(0).random((batch, size, size), np.float32)
    )
    fn = jax.jit(
        lambda x: batched_extract_features(x, cfg, 128, mesh).descriptors.sum()
    )
    float(fn(frames))  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(fn(frames))
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({"n": n, "total_ms": best * 1e3}))
    """
)


def bench_scaling(
    writer: MetricsWriter,
    size: int = 256,
    batch: int = 8,
    device_counts=(1, 2, 4, 8),
    **kw,
) -> None:
    """DP frontend throughput vs virtual mesh size (batch fixed).

    Every row carries the ANALYTIC per-device interconnect bytes of the
    sharded step (bench/roofline.py). CPU-mesh wall times validate the
    efficiency shape only (XLA's CPU backend multithreads within one
    device); the bytes are exact for any device.
    """
    from sift_parallel_optimization.bench.roofline import (
        dp_frontend_comm_bytes,
        sharded_pyramid_comm_bytes,
    )
    from sift_parallel_optimization.models.frontend import sift_config

    results = {}
    for n in device_counts:
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, str(n), str(size), str(batch)],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        line = out.stdout.strip().splitlines()[-1] if out.stdout else ""
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            writer.write(
                f"scaling_frontend_{size}_n{n}", -1.0, "ms",
                error=out.stderr[-300:],
            )
            continue
        results[n] = rec["total_ms"]
        eff = (
            results[min(results)] / (n / min(results.keys()) * rec["total_ms"])
            if results else 1.0
        )
        writer.write(
            f"scaling_frontend_{size}_n{n}",
            round(rec["total_ms"] / batch, 3), "ms/frame",
            mesh_devices=n, batch=batch,
            efficiency_vs_smallest=round(eff, 3),
            comm_bytes_per_step=dp_frontend_comm_bytes(),
            # These times are subprocess wall-clock on a VIRTUAL CPU mesh
            # (XLA's CPU backend multithreads within one "device"): a
            # regression net only, never a device metric.
            backend="cpu-virtual-mesh-wallclock",
        )

    # Row-sharded SIFT pyramid: analytic halo traffic per frame at each
    # mesh size (one ppermute per sharded octave; tail runs unsharded).
    cfg = sift_config(512)
    for n in device_counts:
        writer.write(
            f"scaling_pyramid_comm_bytes_512_n{n}",
            sharded_pyramid_comm_bytes(cfg, n), "bytes/frame/device",
            mesh_devices=n,
        )
