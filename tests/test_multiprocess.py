"""Multi-host simulation: distributed solvers across real OS processes.

SURVEY.md section 4's test-strategy item (3): multi-host behavior without
a cluster, via `jax.distributed` on the CPU backend. Two suites:

* 2 processes x 4 devices — the original dense-BA psum crossing.
* 4 processes x 2 devices (round 4) — dense BA, implicit-Schur CG BA,
  and a row-sharded SIFT pyramid step, so the collective-heavy paths
  (psum, psum_scatter/all_gather inside CG, ppermute halo exchange)
  all cross REAL process boundaries, not just the virtual 8-device
  single-process mesh.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys, json
    pid = int(sys.argv[1]); port = sys.argv[2]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2, process_id=pid,
    )
    import jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from sift_parallel_optimization.models.ba import (
        BAState, Observations, rms_error,
    )
    from sift_parallel_optimization.models.geometry import project
    from sift_parallel_optimization.parallel.ba import (
        distributed_bundle_adjust, pad_observations,
    )

    K = jnp.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 32
    pts = jnp.asarray(rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32))
    pts = pts.at[:, 2].add(5.0)
    rvecs = jnp.asarray(
        [[0.0, 0.08 * i, 0.0] for i in range(n_cams)], dtype=jnp.float32
    )
    tvecs = jnp.asarray(
        [[0.4 * i, 0.0, 0.0] for i in range(n_cams)], dtype=jnp.float32
    )
    uv = jnp.concatenate(
        [project(pts, rvecs[i], tvecs[i], K)[0] for i in range(n_cams)]
    )
    obs = Observations(
        cam_idx=jnp.repeat(jnp.arange(n_cams), n_pts),
        pt_idx=jnp.tile(jnp.arange(n_pts), n_cams),
        uv=uv, valid=jnp.ones(n_cams * n_pts, bool),
    )
    noisy = BAState(
        rvecs=rvecs + 0.01, tvecs=tvecs + 0.03, points=pts + 0.05
    )
    mesh = Mesh(np.asarray(jax.devices()).reshape(8, 1), ("data", "spatial"))
    # Shard observations over the GLOBAL data axis (crosses processes).
    obs_p = pad_observations(obs, 8)
    gspec = NamedSharding(mesh, P("data"))
    gspec2 = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    obs_g = Observations(
        cam_idx=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.cam_idx)),
        pt_idx=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.pt_idx)),
        uv=jax.make_array_from_process_local_data(gspec2, np.asarray(obs_p.uv)),
        valid=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.valid)),
    )
    out = jax.jit(
        lambda s, o: distributed_bundle_adjust(s, o, K, mesh, n_iters=6,
                                               damping=1e-4)
    )(noisy, obs_g)
    err = float(rms_error(
        BAState(*[jnp.asarray(np.asarray(x)) for x in out]), obs, K
    ))
    print("RESULT " + json.dumps({"pid": pid, "rms": err}), flush=True)
    """
)


_WORKER4 = textwrap.dedent(
    """
    import os, sys, json
    pid = int(sys.argv[1]); port = sys.argv[2]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=4, process_id=pid,
    )
    import jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from sift_parallel_optimization.models.ba import (
        BAState, Observations, rms_error,
    )
    from sift_parallel_optimization.models.geometry import project
    from sift_parallel_optimization.parallel.ba import (
        distributed_bundle_adjust, pad_observations,
    )

    K = jnp.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 32
    pts = jnp.asarray(rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32))
    pts = pts.at[:, 2].add(5.0)
    rvecs = jnp.asarray(
        [[0.0, 0.08 * i, 0.0] for i in range(n_cams)], dtype=jnp.float32
    )
    tvecs = jnp.asarray(
        [[0.4 * i, 0.0, 0.0] for i in range(n_cams)], dtype=jnp.float32
    )
    uv = jnp.concatenate(
        [project(pts, rvecs[i], tvecs[i], K)[0] for i in range(n_cams)]
    )
    obs = Observations(
        cam_idx=jnp.repeat(jnp.arange(n_cams), n_pts),
        pt_idx=jnp.tile(jnp.arange(n_pts), n_cams),
        uv=uv, valid=jnp.ones(n_cams * n_pts, bool),
    )
    noisy = BAState(
        rvecs=rvecs + 0.01, tvecs=tvecs + 0.03, points=pts + 0.05
    )
    mesh = Mesh(np.asarray(jax.devices()).reshape(8, 1), ("data", "spatial"))
    obs_p = pad_observations(obs, 8)
    gspec = NamedSharding(mesh, P("data"))
    gspec2 = NamedSharding(mesh, P("data", None))
    obs_g = Observations(
        cam_idx=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.cam_idx)),
        pt_idx=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.pt_idx)),
        uv=jax.make_array_from_process_local_data(gspec2, np.asarray(obs_p.uv)),
        valid=jax.make_array_from_process_local_data(gspec, np.asarray(obs_p.valid)),
    )
    res = {"pid": pid}
    for solver in ("dense", "cg"):
        out = jax.jit(
            lambda s, o: distributed_bundle_adjust(
                s, o, K, mesh, n_iters=6, damping=1e-4, solver=solver
            )
        )(noisy, obs_g)
        res["rms_" + solver] = float(rms_error(
            BAState(*[jnp.asarray(np.asarray(x)) for x in out]), obs, K
        ))

    # Row-sharded SIFT pyramid: ppermute halo exchange across the 4
    # process boundaries; compare against the replicated single-device
    # path inside one program (the diff is a replicated scalar).
    from sift_parallel_optimization.config import (
        PyramidConfig, ScaleSpaceMode,
    )
    from sift_parallel_optimization.core.pyramid_ref import (
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.parallel.scale_space import (
        sharded_sift_gaussian_pyramid,
    )

    cfg = PyramidConfig(length=64, S=2, mode=ScaleSpaceMode.SIFT,
                        max_octaves=2)
    img_np = np.random.default_rng(1).random((64, 64)).astype(np.float32)
    img = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("spatial", None)), img_np
    )

    @jax.jit
    def pyr_diff(x):
        got = sharded_sift_gaussian_pyramid(x, cfg, mesh)
        want = sift_gaussian_pyramid(x, cfg)
        return sum(
            jnp.abs(g - w).max() for g, w in zip(got, want)
        )

    res["pyr_maxdiff"] = float(pyr_diff(img))
    print("RESULT " + json.dumps(res), flush=True)
    """
)


def _run_workers(worker_src: str, n_procs: int, timeout: int = 300):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker_src, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=".",
        )
        for pid in range(n_procs)
    ]
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                rec = json.loads(line[7:])
                results[rec.pop("pid")] = rec
    assert sorted(results) == list(range(n_procs))
    return results


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    results = {
        pid: rec["rms"]
        for pid, rec in _run_workers(_WORKER, 2, timeout=240).items()
    }
    # Both processes hold the same replicated result, converged.
    assert abs(results[0] - results[1]) < 1e-6
    assert results[0] < 0.05, f"distributed BA did not converge: {results}"


@pytest.mark.slow
def test_four_process_ba_cg_and_sharded_pyramid(tmp_path):
    """world_size=4: dense BA, CG BA, and the halo-exchange pyramid all
    cross real process boundaries and agree with single-process runs."""
    results = _run_workers(_WORKER4, 4, timeout=300)
    for metric in ("rms_dense", "rms_cg"):
        vals = [results[p][metric] for p in range(4)]
        assert max(vals) - min(vals) < 1e-6, (metric, vals)
        assert vals[0] < 0.05, (metric, vals)
    for p in range(4):
        assert results[p]["pyr_maxdiff"] < 1e-5, results
