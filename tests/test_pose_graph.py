"""Pose-graph optimization tests: loop-closure style convergence."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.geometry import rodrigues, rotation_log
from sift_parallel_optimization.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    optimize_pose_graph,
    pgo_rms,
    relative_pose,
)


def _circle_poses(n, radius=2.0):
    """Ground-truth poses on a circle with tangent heading."""
    rv, tv = [], []
    for k in range(n):
        ang = 2 * np.pi * k / n
        rv.append([0.0, ang, 0.0])
        R = np.asarray(rodrigues(jnp.asarray(rv[-1], dtype=jnp.float32)))
        c = np.array([radius * np.cos(ang), 0.0, radius * np.sin(ang)],
                     np.float32)
        tv.append(-R @ c)  # t = -R c
    return (
        jnp.asarray(rv, dtype=jnp.float32),
        jnp.asarray(np.stack(tv), dtype=jnp.float32),
    )


def _edges_from_gt(rvecs, tvecs, pairs, noise=0.0, rng=None):
    i_l, j_l, rr, rt, w = [], [], [], [], []
    for (i, j) in pairs:
        r_rel, t_rel = relative_pose(rvecs[i], tvecs[i], rvecs[j], tvecs[j])
        r_rel = np.asarray(r_rel)
        t_rel = np.asarray(t_rel)
        if noise and rng is not None:
            r_rel = r_rel + rng.normal(size=3).astype(np.float32) * noise
            t_rel = t_rel + rng.normal(size=3).astype(np.float32) * noise
        i_l.append(i); j_l.append(j); rr.append(r_rel); rt.append(t_rel)
        w.append(1.0)
    return PoseGraphEdges(
        i=jnp.asarray(i_l, jnp.int32),
        j=jnp.asarray(j_l, jnp.int32),
        rel_rvec=jnp.asarray(np.stack(rr), dtype=jnp.float32),
        rel_tvec=jnp.asarray(np.stack(rt), dtype=jnp.float32),
        weight=jnp.asarray(w, dtype=jnp.float32),
    )


def test_relative_pose_roundtrip(rng):
    r1 = jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.4)
    t1 = jnp.asarray(rng.normal(size=3).astype(np.float32))
    r2 = jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.4)
    t2 = jnp.asarray(rng.normal(size=3).astype(np.float32))
    rr, rt = relative_pose(r1, t1, r2, t2)
    # Compose: T_j = T_rel o T_i.
    Rr = rodrigues(rr)
    R1 = rodrigues(r1)
    np.testing.assert_allclose(
        np.asarray(Rr @ R1), np.asarray(rodrigues(r2)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(Rr @ t1 + rt), np.asarray(t2), atol=1e-5
    )


def test_pgo_corrects_drift(rng):
    """Odometry chain with drift + loop closure -> GN pulls poses back."""
    n = 12
    rv_gt, tv_gt = _circle_poses(n)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0)]  # loop closure
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)

    # Drifted initialization: accumulate noisy odometry from node 0.
    rv = [np.asarray(rv_gt[0])]
    tv = [np.asarray(tv_gt[0])]
    for k in range(1, n):
        rv.append(np.asarray(rv_gt[k]) + rng.normal(size=3).astype(np.float32) * 0.05)
        tv.append(np.asarray(tv_gt[k]) + rng.normal(size=3).astype(np.float32) * 0.15)
    init = Poses(
        rvecs=jnp.asarray(np.stack(rv), dtype=jnp.float32),
        tvecs=jnp.asarray(np.stack(tv), dtype=jnp.float32),
    )
    e0 = float(pgo_rms(init, edges))
    out = jax.jit(
        lambda p: optimize_pose_graph(p, edges, n_iters=25, damping=1e-4)
    )(init)
    e1 = float(pgo_rms(out, edges))
    assert e0 > 0.05
    assert e1 < 1e-3, f"PGO did not converge: {e0} -> {e1}"
    # Node 0 is the gauge anchor: unchanged.
    np.testing.assert_allclose(
        np.asarray(out.rvecs[0]), np.asarray(init.rvecs[0]), atol=1e-6
    )
    # Recovered poses close to ground truth (consistent edges, fixed gauge).
    np.testing.assert_allclose(
        np.asarray(out.tvecs), np.asarray(tv_gt), atol=5e-2
    )


def test_pgo_weights_zero_edges_ignored(rng):
    n = 4
    rv_gt, tv_gt = _circle_poses(n)
    pairs = [(0, 1), (1, 2), (2, 3)]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    # Append a wildly wrong edge with zero weight: must not affect result.
    bad = PoseGraphEdges(
        i=jnp.concatenate([edges.i, jnp.asarray([0], jnp.int32)]),
        j=jnp.concatenate([edges.j, jnp.asarray([3], jnp.int32)]),
        rel_rvec=jnp.concatenate([edges.rel_rvec, jnp.asarray([[1.0, 2, 3]])]),
        rel_tvec=jnp.concatenate([edges.rel_tvec, jnp.asarray([[9.0, 9, 9]])]),
        weight=jnp.concatenate([edges.weight, jnp.asarray([0.0])]),
    )
    init = Poses(
        rvecs=rv_gt + 0.02, tvecs=tv_gt + 0.05
    )
    a = optimize_pose_graph(init, edges, n_iters=10, damping=1e-4)
    b = optimize_pose_graph(init, bad, n_iters=10, damping=1e-4)
    np.testing.assert_allclose(
        np.asarray(a.tvecs), np.asarray(b.tvecs), atol=1e-5
    )


def test_cg_solver_matches_dense(rng):
    """The matrix-free CG path converges to the dense solver's fixed
    point on a loop-closure graph."""
    n = 16
    rv_gt, tv_gt = _circle_poses(n)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (0, 8), (3, 12)]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    init = Poses(rvecs=rv_gt + 0.03, tvecs=tv_gt + 0.1)
    dense = optimize_pose_graph(
        init, edges, n_iters=25, damping=1e-4, solver="dense"
    )
    cg = jax.jit(
        lambda p: optimize_pose_graph(
            p, edges, n_iters=25, damping=1e-4, solver="cg"
        )
    )(init)
    np.testing.assert_allclose(
        np.asarray(cg.tvecs), np.asarray(dense.tvecs), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(cg.rvecs), np.asarray(dense.rvecs), atol=1e-3
    )
    assert float(pgo_rms(cg, edges)) < 1e-3


def test_thousand_node_graph_converges(rng):
    """A 1,000-node chain + loop closures (the product of long-sequence
    odometry) — far out of the dense (N, N, 6, 6) solver's reach; the CG
    path must converge. 'auto' resolves to cg above PGO_DENSE_LIMIT."""
    from sift_parallel_optimization.models.pose_graph import (
        resolve_pgo_solver,
    )

    n = 1000
    assert resolve_pgo_solver(n, "auto") == "cg"
    assert resolve_pgo_solver(50, "auto") == "dense"
    rv_gt, tv_gt = _circle_poses(n, radius=20.0)
    pairs = [(k, k + 1) for k in range(n - 1)] + [
        (n - 1, 0), (0, n // 2), (n // 4, 3 * n // 4),
        (100, 900), (250, 650),
    ]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    r2 = np.random.default_rng(1)
    init = Poses(
        rvecs=rv_gt
        + jnp.asarray(0.01 * r2.normal(size=(n, 3)).astype(np.float32)),
        tvecs=tv_gt
        + jnp.asarray(0.05 * r2.normal(size=(n, 3)).astype(np.float32)),
    )
    e0 = float(pgo_rms(init, edges))
    out = jax.jit(
        lambda p: optimize_pose_graph(
            p, edges, n_iters=10, damping=1e-4, solver="cg", cg_iters=200
        )
    )(init)
    e1 = float(pgo_rms(out, edges))
    assert e0 > 0.01
    assert e1 < 0.05 * e0, f"large PGO did not converge: {e0} -> {e1}"


def test_distributed_pgo_matches_single(rng):
    from sift_parallel_optimization.parallel.mesh import make_mesh
    from sift_parallel_optimization.parallel.pose_graph import (
        distributed_pgo,
    )

    n = 10
    rv_gt, tv_gt = _circle_poses(n)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (0, 5), (2, 7)]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    init = Poses(rvecs=rv_gt + 0.03, tvecs=tv_gt + 0.1)
    single = optimize_pose_graph(init, edges, n_iters=25, damping=1e-4)
    mesh = make_mesh(n_data=8, n_spatial=1)
    dist = jax.jit(
        lambda p: distributed_pgo(p, edges, mesh, n_iters=25, damping=1e-4)
    )(init)
    np.testing.assert_allclose(
        np.asarray(dist.tvecs), np.asarray(single.tvecs), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(dist.rvecs), np.asarray(single.rvecs), atol=1e-4
    )
    assert float(pgo_rms(dist, edges)) < 1e-3


def test_chain_solver_matches_dense(rng):
    """The exact chain+Woodbury path (round 5) reaches the dense fixed
    point on a chain + loop-closure graph, loop edges included."""
    n = 16
    rv_gt, tv_gt = _circle_poses(n)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (0, 8), (3, 12)]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    init = Poses(rvecs=rv_gt + 0.03, tvecs=tv_gt + 0.1)
    dense = optimize_pose_graph(
        init, edges, n_iters=25, damping=1e-4, solver="dense"
    )
    chain = jax.jit(
        lambda p: optimize_pose_graph(
            p, edges, n_iters=25, damping=1e-4, solver="chain",
            offchain_cap=4,
        )
    )(init)
    np.testing.assert_allclose(
        np.asarray(chain.tvecs), np.asarray(dense.tvecs), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(chain.rvecs), np.asarray(dense.rvecs), atol=1e-3
    )
    assert float(pgo_rms(chain, edges)) < 1e-3


def test_thousand_node_chain_solver(rng):
    """1,000-node chain + loops through the exact O(N) chain solver:
    same graph as the CG test, length-scaled damping, and 'auto' takes
    the chain path when the caller vouches an off-chain cap."""
    from sift_parallel_optimization.models.pose_graph import (
        chain_damping,
        resolve_pgo_solver,
    )

    n = 1000
    assert resolve_pgo_solver(n, "auto", offchain_cap=8) == "chain"
    rv_gt, tv_gt = _circle_poses(n, radius=20.0)
    pairs = [(k, k + 1) for k in range(n - 1)] + [
        (n - 1, 0), (0, n // 2), (n // 4, 3 * n // 4),
        (100, 900), (250, 650),
    ]
    edges = _edges_from_gt(rv_gt, tv_gt, pairs)
    r2 = np.random.default_rng(1)
    init = Poses(
        rvecs=rv_gt
        + jnp.asarray(0.01 * r2.normal(size=(n, 3)).astype(np.float32)),
        tvecs=tv_gt
        + jnp.asarray(0.05 * r2.normal(size=(n, 3)).astype(np.float32)),
    )
    e0 = float(pgo_rms(init, edges))
    out = jax.jit(
        lambda p: optimize_pose_graph(
            p, edges, n_iters=10, damping=chain_damping(n, 1e-4),
            offchain_cap=8,
        )
    )(init)
    e1 = float(pgo_rms(out, edges))
    assert e0 > 0.01
    assert e1 < 0.02 * e0, f"chain PGO did not converge: {e0} -> {e1}"
