"""Sim(3) pose-graph optimization: loop closure with per-node SCALE.

Monocular odometry drifts in scale, and an SE(3) pose graph
(models/pose_graph.py) structurally cannot absorb it: every chain edge's
translation LENGTH is fixed by its measurement, so absolute loop
constraints fight the chain instead of shrinking it. Round-3 measurement
(40-frame two-cycle revisit, 256^2, chip): the first cycle's apex keeps
a smooth ~40%-of-span scale bump that SE(3) PGO reduces only from 15.7%
to ~14% ATE regardless of loop weight. The classic fix (ORB-SLAM's
essential-graph optimization, Strasdat et al. "Scale Drift-Aware Large
Scale Monocular SLAM") is a pose graph over Sim(3): each node carries
(R_i, t_i, log s_i), chain edges measure relative similarities with
s_meas = 1, and the optimizer distributes the loop's scale discrepancy
along the chain.

Convention: node i maps world -> cam by x = s_i * (R_i X) + t_i. The
relative similarity of edge (i, j) is

    R_ij = R_j R_i^T,  s_ij = s_j / s_i,
    t_ij = t_j - s_ij * R_ij t_i,

so a measured SE(3) odometry edge is (rel_rvec, rel_tvec, rel_log_s=0).

Measurement model (the round-4 fix for the inert scale channel): the
edge constrains S_ij == S_meas with

    S_meas = (exp(rel_log_s), R(rel_rvec), exp(rel_log_s) * rel_tvec)

i.e. ``rel_tvec`` is expressed in node i's scale units and the measured
scale ratio maps it into node j's units. Chain edges measured from the
drifted estimates carry rel_log_s = 0 and are untouched; a LOOP edge
built from a metric archive-PnP pose carries the measured accumulated
scale drift (log of the drifted-estimate/metric translation-norm ratio,
:func:`measured_rel_log_s`), which makes the desired solution — rigid
poses at ground truth, t_i = s_i * t_i^true, s_i = the drift ramp —
zero the loop's rot/trans/scale rows exactly, leaving only the soft
chain scale-prior rows (log per-edge drift each) to distribute the
discrepancy along the chain (Strasdat et al. scale-drift-aware PGO /
ORB-SLAM essential graph, where computeSim3 likewise hands the loop
edge a MEASURED scale). Without the measured loop scale the scale rows
form a consistent all-zero system and the channel is inert — the
round-3 defect.
Same static-shape form as models/pose_graph.py: fixed-capacity masked edge
list, autodiff per-edge Jacobians (7-dim blocks), segment-sum normal
equations, damped GN in lax.fori_loop, node-0 gauge fixed (pose AND
scale — monocular gauge freedom is similarity, not rigid). Two solvers,
auto-dispatched by node count exactly like optimize_pose_graph: the
dense (7N, 7N) solve (bit-stable, best at small N) and the matrix-free
block-Jacobi-preconditioned CG (O(E) memory — no (N, N, 7, 7) cross
block anywhere), so thousand-frame trajectories stay O(n) on the
DEFAULT loop-closure path (round-5: the round-4 version materialized
the dense cross tensor unconditionally, ~196 MB at n=1000).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from sift_parallel_optimization.models.geometry import (
    rodrigues,
    rotation_log,
)


class Sim3Poses(NamedTuple):
    rvecs: jax.Array   # (N, 3)
    tvecs: jax.Array   # (N, 3)
    log_s: jax.Array   # (N,)


class Sim3Edges(NamedTuple):
    """Fixed-capacity relative-similarity constraint list.

    ``metric`` marks edges whose rel_tvec is a METRIC measurement (an
    archive-PnP loop constraint): their translation row compares the
    DE-SCALED relative translation t_ij * exp(-(s_j - s_i)) against the
    measurement, so the optimizer itself determines the accumulated
    scale at the loop endpoint — no external scale estimator involved —
    and their scale-prior row is dropped. Non-metric (odometry chain)
    edges, whose rel_tvec is expressed in the drifted estimate's own
    units, keep the round-3 rows: raw translation difference (mapped
    through exp(rel_log_s)) plus the soft scale prior (s_j - s_i) -
    rel_log_s that distributes loop scale discrepancy along the chain.
    """

    i: jax.Array          # (E,) i32
    j: jax.Array          # (E,) i32
    rel_rvec: jax.Array   # (E, 3)
    rel_tvec: jax.Array   # (E, 3)
    rel_log_s: jax.Array  # (E,) measured log(s_j / s_i) (0 for odometry)
    weight: jax.Array     # (E,) f32 (0 = invalid slot)
    metric: jax.Array     # (E,) f32 1.0 = metric loop edge, 0.0 = chain


def se3_to_sim3_poses(rvecs: jax.Array, tvecs: jax.Array) -> Sim3Poses:
    return Sim3Poses(
        rvecs=rvecs, tvecs=tvecs,
        log_s=jnp.zeros(rvecs.shape[0], jnp.float32),
    )


def sim3_to_se3_poses(p: Sim3Poses) -> tuple[jax.Array, jax.Array]:
    """Back to world->cam SE(3): x = s(RX) + t = s(RX + t/s) — the
    rigid pose is (R, t/s); the per-node scale has been absorbed into
    the (now metrically consistent) trajectory."""
    return p.rvecs, p.tvecs / jnp.exp(p.log_s)[:, None]


def _edge_residual(ri, ti, si, rj, tj, sj, rel_r, rel_t, rel_ls, metric):
    """(7,) residual; rows depend on the edge's measurement frame.

    Chain (metric=0):  [log(R_m^T R_ij); t_ij - e^ls t_m; (sj-si) - ls]
    Metric (metric=1): [log(R_m^T R_ij); e^-(sj-si) t_ij - t_m; 0]

    The metric translation row compares the DE-SCALED relative
    translation against the measurement, so the scale-absorbing
    solution (t_i = s_i t_i_true, s_i = the drift ramp) zeroes it
    exactly and the loop endpoint's scale is determined by the
    optimization, not by an external (path-averaged, biased) estimate.
    See the class docstring of :class:`Sim3Edges`.
    """
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.T
    s_rel = jnp.exp(sj - si)
    t_rel = tj - s_rel * (R_rel @ ti)
    e_rot = rotation_log(rodrigues(rel_r).T @ R_rel)
    e_t_chain = t_rel - jnp.exp(rel_ls) * rel_t
    e_t_metric = t_rel / s_rel - rel_t
    e_t = (1.0 - metric) * e_t_chain + metric * e_t_metric
    e_s = (1.0 - metric) * ((sj - si) - rel_ls)
    return jnp.concatenate([e_rot, e_t, e_s[None]])


def measured_rel_log_s(
    rvecs: jax.Array,
    tvecs: jax.Array,
    i: jax.Array,
    j: jax.Array,
    rel_tvec: jax.Array,
    max_abs: float = 2.0,
    eps: float = 1e-6,
) -> jax.Array:
    """Per-edge measured scale ratio log(s_j / s_i) from translation norms.

    The current (drifted) estimates' implied relative translation for
    edge (i, j) has length scaled by the accumulated drift s_j; a metric
    measurement (archive PnP) has the true length. Their log-ratio is
    the edge's measured rel_log_s. For chain edges, whose rel_tvec was
    measured FROM the estimates, the ratio is exactly 1 -> 0, so this is
    safe to apply uniformly to every edge of a pose graph. Guarded: near
    -zero norms (pure rotation / padding slots) return 0, and the result
    is clamped to +-``max_abs`` (a 7.4x scale drift) so one degenerate
    PnP translation cannot inject an absurd constraint.
    """
    from sift_parallel_optimization.models.pose_graph import (
        relative_pose,
    )

    rr, rt = jax.vmap(relative_pose)(
        rvecs[i], tvecs[i], rvecs[j], tvecs[j]
    )
    del rr
    n_est = jnp.linalg.norm(rt, axis=-1)
    n_meas = jnp.linalg.norm(rel_tvec, axis=-1)
    ok = (n_est > eps) & (n_meas > eps)
    ls = jnp.log(jnp.maximum(n_est, eps) / jnp.maximum(n_meas, eps))
    return jnp.where(ok, jnp.clip(ls, -max_abs, max_abs), 0.0)


def sim3_residuals(poses: Sim3Poses, edges: Sim3Edges) -> jax.Array:
    with jax.default_matmul_precision("highest"):
        r = jax.vmap(_edge_residual)(
            poses.rvecs[edges.i], poses.tvecs[edges.i],
            poses.log_s[edges.i],
            poses.rvecs[edges.j], poses.tvecs[edges.j],
            poses.log_s[edges.j],
            edges.rel_rvec, edges.rel_tvec, edges.rel_log_s,
            edges.metric,
        )
    return r * jnp.sqrt(jnp.maximum(edges.weight, 0.0))[:, None]


def sim3_rms(poses: Sim3Poses, edges: Sim3Edges) -> jax.Array:
    r = sim3_residuals(poses, edges)
    n = jnp.maximum((edges.weight > 0).sum(), 1)
    return jnp.sqrt(jnp.sum(r * r) / n)


def _f32_precision(fn):
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def _edge_jacobians(poses: Sim3Poses, edges: Sim3Edges):
    """ji/jj (E, 7, 7) weighted, node-0 gauge-masked; r (E, 7)."""

    def one(ri, ti, si, rj, tj, sj, rel_r, rel_t, rel_ls, metric, w):
        def f(theta):
            return _edge_residual(
                theta[:3], theta[3:6], theta[6],
                theta[7:10], theta[10:13], theta[13],
                rel_r, rel_t, rel_ls, metric,
            ) * jnp.sqrt(jnp.maximum(w, 0.0))

        theta = jnp.concatenate(
            [ri, ti, si[None], rj, tj, sj[None]]
        )
        jac = jax.jacfwd(f)(theta)            # (7, 14)
        return jac[:, :7], jac[:, 7:], f(theta)

    ji, jj, r = jax.vmap(one)(
        poses.rvecs[edges.i], poses.tvecs[edges.i], poses.log_s[edges.i],
        poses.rvecs[edges.j], poses.tvecs[edges.j], poses.log_s[edges.j],
        edges.rel_rvec, edges.rel_tvec, edges.rel_log_s, edges.metric,
        edges.weight,
    )
    keep_i = (edges.i != 0)[:, None, None].astype(ji.dtype)
    keep_j = (edges.j != 0)[:, None, None].astype(jj.dtype)
    return ji * keep_i, jj * keep_j, r


@_f32_precision
def _sim3_dense_delta(
    poses: Sim3Poses, edges: Sim3Edges, damping: float
) -> jax.Array:
    """Dense (7N, 7N) solve -> (N, 7) update (node-0 gauge)."""
    N = poses.rvecs.shape[0]
    ji, jj, r = _edge_jacobians(poses, edges)

    hii = jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", ji, ji), edges.i, N
    )
    hjj = jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", jj, jj), edges.j, N
    )
    b = -(
        jax.ops.segment_sum(jnp.einsum("eab,ea->eb", ji, r), edges.i, N)
        + jax.ops.segment_sum(jnp.einsum("eab,ea->eb", jj, r), edges.j, N)
    )
    w_ij = jnp.einsum("eab,eac->ebc", ji, jj)
    cross = jax.ops.segment_sum(
        w_ij.reshape(-1, 49), edges.i * N + edges.j, N * N
    ).reshape(N, N, 7, 7)

    h = cross + cross.transpose(1, 0, 3, 2)
    h = h.at[jnp.arange(N), jnp.arange(N)].add(hii + hjj)
    hd = h[jnp.arange(N), jnp.arange(N)]
    d = jnp.diagonal(hd, axis1=-2, axis2=-1)
    h = h.at[jnp.arange(N), jnp.arange(N)].add(
        (damping * d + 1e-6)[..., None] * jnp.eye(7)
    )
    hd_dense = h.transpose(0, 2, 1, 3).reshape(7 * N, 7 * N)
    m0 = jnp.concatenate([jnp.zeros(7), jnp.ones(7 * (N - 1))])
    hd_dense = hd_dense * m0[:, None] * m0[None, :] + jnp.diag(1.0 - m0)
    b = b.at[0].set(0.0)
    return jnp.linalg.solve(hd_dense, b.reshape(-1)).reshape(N, 7)


# ---------------------------------------------------------------------------
# Implicit CG path (no dense (N, N, 7, 7) cross block — O(E) memory)
# ---------------------------------------------------------------------------


class ImplicitSim3(NamedTuple):
    """Per-GN-step linearization for the matrix-free Sim(3) solve.

    The 7-DOF port of models/pose_graph.ImplicitPgo: H = J^T J is only
    ever APPLIED through per-edge products, node assignment is carried
    as one-hot (E, N) tensors so the matvec's gather/scatter are dense
    matmuls (see models/ba.py), and the block-Jacobi preconditioner is
    the damped
    per-node (7, 7) diagonal block.
    """

    ji: jax.Array         # (E, 7, 7) weighted gauge-masked d r / d pose_i
    jj: jax.Array         # (E, 7, 7)
    oh_i: jax.Array       # (E, N) one-hot source node
    oh_j: jax.Array       # (E, N) one-hot target node
    damp_vec: jax.Array   # (N, 7) Marquardt damping diagonal addition
    minv: jax.Array       # (N, 7, 7) block-Jacobi preconditioner
    b: jax.Array          # (N, 7) right-hand side (node 0 zeroed)


@_f32_precision
def assemble_sim3_implicit(
    poses: Sim3Poses, edges: Sim3Edges, damping: float = 1e-3
) -> ImplicitSim3:
    """Linearize for the matrix-free CG solve (no N x N block anywhere)."""
    N = poses.rvecs.shape[0]
    ji, jj, r = _edge_jacobians(poses, edges)
    oh_i = jax.nn.one_hot(edges.i, N, dtype=jnp.float32)
    oh_j = jax.nn.one_hot(edges.j, N, dtype=jnp.float32)
    hii = jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", ji, ji), edges.i, N
    )
    hjj = jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", jj, jj), edges.j, N
    )
    hdiag = hii + hjj
    b = -(
        jax.ops.segment_sum(jnp.einsum("eab,ea->eb", ji, r), edges.i, N)
        + jax.ops.segment_sum(jnp.einsum("eab,ea->eb", jj, r), edges.j, N)
    )
    b = b.at[0].set(0.0)
    d = jnp.diagonal(hdiag, axis1=-2, axis2=-1)
    damp_vec = damping * d + 1e-6
    prec = hdiag + damp_vec[..., None] * jnp.eye(7)
    prec = prec.at[0].set(jnp.eye(7))  # gauge: node-0 block is identity
    return ImplicitSim3(
        ji=ji, jj=jj, oh_i=oh_i, oh_j=oh_j,
        damp_vec=damp_vec, minv=jnp.linalg.inv(prec), b=b,
    )


def sim3_matvec(blk: ImplicitSim3, x: jax.Array) -> jax.Array:
    """(damped H) x through per-edge products: (N, 7) -> (N, 7)."""
    xi = jnp.einsum("en,nk->ek", blk.oh_i, x)           # (E, 7)
    xj = jnp.einsum("en,nk->ek", blk.oh_j, x)
    t = (
        jnp.einsum("eab,eb->ea", blk.ji, xi)
        + jnp.einsum("eab,eb->ea", blk.jj, xj)
    )                                                    # (E, 7) = J x
    out = (
        jnp.einsum("en,eab,ea->nb", blk.oh_i, blk.ji, t)
        + jnp.einsum("en,eab,ea->nb", blk.oh_j, blk.jj, t)
    )
    out = out + blk.damp_vec * x
    # Node-0 gauge block is the identity (its Jacobians are masked, so
    # the edge products and x_0 columns are already zero there).
    return out.at[0].set(x[0])


@_f32_precision
def solve_sim3_cg(
    blk: ImplicitSim3, cg_iters: int = 100, cg_tol: float = 1e-8
) -> jax.Array:
    """Block-Jacobi preconditioned CG -> (N, 7) update (matrix-free).

    Same adaptive-stop structure as models/pose_graph.solve_pgo_cg: run
    to ``cg_tol`` on the preconditioned residual or ``cg_iters``,
    whichever first.
    """

    def prec(v):
        return jnp.einsum("nkl,nl->nk", blk.minv, v)

    def dot(a, bb):
        return jnp.sum(a * bb)

    b = blk.b
    x = jnp.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = dot(r, z)
    thresh = cg_tol * rz

    def cond(carry):
        i, _x, _r, _p, rz = carry
        return (i < cg_iters) & (rz > thresh)

    def body(carry):
        i, x, r, p, rz = carry
        ap = sim3_matvec(blk, p)
        pap = dot(p, ap)
        alpha = jnp.where(pap > 1e-20, rz / jnp.maximum(pap, 1e-20), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 1e-20, rz_new / jnp.maximum(rz, 1e-20), 0.0)
        p = z + beta * p
        return i + 1, x, r, p, rz_new

    _, x, _, _, _ = lax.while_loop(cond, body, (0, x, r, p, rz))
    return x


# ---------------------------------------------------------------------------
# Chain solver: exact O(N) block-tridiagonal + Woodbury loop correction
# ---------------------------------------------------------------------------
#
# The graphs the default loop-closure corrector actually sees are an
# odometry CHAIN (edge (i, i+1) for every i) plus a handful of loop
# edges. On such graphs plain preconditioned CG stalls: the loop
# discrepancy must diffuse along a 1-D chain whose Laplacian condition
# grows as N^2, so the global scale-ramp mode converges at ~N iterations
# regardless of the block-Jacobi preconditioner (measured round 5:
# 30 GN x 200 CG iterations left log_s[-1] at 0.30 of the true 0.41 on
# the 1,000-node ramp). The standard SLAM exploitation of this sparsity
# is exact: the chain part of H is block-tridiagonal, solvable in O(N)
# by block-Thomas elimination (two lax.scan sweeps of (7, 7) solves),
# and the L loop edges are a rank-7L correction handled by the Woodbury
# identity:
#
#   H = T + U^T U,   H^-1 b = T^-1 b - T^-1 U^T (I + U T^-1 U^T)^-1 U T^-1 b
#
# with U the (7L, 7N) stacked loop-edge Jacobian rows. One factorization
# per GN step solves 1 + 7L right-hand sides in the same two sweeps; the
# (7L, 7L) capacitance solve is dense but tiny. Exact (same fixed point
# as the dense solver, tested), O(N + L^2) memory, O(N L) time.


@_f32_precision
def assemble_sim3_chain(
    poses: Sim3Poses,
    edges: Sim3Edges,
    damping: float = 1e-3,
    offchain_cap: int = 32,
):
    """Split the edge list into tridiagonal chain part + low-rank rest.

    Chain edges are detected structurally (j == i + 1, weight > 0); ALL
    other valid edges are compacted into ``offchain_cap`` low-rank slots.
    The caller must guarantee the true off-chain edge count fits the cap
    (a traced count cannot gate inside jit) — ``correct_trajectory``
    passes the host-known accepted-loop count. (Shared block-size
    -generic machinery lives in pose_graph.chain_edge_split — the SE(3)
    solver is the 6-DOF instantiation.)
    """
    from sift_parallel_optimization.models.pose_graph import (
        chain_edge_split,
    )

    N = poses.rvecs.shape[0]
    ji, jj, r = _edge_jacobians(poses, edges)
    return chain_edge_split(ji, jj, r, edges, N, damping, offchain_cap)


@_f32_precision
def solve_sim3_chain(blk) -> jax.Array:
    """Exact (N, 7) update via block-Thomas + Woodbury loop correction
    (pose_graph.chain_woodbury_delta with 7-DOF blocks)."""
    from sift_parallel_optimization.models.pose_graph import (
        chain_woodbury_delta,
    )

    return chain_woodbury_delta(*blk)


# N above which "auto" prefers a scalable solver — same rationale and
# threshold class as pose_graph.PGO_DENSE_LIMIT: the dense cross block
# is N*N*49 f32 (12.8 MB at the threshold, growing quadratically) and
# the replicated (7N, 7N) LU solve grows cubically, while the chain
# solve stays O(N) and the CG matvec O(E).
SIM3_DENSE_LIMIT = 256


def chain_damping(n_nodes: int, damping: float) -> float:
    """Length-aware Marquardt damping (see pose_graph.chain_damping;
    measured here: the 1,000-node scale-ramp problem crept at 1e-4 —
    ls[-1] 0.28 of 0.41 after 20 EXACT GN iters — and converged in 3 at
    the scaled value, ATE 0.274 -> 0.027)."""
    from sift_parallel_optimization.models.pose_graph import (
        chain_damping as _cd,
    )

    return _cd(n_nodes, damping, SIM3_DENSE_LIMIT)


def resolve_sim3_solver(
    n_nodes: int, solver: str = "auto", offchain_cap: int | None = None
) -> str:
    """"auto" keeps the bit-stable dense solve at small N; above the
    limit it takes the exact chain+Woodbury solve when the caller vouches
    for an off-chain edge cap (``offchain_cap``), else matrix-free CG
    (structure-agnostic, but slow to diffuse loop corrections along long
    chains — see the chain-solver comment block)."""
    if solver != "auto":
        return solver
    if n_nodes <= SIM3_DENSE_LIMIT:
        return "dense"
    return "chain" if offchain_cap is not None else "cg"


def sim3_step(
    poses: Sim3Poses,
    edges: Sim3Edges,
    damping: float = 1e-3,
    solver: str = "dense",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int = 32,
) -> Sim3Poses:
    """One damped Gauss-Newton step (node-0 gauge; solver per docstring
    of :func:`optimize_sim3_graph`)."""
    if solver == "cg":
        blk = assemble_sim3_implicit(poses, edges, damping)
        dx = solve_sim3_cg(blk, cg_iters=cg_iters, cg_tol=cg_tol)
    elif solver == "chain":
        blk = assemble_sim3_chain(
            poses, edges, damping, offchain_cap=offchain_cap
        )
        dx = solve_sim3_chain(blk)
    else:
        dx = _sim3_dense_delta(poses, edges, damping)
    return Sim3Poses(
        rvecs=poses.rvecs + dx[:, :3],
        tvecs=poses.tvecs + dx[:, 3:6],
        log_s=poses.log_s + dx[:, 6],
    )


def optimize_sim3_graph(
    poses: Sim3Poses,
    edges: Sim3Edges,
    n_iters: int = 15,
    damping: float = 1e-4,
    solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int | None = None,
) -> Sim3Poses:
    """Damped GN iterations inside lax.fori_loop (static shapes).

    ``solver``: "dense" materializes the (N, N, 7, 7) cross block and
    LU-solves the (7N, 7N) system (bit-stable, best at small N);
    "chain" is the exact O(N) block-tridiagonal + Woodbury solve for
    odometry-shaped graphs (chain + up to ``offchain_cap`` loop edges
    — what keeps the DEFAULT ``correct_trajectory(sim3=True)`` path
    O(n) for thousand-frame sequences); "cg" is the matrix-free
    block-Jacobi-preconditioned CG (O(E) memory, structure-agnostic);
    "auto" picks by node count and cap availability
    (:func:`resolve_sim3_solver`), mirroring optimize_pose_graph.
    """
    solver = resolve_sim3_solver(
        poses.rvecs.shape[0], solver, offchain_cap
    )

    def body(_, p):
        return sim3_step(
            p, edges, damping, solver=solver,
            cg_iters=cg_iters, cg_tol=cg_tol,
            offchain_cap=32 if offchain_cap is None else offchain_cap,
        )

    return lax.fori_loop(0, n_iters, body, poses)
