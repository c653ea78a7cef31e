"""Pose-graph optimization (PGO) on SE(3), batched on device.

North-star back end component (BASELINE.json config 5: "multi-host
pose-graph + distributed Schur-complement BA"). Same static-shape form as
models/ba.py: fixed-capacity edge list with validity masks, autodiff
per-edge Jacobians, segment-sum + dense-block normal equations, damped
Gauss-Newton inside `lax.fori_loop`. The edge-sharded distributed variant
reuses the one-psum reduction pattern (parallel/ba.py) via
``assemble_pgo_blocks`` / ``solve_pgo`` being separable.

Convention: poses are world->cam (R_i, t_i) as axis-angle+translation;
edge (i, j) measures the relative transform cam_i -> cam_j:
R_rel = R_j R_i^T, t_rel = t_j - R_rel t_i.
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


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity relative-pose constraint list."""

    i: jax.Array        # (E,) i32 source node
    j: jax.Array        # (E,) i32 target node
    rel_rvec: jax.Array  # (E, 3) measured relative rotation (axis-angle)
    rel_tvec: jax.Array  # (E, 3) measured relative translation
    weight: jax.Array   # (E,) f32 information weight (0 = invalid)


class Poses(NamedTuple):
    rvecs: jax.Array  # (N, 3)
    tvecs: jax.Array  # (N, 3)


def relative_pose(ri, ti, rj, tj):
    """(rvec_rel, tvec_rel) of cam_i -> cam_j."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.T
    t_rel = tj - R_rel @ ti
    return rotation_log(R_rel), t_rel


def _edge_residual(ri, ti, rj, tj, rel_r, rel_t):
    """(6,) residual: [log(R_meas^T R_rel); t_rel - t_meas]."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.T
    t_rel = tj - R_rel @ ti
    e_rot = rotation_log(rodrigues(rel_r).T @ R_rel)
    e_t = t_rel - rel_t
    return jnp.concatenate([e_rot, e_t])


def pgo_residuals(poses: Poses, edges: PoseGraphEdges) -> jax.Array:
    """(E, 6) weighted residuals (zero for invalid edges).

    Pinned to HIGHEST matmul precision: the R_j R_i^T products otherwise
    run at the backend's reduced default precision and the rms gate
    reads pure precision noise.
    """
    with jax.default_matmul_precision("highest"):
        return _pgo_residuals_impl(poses, edges)


def _pgo_residuals_impl(poses: Poses, edges: PoseGraphEdges) -> jax.Array:
    r = jax.vmap(_edge_residual)(
        poses.rvecs[edges.i], poses.tvecs[edges.i],
        poses.rvecs[edges.j], poses.tvecs[edges.j],
        edges.rel_rvec, edges.rel_tvec,
    )
    return r * jnp.sqrt(jnp.maximum(edges.weight, 0.0))[:, None]


def pgo_rms(poses: Poses, edges: PoseGraphEdges) -> jax.Array:
    r = pgo_residuals(poses, edges)
    n = jnp.maximum((edges.weight > 0).sum(), 1)
    return jnp.sqrt(jnp.sum(r * r) / n)


def _f32_precision(fn):
    """HIGHEST matmul precision wrapper (see models/geometry.py)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def _edge_jacobians(poses: Poses, edges: PoseGraphEdges):
    """Weighted, gauge-masked per-edge Jacobians and residuals.

    Returns ji (E, 6, 6) = d r_e / d pose_i, jj (E, 6, 6), r (E, 6), all
    scaled by sqrt(weight) and with node-0 blocks zeroed (gauge fixing —
    masking Ji/Jj kills both the row AND column blocks of node 0 in
    J^T J, matching solve_pgo's dense m0 masking).
    """

    def one(ri, ti, rj, tj, rel_r, rel_t, w):
        def f(theta):
            return _edge_residual(
                theta[:3], theta[3:6], theta[6:9], theta[9:], rel_r, rel_t
            ) * jnp.sqrt(jnp.maximum(w, 0.0))

        theta = jnp.concatenate([ri, ti, rj, tj])
        jac = jax.jacfwd(f)(theta)          # (6, 12)
        return jac[:, :6], jac[:, 6:], f(theta)

    ji, jj, r = jax.vmap(one)(
        poses.rvecs[edges.i], poses.tvecs[edges.i],
        poses.rvecs[edges.j], poses.tvecs[edges.j],
        edges.rel_rvec, edges.rel_tvec, edges.weight,
    )                                        # (E,6,6) (E,6,6) (E,6)

    keep_i = (edges.i != 0)[:, None, None].astype(ji.dtype)
    keep_j = (edges.j != 0)[:, None, None].astype(jj.dtype)
    return ji * keep_i, jj * keep_j, r


@_f32_precision
def assemble_pgo_blocks(poses: Poses, edges: PoseGraphEdges):
    """Normal-equation blocks; summing over edge shards commutes, so a
    psum over the returned pytree yields the global system."""
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
    w_ij = jnp.einsum("eab,eac->ebc", ji, jj)   # (E, 6, 6)
    # Flat-index segment_sum in place of a 2-D scatter (see models/ba.py).
    cross = jax.ops.segment_sum(
        w_ij.reshape(-1, 36), edges.i * N + edges.j, N * N
    ).reshape(N, N, 6, 6)
    return hii + hjj, cross, b


@_f32_precision
def solve_pgo(hdiag, cross, b, damping: float = 1e-3):
    """Dense solve of the (6N, 6N) system -> (N, 6) update."""
    N = hdiag.shape[0]
    h = cross + cross.transpose(1, 0, 3, 2)
    h = h.at[jnp.arange(N), jnp.arange(N)].add(hdiag)
    # Marquardt-scaled damping (see models/ba.py for the f32 rationale).
    hd = h[jnp.arange(N), jnp.arange(N)]
    d = jnp.diagonal(hd, axis1=-2, axis2=-1)
    h = h.at[jnp.arange(N), jnp.arange(N)].add(
        (damping * d + 1e-6)[..., None] * jnp.eye(6)
    )
    hd_dense = h.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
    m0 = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (N - 1))])
    hd_dense = hd_dense * m0[:, None] * m0[None, :] + jnp.diag(1.0 - m0)
    b = b.at[0].set(0.0)
    return jnp.linalg.solve(hd_dense, b.reshape(-1)).reshape(N, 6)


# ---------------------------------------------------------------------------
# Implicit CG path (the scalable solver: no dense (N, N, 6, 6) cross block)
# ---------------------------------------------------------------------------


class ImplicitPgo(NamedTuple):
    """Per-GN-step linearization for the matrix-free solve: O(E) memory.

    H = J^T J is only ever APPLIED through per-edge products — the same
    treatment models/ba.py gives the Schur complement. Node assignment is
    carried as one-hot (E, N) tensors so the matvec's edge gather/scatter
    are dense matmuls instead of scatters (see models/ba.py).
    """

    ji: jax.Array         # (E, 6, 6) weighted gauge-masked d r / d pose_i
    jj: jax.Array         # (E, 6, 6)
    oh_i: jax.Array       # (E, N) one-hot source node
    oh_j: jax.Array       # (E, N) one-hot target node
    damp_vec: jax.Array   # (N, 6) Marquardt damping diagonal addition
    minv: jax.Array       # (N, 6, 6) block-Jacobi preconditioner
    b: jax.Array          # (N, 6) right-hand side (node 0 zeroed)


@_f32_precision
def assemble_pgo_implicit(
    poses: Poses, edges: PoseGraphEdges, damping: float = 1e-3
) -> ImplicitPgo:
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
    prec = hdiag + damp_vec[..., None] * jnp.eye(6)
    prec = prec.at[0].set(jnp.eye(6))  # gauge: node-0 block is identity
    return ImplicitPgo(
        ji=ji, jj=jj, oh_i=oh_i, oh_j=oh_j,
        damp_vec=damp_vec, minv=jnp.linalg.inv(prec), b=b,
    )


def pgo_matvec(blk: ImplicitPgo, x: jax.Array) -> jax.Array:
    """(damped H) x through per-edge products: (N, 6) -> (N, 6)."""
    xi = jnp.einsum("en,nk->ek", blk.oh_i, x)           # (E, 6)
    xj = jnp.einsum("en,nk->ek", blk.oh_j, x)
    t = (
        jnp.einsum("eab,eb->ea", blk.ji, xi)
        + jnp.einsum("eab,eb->ea", blk.jj, xj)
    )                                                    # (E, 6) = J x
    out = (
        jnp.einsum("en,eab,ea->nb", blk.oh_i, blk.ji, t)
        + jnp.einsum("en,eab,ea->nb", blk.oh_j, blk.jj, t)
    )
    out = out + blk.damp_vec * x
    # Node-0 gauge block is the identity (its Jacobians are masked, so
    # the edge products and x_0 columns are already zero there).
    return out.at[0].set(x[0])


@_f32_precision
def solve_pgo_cg(
    blk: ImplicitPgo, cg_iters: int = 100, cg_tol: float = 1e-8
) -> jax.Array:
    """Block-Jacobi preconditioned CG -> (N, 6) update (matrix-free).

    Same adaptive-stop structure as models/ba.py solve_schur_cg: run to
    ``cg_tol`` on the preconditioned residual or ``cg_iters``, whichever
    first — late Gauss-Newton steps start near the solution and exit in
    a handful of iterations.
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
        ap = pgo_matvec(blk, p)
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
# (block-size-generic — the Sim(3) module reuses these with 7-DOF blocks;
# see pose_graph_sim3.py's comment block for the full rationale: on
# odometry-shaped graphs CG stalls on the chain's N^2-conditioned global
# modes, while the chain part of H is exactly solvable in O(N) by
# block-Thomas elimination and the L loop edges are a rank-dL Woodbury
# correction.)
# ---------------------------------------------------------------------------


def block_tridiag_solve(diag, off, rhs):
    """Solve the SPD block-tridiagonal system T X = RHS.

    diag (N, d, d), off (N-1, d, d) = block (i, i+1), rhs (N, d, k).
    Two lax.scan sweeps of (d, d+k) solves — O(N) work and memory, the
    Kalman-smoother treatment of chain sparsity.
    """
    d = diag.shape[-1]
    off_prev = jnp.concatenate(
        [jnp.zeros((1, d, d), diag.dtype), off], axis=0
    )                                           # block (i-1, i) at row i
    off_next = jnp.concatenate(
        [off, jnp.zeros((1, d, d), diag.dtype)], axis=0
    )                                           # block (i, i+1) at row i
    k = rhs.shape[-1]

    def fwd(carry, inp):
        g_prev, y_prev = carry                  # (d, d), (d, k)
        d_i, o_prev, o_next, b_i = inp
        denom = d_i - o_prev.T @ g_prev
        sol = jnp.linalg.solve(
            denom,
            jnp.concatenate([o_next, b_i - o_prev.T @ y_prev], axis=1),
        )
        g_i, y_i = sol[:, :d], sol[:, d:]
        return (g_i, y_i), (g_i, y_i)

    init = (jnp.zeros((d, d), diag.dtype), jnp.zeros((d, k), diag.dtype))
    _, (g, y) = lax.scan(fwd, init, (diag, off_prev, off_next, rhs))

    def bwd(x_next, inp):
        g_i, y_i = inp
        x_i = y_i - g_i @ x_next
        return x_i, x_i

    _, x_rev = lax.scan(
        bwd, jnp.zeros((d, k), diag.dtype), (g, y), reverse=True
    )
    return x_rev


def chain_woodbury_delta(diag, off, u_ji, u_jj, u_i, u_j, b):
    """Exact (N, d) update of (T + U^T U) x = b via Woodbury.

    T is the damped chain tridiagonal (diag/off); U stacks the L
    off-chain (loop) edges' weighted Jacobian rows: row block l applies
    u_ji[l] at node u_i[l] and u_jj[l] at node u_j[l]. One
    factorization solves 1 + dL right-hand sides in the same two
    block-Thomas sweeps; the (dL, dL) capacitance solve is dense but
    tiny. Exact — same fixed point as the dense solver (tested for both
    the 6-DOF SE(3) and 7-DOF Sim(3) instantiations).
    """
    N, d = b.shape
    L = u_i.shape[0]
    # U^T as a dense (N, d, dL) multi-RHS block: loop slot l writes
    # u_ji[l]^T at node u_i[l]'s rows of column block l (distinct
    # column blocks — no collisions; one-hot einsum keeps it a matmul).
    oh_i = jax.nn.one_hot(u_i, N, dtype=b.dtype)           # (L, N)
    oh_j = jax.nn.one_hot(u_j, N, dtype=b.dtype)
    ut = jnp.einsum("ln,lba->nalb", oh_i, u_ji) + jnp.einsum(
        "ln,lba->nalb", oh_j, u_jj
    )                                                       # (N,d,L,d)
    rhs = jnp.concatenate(
        [b[..., None], ut.reshape(N, d, L * d)], axis=-1
    )
    x = block_tridiag_solve(diag, off, rhs)                 # (N,d,1+dL)
    tb, tu = x[..., 0], x[..., 1:]                          # (N,d),(N,d,dL)

    def apply_u(m):
        # U @ m for m (N, d, k): gather rows at the loop nodes.
        return (
            jnp.einsum("lab,lbk->lak", u_ji, m[u_i])
            + jnp.einsum("lab,lbk->lak", u_jj, m[u_j])
        ).reshape(L * d, -1)

    s = jnp.eye(L * d, dtype=b.dtype) + apply_u(tu)         # capacitance
    w = jnp.linalg.solve(s, apply_u(tb[..., None]))         # (dL, 1)
    return tb - jnp.einsum("nak,k->na", tu, w[:, 0])


def chain_edge_split(ji, jj, r, edges, N: int, damping: float,
                     offchain_cap: int):
    """Shared chain/loop split + damped tridiagonal assembly.

    Returns (diag, off, u_ji, u_jj, u_i, u_j, b) for
    :func:`chain_woodbury_delta`. Chain edges are detected structurally
    (j == i + 1, weight > 0); ALL other valid edges are compacted into
    ``offchain_cap`` low-rank slots (the caller must guarantee the true
    off-chain count fits — host-known in the trajectory drivers).
    Gradient and Marquardt damping come from the FULL system so the
    step matches the dense solver's exactly.
    """
    d = ji.shape[-1]
    valid = edges.weight > 0
    chain = valid & (edges.j == edges.i + 1)
    cf = chain.astype(ji.dtype)[:, None, None]

    diag = jax.ops.segment_sum(
        cf * jnp.einsum("eab,eac->ebc", ji, ji), edges.i, N
    ) + jax.ops.segment_sum(
        cf * jnp.einsum("eab,eac->ebc", jj, jj), edges.j, N
    )
    off = jax.ops.segment_sum(
        cf * jnp.einsum("eab,eac->ebc", ji, jj), edges.i, N
    )[: N - 1]

    b = -(
        jax.ops.segment_sum(jnp.einsum("eab,ea->eb", ji, r), edges.i, N)
        + jax.ops.segment_sum(jnp.einsum("eab,ea->eb", jj, r), edges.j, N)
    )
    b = b.at[0].set(0.0)
    hdiag_full = jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", ji, ji), edges.i, N
    ) + jax.ops.segment_sum(
        jnp.einsum("eab,eac->ebc", jj, jj), edges.j, N
    )
    dg = jnp.diagonal(hdiag_full, axis1=-2, axis2=-1)
    # Off-chain edges' diagonal contributions ride the Woodbury term.
    diag = diag + (damping * dg + 1e-6)[..., None] * jnp.eye(d)
    diag = diag.at[0].set(jnp.eye(d))  # node-0 gauge block

    loop = valid & ~chain
    sel = jnp.argsort(~loop, stable=True)[:offchain_cap]
    lf = loop[sel].astype(ji.dtype)[:, None, None]
    return (
        diag, off, ji[sel] * lf, jj[sel] * lf,
        jnp.where(loop[sel], edges.i[sel], 0),
        jnp.where(loop[sel], edges.j[sel], 0),
        b,
    )


def chain_damping(
    n_nodes: int, damping: float, limit: int | None = None
) -> float:
    """Length-aware Marquardt damping for long-chain graphs.

    lambda * diag(H) suppresses update components along eigendirections
    below lambda * diag; a chain's lowest structural mode (the global
    ramp the loop edges exist to fix) has eigenvalue ~ diag / N^2, so a
    fixed lambda FREEZES it once N >~ 100 (measured on the 1,000-node
    Sim(3) scale ramp: 1e-4 crept for 20+ iterations, the scaled value
    converged in 3). Scaling by (limit / N)^2 keeps the damped
    spectrum's floor below the slowest physical mode at any length
    while leaving tuned small-N behavior untouched.
    """
    if limit is None:
        limit = PGO_DENSE_LIMIT
    return damping * min(1.0, (limit / max(n_nodes, 1)) ** 2)


@_f32_precision
def assemble_pgo_chain(
    poses: Poses,
    edges: PoseGraphEdges,
    damping: float = 1e-3,
    offchain_cap: int = 32,
):
    """Linearize + split for the SE(3) chain+Woodbury solve."""
    N = poses.rvecs.shape[0]
    ji, jj, r = _edge_jacobians(poses, edges)
    return chain_edge_split(ji, jj, r, edges, N, damping, offchain_cap)


@_f32_precision
def solve_pgo_chain(blk) -> jax.Array:
    """Exact (N, 6) update via block-Thomas + Woodbury (see
    :func:`chain_woodbury_delta`)."""
    return chain_woodbury_delta(*blk)


# N above which "auto" prefers a scalable solver: the dense cross block
# is N*N*36 f32 (9.4 MB at the threshold, growing quadratically) and
# the replicated (6N, 6N) LU solve grows cubically, while the chain
# solve stays O(N) and the CG matvec O(E).
PGO_DENSE_LIMIT = 256


def resolve_pgo_solver(
    n_nodes: int, solver: str = "auto", offchain_cap: int | None = None
) -> str:
    """"auto" keeps the bit-stable dense solve at small N; above the
    limit it takes the exact chain+Woodbury solve when the caller
    vouches for an off-chain edge cap, else matrix-free CG
    (structure-agnostic, but slow to diffuse loop corrections along
    long chains — see the chain-solver comment block)."""
    if solver != "auto":
        return solver
    if n_nodes <= PGO_DENSE_LIMIT:
        return "dense"
    return "chain" if offchain_cap is not None else "cg"


def pgo_step(
    poses: Poses,
    edges: PoseGraphEdges,
    damping: float = 1e-3,
    solver: str = "dense",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int = 32,
) -> Poses:
    if solver == "cg":
        blk = assemble_pgo_implicit(poses, edges, damping)
        delta = solve_pgo_cg(blk, cg_iters=cg_iters, cg_tol=cg_tol)
    elif solver == "chain":
        blk = assemble_pgo_chain(
            poses, edges, damping, offchain_cap=offchain_cap
        )
        delta = solve_pgo_chain(blk)
    else:
        hdiag, cross, b = assemble_pgo_blocks(poses, edges)
        delta = solve_pgo(hdiag, cross, b, damping)
    return Poses(
        rvecs=poses.rvecs + delta[:, :3],
        tvecs=poses.tvecs + delta[:, 3:],
    )


def optimize_pose_graph(
    poses: Poses,
    edges: PoseGraphEdges,
    n_iters: int = 20,
    damping: float = 1e-3,
    solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int | None = None,
) -> Poses:
    """Damped Gauss-Newton PGO with a static trip count (jit this).

    ``solver``: "dense" materializes the (N, N, 6, 6) cross block and LU-
    solves the (6N, 6N) system (bit-stable, best at small N); "chain" is
    the exact O(N) block-tridiagonal + Woodbury solve for
    odometry-shaped graphs (chain + up to ``offchain_cap`` loop edges);
    "cg" is the matrix-free block-Jacobi-preconditioned CG (O(E)
    memory, structure-agnostic); "auto" picks by node count and cap
    availability (resolve_pgo_solver).
    """
    solver = resolve_pgo_solver(
        poses.rvecs.shape[0], solver, offchain_cap
    )

    def body(_, p):
        return pgo_step(
            p, edges, damping, solver=solver,
            cg_iters=cg_iters, cg_tol=cg_tol,
            offchain_cap=32 if offchain_cap is None else offchain_cap,
        )

    return lax.fori_loop(0, n_iters, body, poses)
