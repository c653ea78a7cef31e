"""Gauss-Newton bundle adjustment with dense Schur complement, on device.

North-star extension (BASELINE.json configs 4-5); no analogue in the
reference. The classic sparse-BA structure is reshaped for a static-shape
accelerator program:

* Observations live in a FIXED-capacity structure-of-arrays with a valid
  mask (invalid slots contribute zero residual/Jacobian) — static shapes.
* Per-observation 2x6 / 2x3 Jacobians come from `jax.jacfwd` of the single-
  observation residual, vmapped — XLA batches them; no hand-derived chains.
* The normal equations are assembled with `segment_sum` (camera and point
  diagonal blocks) and a scatter-add into a DENSE (C, P, 6, 3) camera-point
  cross block. Dense-blocked beats sparse here: C*P*18 floats is megabytes
  for the target scene sizes, and every downstream contraction becomes an
  einsum the MXU executes directly — no indirection, no sorting.
* The reduced camera system (Schur complement S = Hcc - W Hpp^-1 W^T) is a
  couple of einsums + one (6C, 6C) dense solve; landmarks come back by
  batched 3x3 back-substitution. This exact assembly is what
  parallel/ba.py distributes: observations shard over the mesh and the
  block sums become psums (reduce_scatter camera blocks, all_gather
  landmark updates — BASELINE.json north star).

Iteration is damped Gauss-Newton (fixed lambda, fixed iteration count)
inside `lax.fori_loop` — no data-dependent control flow under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from sift_parallel_optimization.models.geometry import project


class Observations(NamedTuple):
    """Fixed-capacity observation list (the BA 'measurement graph')."""

    cam_idx: jax.Array  # (M,) i32
    pt_idx: jax.Array   # (M,) i32
    uv: jax.Array       # (M, 2) f32 measured pixels
    valid: jax.Array    # (M,) bool

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))


class Anchors(NamedTuple):
    """Fixed-landmark reprojection factors: camera DOF only.

    Marginalization-lite for the windowed odometry (round 4): when a
    landmark block is evicted from the window, surviving cameras'
    observations of those landmarks would otherwise be DISCARDED
    (models/odometry.shift_window invalidates them), cutting the
    constraints that tie the window to the geometry it just left — the
    dominant windowed-only drift source. An anchor keeps such an
    observation alive against the landmark's FROZEN world position: the
    residual is project(pose_cam, xyz_frozen) - uv with a Jacobian only
    in the 6 camera DOF, so anchors contribute ONLY to the Hcc diagonal
    blocks and camera rhs — the Schur structure (and both solvers'
    shapes) are untouched. Anchors expire with their camera (at most
    window-1 evictions), so frozen-position bias stays local — the same
    locality argument as first-estimate-Jacobian marginalization priors.
    (Reference analogue: none — north-star config 5; closest cousin is
    the archive-PnP loop constraint, which anchors against REVISITED
    frozen landmarks where this anchors against just-evicted ones.)
    """

    cam_idx: jax.Array  # (A,) i32
    xyz: jax.Array      # (A, 3) f32 frozen world positions (constants)
    uv: jax.Array       # (A, 2) f32 measured pixels
    valid: jax.Array    # (A,) bool

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))


def empty_anchors(capacity: int) -> Anchors:
    return Anchors(
        cam_idx=jnp.zeros(capacity, jnp.int32),
        xyz=jnp.zeros((capacity, 3), jnp.float32),
        uv=jnp.zeros((capacity, 2), jnp.float32),
        valid=jnp.zeros(capacity, bool),
    )


class BAState(NamedTuple):
    rvecs: jax.Array   # (C, 3) axis-angle world->cam
    tvecs: jax.Array   # (C, 3)
    points: jax.Array  # (P, 3)


def _residual_one(rvec, tvec, pt, uv, K):
    uvp, _ = project(pt[None], rvec, tvec, K)
    return uvp[0] - uv  # (2,)


def residuals(state: BAState, obs: Observations, K: jax.Array) -> jax.Array:
    """(M, 2) reprojection residuals, zeroed on invalid slots."""
    r = jax.vmap(_residual_one, in_axes=(0, 0, 0, 0, None))(
        state.rvecs[obs.cam_idx],
        state.tvecs[obs.cam_idx],
        state.points[obs.pt_idx],
        obs.uv,
        K,
    )
    return jnp.where(obs.valid[:, None], r, 0.0)


def anchor_residuals(
    state: BAState, anchors: "Anchors", K: jax.Array
) -> jax.Array:
    """(A, 2) fixed-landmark reprojection residuals, zeroed on invalid
    slots. The landmark position is the anchor's FROZEN constant, so the
    residual depends only on the camera pose (see :class:`Anchors`)."""
    r = jax.vmap(_residual_one, in_axes=(0, 0, 0, 0, None))(
        state.rvecs[anchors.cam_idx],
        state.tvecs[anchors.cam_idx],
        anchors.xyz,
        anchors.uv,
        K,
    )
    return jnp.where(anchors.valid[:, None], r, 0.0)


def rms_error(state: BAState, obs: Observations, K: jax.Array) -> jax.Array:
    r = residuals(state, obs, K)
    n = jnp.maximum(obs.count(), 1)
    return jnp.sqrt(jnp.sum(r * r) / n)


def _obs_jacobians(state: BAState, obs: Observations, K: jax.Array):
    """Per-observation Jacobians: Jc (M, 2, 6), Jp (M, 2, 3), r (M, 2).

    REFERENCE IMPLEMENTATION (autodiff, 9 jacfwd tangent passes): kept as
    the agreement oracle for `_analytic_jacobians`
    (tests/test_geometry_ba.py); all production assembly — dense and
    implicit — linearizes with the closed-form path.
    """

    def one(rvec, tvec, pt, uv):
        def f_cam(c):
            return _residual_one(c[:3], c[3:], pt, uv, K)

        def f_pt(p):
            return _residual_one(rvec, tvec, p, uv, K)

        cam = jnp.concatenate([rvec, tvec])
        r = _residual_one(rvec, tvec, pt, uv, K)
        return jax.jacfwd(f_cam)(cam), jax.jacfwd(f_pt)(pt), r

    jc, jp, r = jax.vmap(one)(
        state.rvecs[obs.cam_idx],
        state.tvecs[obs.cam_idx],
        state.points[obs.pt_idx],
        obs.uv,
    )
    w = obs.valid[:, None, None].astype(jnp.float32)
    return jc * w, jp * w, jnp.where(obs.valid[:, None], r, 0.0)


def _huber_weights(r: jax.Array, delta: float) -> jax.Array:
    """(M,) IRLS weights for the Huber loss on residual norms."""
    n = jnp.linalg.norm(r, axis=-1)
    return jnp.where(n <= delta, 1.0, delta / jnp.maximum(n, 1e-12))


def _hat_cols(x, y, z):
    """Cross-product matrix [v]x as a 3x3 nested list of (N,) arrays."""
    zero = jnp.zeros_like(x)
    return [[zero, -z, y], [z, zero, -x], [-y, x, zero]]


def _mat3_mul_cols(a, b):
    """3x3 matrix product on nested-list-of-(N,)-array operands."""
    return [
        [sum(a[i][l] * b[l][j] for l in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _rodrigues_cols(wx, wy, wz):
    """Scalarized geometry.rodrigues: the 9 entries of R as (N,) arrays.

    Same Taylor-safe small-angle branch (R ~ I + hat(w) below 1e-6) as
    models.geometry.rodrigues, so the two agree bitwise-closely. The
    scalarized form exists because (N, 3, 3) intermediates with tiny
    trailing dims lay out poorly on the engine's first accelerator,
    where tensor-form rodrigues on 208k rows cost ~20x its memory
    traffic; (N,) component arrays are dense on any backend.
    """
    nsq = wx * wx + wy * wy + wz * wz
    theta = jnp.sqrt(nsq)
    small = theta < 1e-6
    th = jnp.where(small, 1.0, theta)
    kx, ky, kz = wx / th, wy / th, wz / th
    s = jnp.sin(theta)
    mc = 1.0 - jnp.cos(theta)
    c = jnp.cos(theta)
    # R = cos(t) I + sin(t) [k]x + (1-cos(t)) k k^T  (unit axis k).
    big = [
        [c + mc * kx * kx, -s * kz + mc * kx * ky, s * ky + mc * kx * kz],
        [s * kz + mc * kx * ky, c + mc * ky * ky, -s * kx + mc * ky * kz],
        [-s * ky + mc * kx * kz, s * kx + mc * ky * kz, c + mc * kz * kz],
    ]
    one = jnp.ones_like(wx)
    lin = [[one, -wz, wy], [wz, one, -wx], [-wy, wx, one]]
    return [
        [jnp.where(small, lin[i][j], big[i][j]) for j in range(3)]
        for i in range(3)
    ]


def _rotation_point_jac_cols(w_cols, p_cols, R):
    """d(R(w) p)/dw, closed form (Gallego & Yezzi 2015, eq. 9), scalarized.

    w_cols/p_cols: 3-tuples of (N,) arrays; R: nested-list rotation from
    _rodrigues_cols. Returns the 9 entries of the (3, 3) Jacobian as a
    nested list. As ||w|| -> 0 the limit is -[p]x, substituted below the
    epsilon (matches the rodrigues first-order branch, so it agrees with
    jacfwd everywhere).
    """
    wx, wy, wz = w_cols
    nsq = wx * wx + wy * wy + wz * wz
    h = _hat_cols(wx, wy, wz)
    ph = _hat_cols(*p_cols)
    w_ = [wx, wy, wz]
    # inner = w w^T + R^T [w]x - [w]x
    inner = [
        [
            w_[i] * w_[j]
            + sum(R[l][i] * h[l][j] for l in range(3))
            - h[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    b = _mat3_mul_cols(ph, inner)
    rb = _mat3_mul_cols(R, b)
    inv = 1.0 / jnp.maximum(nsq, 1e-12)
    small = nsq < 1e-12
    return [
        [jnp.where(small, -ph[i][j], -rb[i][j] * inv) for j in range(3)]
        for i in range(3)
    ]


def _analytic_jacobian_cols(rv_cols, tv_cols, p_cols, uv_cols, valid, K):
    """Closed-form Jacobians in structure-of-arrays (column) form.

    All inputs/outputs are (N,) component arrays; nothing with trailing
    tiny dims is ever materialized (see _rodrigues_cols). Returns (jc [2][6], jp [2][3], r [2]) nested lists,
    zeroed on invalid slots.

    Chain: r = pi(q) - uv with q = R p + t, so
      d r / d t = A,  d r / d p = A R,  d r / d w = A * d(R p)/dw
    with A = d pi / d q the (2, 3) pinhole Jacobian (rows [fx/z, 0,
    -fx x/z^2], [0, fy/z, -fy y/z^2] — the zeros make A-products sparse).
    Agreement with the jacfwd path is tested (tests/test_geometry_ba.py).
    """
    R = _rodrigues_cols(*rv_cols)
    q = [
        sum(R[i][j] * p_cols[j] for j in range(3)) + tv_cols[i]
        for i in range(3)
    ]
    z = q[2]
    zs = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    fx, fy = K[0, 0], K[1, 1]
    inv_z = 1.0 / zs
    zero = jnp.zeros_like(z)
    a00 = fx * inv_z
    a02 = -fx * q[0] * inv_z * inv_z
    a11 = fy * inv_z
    a12 = -fy * q[1] * inv_z * inv_z
    # jp = A R; row sparsity of A gives two products per entry.
    jp0 = [a00 * R[0][k] + a02 * R[2][k] for k in range(3)]
    jp1 = [a11 * R[1][k] + a12 * R[2][k] for k in range(3)]
    dw = _rotation_point_jac_cols(rv_cols, p_cols, R)
    jw0 = [a00 * dw[0][k] + a02 * dw[2][k] for k in range(3)]
    jw1 = [a11 * dw[1][k] + a12 * dw[2][k] for k in range(3)]
    # jc = [jw | jt] with jt = A.
    jc0 = jw0 + [a00, zero, a02]
    jc1 = jw1 + [zero, a11, a12]
    r0 = q[0] * inv_z * fx + K[0, 2] - uv_cols[0]
    r1 = q[1] * inv_z * fy + K[1, 2] - uv_cols[1]
    v = valid.astype(jnp.float32)
    jc = [[e * v for e in jc0], [e * v for e in jc1]]
    jp = [[e * v for e in jp0], [e * v for e in jp1]]
    r = [r0 * v, r1 * v]
    return jc, jp, r


def _analytic_jacobians_core(rv, tv, p, uv, valid, K: jax.Array):
    """Closed-form Jacobians from pre-gathered per-slot inputs.

    rv/tv/p: (M, 3); uv: (M, 2); valid: (M,) bool. Returns
    (jc (M, 2, 6), jp (M, 2, 3), r (M, 2)), zeroed on invalid slots.
    Thin stacking wrapper over _analytic_jacobian_cols.
    """
    jc_c, jp_c, r_c = _analytic_jacobian_cols(
        (rv[:, 0], rv[:, 1], rv[:, 2]),
        (tv[:, 0], tv[:, 1], tv[:, 2]),
        (p[:, 0], p[:, 1], p[:, 2]),
        (uv[:, 0], uv[:, 1]),
        valid,
        K,
    )
    jc = jnp.stack([jnp.stack(row, -1) for row in jc_c], -2)
    jp = jnp.stack([jnp.stack(row, -1) for row in jp_c], -2)
    r = jnp.stack(r_c, -1)
    return jc, jp, r


def _analytic_jacobians(state: BAState, obs: Observations, K: jax.Array):
    """Closed-form per-observation Jacobians (same contract as
    ``_obs_jacobians`` but ~an order of magnitude fewer ops than the 9
    jacfwd tangent passes — the BA linearization hot path)."""
    return _analytic_jacobians_core(
        state.rvecs[obs.cam_idx],
        state.tvecs[obs.cam_idx],
        state.points[obs.pt_idx],
        obs.uv,
        obs.valid,
        K,
    )


class NormalBlocks(NamedTuple):
    """Assembled normal-equation blocks (the distributable intermediate).

    In parallel/ba.py each device assembles these from its observation
    shard and a single psum over the pytree yields the global system —
    the sum over observations commutes with everything downstream.
    """

    hcc: jax.Array  # (C, 6, 6) camera diagonal blocks
    hpp: jax.Array  # (P, 3, 3) point diagonal blocks
    bc: jax.Array   # (C, 6)
    bp: jax.Array   # (P, 3)
    w: jax.Array    # (C, P, 6, 3) camera-point cross blocks


def _f32_precision(fn):
    """HIGHEST matmul precision wrapper (see models/geometry.py)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@_f32_precision
def assemble_normal_blocks(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    anchors: Anchors | None = None,
) -> NormalBlocks:
    """Linearize all observations and reduce them into block form.

    Linearization uses the closed-form `_analytic_jacobians` (the jacfwd
    path `_obs_jacobians` is the test-only oracle — round-2 measured the
    9-tangent-pass autodiff at ~an order of magnitude more ops on the BA
    hot path).
    """
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    M = obs.cam_idx.shape[0]
    if anchors is None:
        jc, jp, r = _analytic_jacobians(state, obs, K)
        cam_all = obs.cam_idx
        jc_all, r_all = jc, r
    else:
        # ONE linearization pass over observations + anchor factors
        # (round 5): the separate anchor pass repeated the whole
        # rotation-chain subexpression tree as a second kernel run
        # every GN iteration; concatenating the pre-gathered inputs
        # amortizes it. Anchor rows' point Jacobians are computed and
        # sliced away (their positions are frozen constants).
        cam_all = jnp.concatenate([obs.cam_idx, anchors.cam_idx])
        jc_all, jp_all, r_all = _analytic_jacobians_core(
            state.rvecs[cam_all],
            state.tvecs[cam_all],
            jnp.concatenate([state.points[obs.pt_idx], anchors.xyz]),
            jnp.concatenate([obs.uv, anchors.uv]),
            jnp.concatenate([obs.valid, anchors.valid]),
            K,
        )
        jp = jp_all[:M]
    if huber_delta is not None:
        hw_all = _huber_weights(r_all, huber_delta)[:, None, None]
        jc_all = jc_all * jnp.sqrt(hw_all)
        r_all = r_all * jnp.sqrt(hw_all[:, :, 0])
        if anchors is None:
            jp = jp * jnp.sqrt(hw_all)
        else:
            jp = jp * jnp.sqrt(hw_all[:M])

    # Gauge fixing: freeze camera 0 (zero its Jacobian) to remove the
    # 7-dof gauge freedom (6 pose + scale is handled by the prior scene).
    if fix_first_cam:
        keep = (cam_all != 0)[:, None, None].astype(jc_all.dtype)
        jc_all = jc_all * keep
    jc, r = jc_all[:M], r_all[:M]

    # One-hot matmul aggregation instead of segment_sum: the engine's
    # first accelerator lowered segment_sum to a sort-based scatter,
    # ~5x slower than the same reductions as (C, M) / (P, M) one-hot
    # matmuls (not re-measured on the GPU). The one-hot operands are
    # exact {0, 1} f32, so values match up to f32 summation order.
    # Camera-side sums run over the CONCATENATED rows (obs + anchors).
    oh_ca = jax.nn.one_hot(cam_all, C, dtype=jc_all.dtype)  # (M+A, C)
    oh_p = jax.nn.one_hot(obs.pt_idx, P, dtype=jp.dtype)    # (M, P)
    hcc = jnp.einsum(
        "mc,mkl->ckl", oh_ca, jnp.einsum("mik,mil->mkl", jc_all, jc_all)
    )                                               # (C, 6, 6)
    hpp = jnp.einsum(
        "mp,mkl->pkl", oh_p, jnp.einsum("mik,mil->mkl", jp, jp)
    )                                               # (P, 3, 3)
    bc = -jnp.einsum(
        "mc,mk->ck", oh_ca, jnp.einsum("mik,mi->mk", jc_all, r_all)
    )                                               # (C, 6)
    bp = -jnp.einsum(
        "mp,mk->pk", oh_p, jnp.einsum("mik,mi->mk", jp, r)
    )                                               # (P, 3)

    # Dense camera-point cross blocks W[c, p] = sum_obs Jc^T Jp,
    # assembled as a two-sided one-hot contraction in place of a
    # flat-index segment_sum (same exactness: {0, 1} one-hot operands,
    # f32 summation order).
    w_obs = jnp.einsum("mik,mil->mkl", jc, jp)      # (M, 6, 3)
    t = (oh_ca[:M, :, None] * w_obs.reshape(-1, 1, 18))  # (M, C, 18)
    w = jnp.einsum("mck,mp->cpk", t, oh_p).reshape(C, P, 6, 3)
    # Anchor (fixed-landmark) factors ride the concatenated rows above:
    # they contribute ONLY to hcc/bc (their positions are constants),
    # so hpp/bp/w — and hence the Schur elimination — are structurally
    # untouched; see Anchors.
    return NormalBlocks(hcc=hcc, hpp=hpp, bc=bc, bp=bp, w=w)


@_f32_precision
def solve_schur(
    blocks: NormalBlocks,
    damping: float = 1e-3,
    fix_first_cam: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Schur-complement solve of the block system -> (delta_c, delta_p)."""
    hcc, hpp, bc, bp, w = blocks
    C = hcc.shape[0]

    # Marquardt-scaled damping: lambda * diag(H) + absolute floor. Pure
    # identity damping leaves the monocular scale-gauge direction of the
    # reduced system near-singular relative to the ~1e6-magnitude
    # reprojection blocks, which overwhelms a float32 solve; scaling by
    # the diagonal bounds the condition number by ~1/damping.
    def damp(h):
        d = jnp.diagonal(h, axis1=-2, axis2=-1)
        k = h.shape[-1]
        return h + (damping * d + 1e-6)[..., None] * jnp.eye(k)

    hcc = damp(hcc)
    hpp = damp(hpp)

    # Closed-form batched 3x3 inverse (_inv3x3, the same blocks the CG
    # preconditioner inverts this way): elementwise algebra instead of a
    # batched LU pivot loop.
    hpp_inv = _inv3x3(hpp)                          # (P, 3, 3) batched
    y = jnp.einsum("cpik,pkl->cpil", w, hpp_inv)    # (C, P, 6, 3)

    # Reduced camera system: S = Hcc - Y W^T, b = bc - Y bp.
    s = -jnp.einsum("cpik,dplk->cdil", y, w)        # (C, C, 6, 6)
    s = s.at[jnp.arange(C), jnp.arange(C)].add(hcc)
    b = bc - jnp.einsum("cpik,pk->ci", y, bp)       # (C, 6)

    s_dense = s.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
    # Freeze camera 0 rows/cols via identity block.
    if fix_first_cam:
        m0 = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (C - 1))])
        s_dense = s_dense * m0[:, None] * m0[None, :] + jnp.diag(1.0 - m0)
        b = b.at[0].set(0.0)
    # NOTE: replacing this batch-1 LU with the recursive block inverse
    # (geometry._block_inv) made solve_schur ~3x slower on the engine's
    # first accelerator — at batch size 1 the recursion is KERNEL-COUNT
    # bound (dozens of tiny stack/concat/matmul kernels) while one
    # fused (36, 36) LU is cheap. The closed-form inverses only win
    # where they are BATCHED wide (the 128-hypothesis RANSAC path).
    delta_c = jnp.linalg.solve(s_dense, b.reshape(-1)).reshape(C, 6)

    # Back-substitution for landmarks.
    wt_dc = jnp.einsum("cpik,ci->pk", w, delta_c)   # (P, 3)
    delta_p = jnp.einsum("pkl,pl->pk", hpp_inv, bp - wt_dc)
    return delta_c, delta_p


# ---------------------------------------------------------------------------
# Implicit-Schur CG (the scalable path: no dense (C, P, 6, 3) cross block)
# ---------------------------------------------------------------------------


class GroupPlan(NamedTuple):
    """Point-grouped observation layout, computed ONCE per (obs, shapes).

    The grouping depends only on the observation INDEX structure, which is
    constant across Gauss-Newton iterations — so the expensive layout work
    (argsort ranking, scatters) is hoisted out of the GN loop entirely.
    Per-step assembly is then a single row gather through ``perm`` and the
    CG matvec needs ZERO gathers or scatters: the camera assignment is
    carried as a one-hot tensor, turning both W^T x (camera vector into
    point groups) and W y (point groups back to cameras) into dense
    einsums. Scatters and per-slot gathers inside the CG loop dominated
    the first implicit implementation on the engine's first accelerator
    (not re-measured on the GPU).

    Observations whose within-point rank exceeds the capacity R are
    dropped (W stays exactly symmetric since there is only one grouping);
    ``n_dropped`` counts them — size R accordingly.
    """

    perm: jax.Array       # (P, R) i32 source obs index per slot; M = pad
    cam_oh: jax.Array     # (P, R, C) f32 one-hot camera (0-rows on pad)
    uv: jax.Array         # (P, R, 2) grouped pixel observations
    valid: jax.Array      # (P, R) slot validity
    n_dropped: jax.Array  # () i32 valid observations that overflowed R


class ImplicitBlocks(NamedTuple):
    """Per-GN-step linearization in the GroupPlan layout: O(M) memory,
    no O(C*P) dense cross block anywhere. The Schur complement
    S = Hcc - W Hpp^-1 W^T is only ever applied, never materialized."""

    jc: jax.Array       # (P, R, 2, 6) point-grouped camera Jacobians
    jp: jax.Array       # (P, R, 2, 3) point-grouped point Jacobians
    cam_oh: jax.Array   # (P, R, C) from the plan
    hcc: jax.Array      # (C, 6, 6) DAMPED camera diagonal blocks
    hpp_inv: jax.Array  # (P, 3, 3) inverse damped point diagonal blocks
    bc: jax.Array       # (C, 6)
    bp: jax.Array       # (P, 3)


def _damp_blocks(h: jax.Array, damping: float) -> jax.Array:
    """Marquardt-scaled damping (see solve_schur)."""
    d = jnp.diagonal(h, axis1=-2, axis2=-1)
    k = h.shape[-1]
    return h + (damping * d + 1e-6)[..., None] * jnp.eye(k)


def _inv3x3(m: jax.Array) -> jax.Array:
    """Batched closed-form (adjugate) 3x3 inverse.

    Replaces jnp.linalg.inv's batched LU pivot loop with pure
    elementwise work; on the SPD damped Hpp blocks it is applied to, it
    is just as accurate.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    inv = jnp.stack(
        [
            jnp.stack([ca, cb, cc], -1),
            jnp.stack([cd, ce, cf], -1),
            jnp.stack([cg, ch, ci], -1),
        ],
        -2,
    )
    return inv / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)[..., None, None]


def _linearize(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    huber_delta: float | None,
    fix_first_cam: bool,
):
    """Masked, robust-weighted, gauge-fixed per-obs Jacobians + residuals."""
    jc, jp, r = _analytic_jacobians(state, obs, K)
    if huber_delta is not None:
        hw = jnp.sqrt(_huber_weights(r, huber_delta))[:, None, None]
        jc = jc * hw
        jp = jp * hw
        r = r * hw[:, :, 0]
    if fix_first_cam:
        keep = (obs.cam_idx != 0)[:, None, None].astype(jc.dtype)
        jc = jc * keep
    return jc, jp, r


def _group_rank(idx: jax.Array, n: int) -> jax.Array:
    """(M,) group indices -> (M,) 0-based rank within each group."""
    m = idx.shape[0]
    order = jnp.argsort(idx)
    sorted_idx = idx[order]
    start = jnp.searchsorted(sorted_idx, jnp.arange(n, dtype=idx.dtype))
    rank_sorted = jnp.arange(m, dtype=jnp.int32) - start[sorted_idx]
    return jnp.zeros(m, jnp.int32).at[order].set(rank_sorted)


def _cg_capacity(n_obs: int, P: int, max_obs_per_point: int | None) -> int:
    """Static group capacity R with a 2x-mean heuristic."""

    def up8(v):
        return max(8, (v + 7) // 8 * 8)

    return max_obs_per_point or min(up8(2 * -(-n_obs // P)), up8(n_obs))


def make_group_plan(
    obs: Observations,
    n_cams: int,
    n_points: int,
    max_obs_per_point: int | None = None,
) -> GroupPlan:
    """Build the point-grouped layout for a fixed observation structure.

    Capacity defaults to 2x the mean occupancy (rounded up to 8); pass an
    explicit ``max_obs_per_point`` when the distribution is skewed (SfM
    maps: a landmark can be observed by every camera, so ~ n_cams).
    Invalid (padding) observations are routed to a virtual overflow group
    so they cannot eat a real group's rank capacity.
    """
    C, P = n_cams, n_points
    M = obs.cam_idx.shape[0]
    R = _cg_capacity(M, P, max_obs_per_point)
    idx = jnp.where(obs.valid, obs.pt_idx, P)
    rank = _group_rank(idx, P)
    keep = (rank < R) & obs.valid
    slot = jnp.where(keep, obs.pt_idx * R + rank, P * R)
    perm = (
        jnp.full(P * R + 1, M, jnp.int32)
        .at[slot]
        .set(jnp.arange(M, dtype=jnp.int32), mode="drop")[: P * R]
        .reshape(P, R)
    )
    slot_valid = perm < M
    cam_ext = jnp.concatenate([obs.cam_idx, jnp.zeros(1, obs.cam_idx.dtype)])
    cam = jnp.where(slot_valid, cam_ext[jnp.minimum(perm, M)], C)
    cam_oh = jax.nn.one_hot(cam, C, dtype=jnp.float32)  # zero rows on pad
    uv_ext = jnp.concatenate([obs.uv, jnp.zeros((1, 2), obs.uv.dtype)])
    uv_g = uv_ext[jnp.minimum(perm, M)]
    n_dropped = jnp.sum(obs.valid) - jnp.sum(keep)
    return GroupPlan(
        perm=perm, cam_oh=cam_oh, uv=uv_g, valid=slot_valid,
        n_dropped=n_dropped,
    )


def assemble_implicit_blocks(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    max_obs_per_point: int | None = None,
    plan: GroupPlan | None = None,
    anchors: Anchors | None = None,
) -> ImplicitBlocks:
    """Linearize with analytic Jacobians DIRECTLY in the GroupPlan layout.

    Pass ``plan`` (from make_group_plan) when solving repeatedly over the
    same observation structure — bundle_adjust does — so the layout work
    runs once, not per GN step. Per step there are NO gathers or scatters
    at all: uv/validity are grouped in the plan (they never change across
    GN iterations), camera parameters reach their slots through the
    one-hot matmul, the point broadcasts along its own group axis, and
    the closed-form Jacobians are evaluated per (point, rank) slot.

    The whole linearization runs SCALARIZED — (N,) component arrays, not
    (N, 2, 6) tensors — because trailing tiny dims padded out and that
    padded traffic dominated the first implementation (see
    _rodrigues_cols).
    Matmul precision is pinned HIGHEST only on the two real contractions
    (one-hot parameter spread, camera-side reduction); everything else is
    elementwise work, which is natively exact f32.
    """
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    if plan is None:
        plan = make_group_plan(obs, C, P, max_obs_per_point)
    oh = plan.cam_oh
    R_cap = plan.perm.shape[1]
    n_slots = P * R_cap

    with jax.default_matmul_precision("highest"):
        cam_par = jnp.concatenate([state.rvecs, state.tvecs], axis=1)
        par_g = jnp.einsum("prc,ck->prk", oh, cam_par)  # (P, R, 6)
    par_g = par_g.reshape(n_slots, 6)
    p_g = jnp.broadcast_to(state.points[:, None, :], (P, R_cap, 3))
    p_g = p_g.reshape(n_slots, 3)
    uv_g = plan.uv.reshape(n_slots, 2)
    jc, jp, r = _analytic_jacobian_cols(
        (par_g[:, 0], par_g[:, 1], par_g[:, 2]),
        (par_g[:, 3], par_g[:, 4], par_g[:, 5]),
        (p_g[:, 0], p_g[:, 1], p_g[:, 2]),
        (uv_g[:, 0], uv_g[:, 1]),
        plan.valid.reshape(n_slots),
        K,
    )
    if huber_delta is not None:
        n = jnp.sqrt(r[0] * r[0] + r[1] * r[1])
        hw = jnp.sqrt(
            jnp.where(n <= huber_delta, 1.0, huber_delta / jnp.maximum(n, 1e-12))
        )
        jc = [[e * hw for e in row] for row in jc]
        jp = [[e * hw for e in row] for row in jp]
        r = [e * hw for e in r]
    if fix_first_cam:
        keep = (1.0 - oh[..., 0]).reshape(n_slots)
        jc = [[e * keep for e in row] for row in jc]

    # Camera-side reduction: J^T J and J^T r entries are elementwise
    # products (VPU); the per-camera sums are ONE (C, n_slots) x
    # (n_slots, 42) MXU matmul against the one-hot assignment. The 36
    # hcc entries are symmetric but cheap enough to emit directly.
    cam_cols = [
        jc[0][k] * jc[0][l] + jc[1][k] * jc[1][l]
        for k in range(6)
        for l in range(6)
    ] + [jc[0][k] * r[0] + jc[1][k] * r[1] for k in range(6)]
    cam_side = jnp.stack(cam_cols, axis=-1)               # (n, 42)
    with jax.default_matmul_precision("highest"):
        out = lax.dot_general(
            oh.reshape(n_slots, C), cam_side, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                                 # (C, 42)
    hcc = out[:, :36].reshape(C, 6, 6)
    bc = -out[:, 36:42]

    # Point-side reduction: plain sums over the group axis, still in
    # column form ((P, R) reshape -> sum axis 1).
    def psum_col(e):
        return e.reshape(P, R_cap).sum(axis=1)

    hpp_cols = [
        [psum_col(jp[0][k] * jp[0][l] + jp[1][k] * jp[1][l]) for l in range(3)]
        for k in range(3)
    ]
    hpp = jnp.stack(
        [jnp.stack(row, -1) for row in hpp_cols], -2
    )                                                     # (P, 3, 3)
    bp = -jnp.stack(
        [psum_col(jp[0][k] * r[0] + jp[1][k] * r[1]) for k in range(3)], -1
    )                                                     # (P, 3)

    jc_g = jnp.stack(
        [jnp.stack(row, -1) for row in jc], -2
    ).reshape(P, R_cap, 2, 6)
    jp_g = jnp.stack(
        [jnp.stack(row, -1) for row in jp], -2
    ).reshape(P, R_cap, 2, 3)

    if anchors is not None:
        # Fixed-landmark anchor factors (see Anchors): camera-DOF-only,
        # so they fold into hcc/bc BEFORE damping and the CG operator
        # (schur_matvec reads hcc) picks them up with no other change.
        with jax.default_matmul_precision("highest"):
            ja, _jp_a, ra = _analytic_jacobians_core(
                state.rvecs[anchors.cam_idx],
                state.tvecs[anchors.cam_idx],
                anchors.xyz,
                anchors.uv,
                anchors.valid,
                K,
            )
            if huber_delta is not None:
                hwa = _huber_weights(ra, huber_delta)[:, None, None]
                ja = ja * jnp.sqrt(hwa)
                ra = ra * jnp.sqrt(hwa[:, :, 0])
            if fix_first_cam:
                ja = ja * (anchors.cam_idx != 0)[:, None, None].astype(
                    ja.dtype
                )
            oh_a = jax.nn.one_hot(anchors.cam_idx, C, dtype=ja.dtype)
            hcc = hcc + jnp.einsum(
                "mc,mkl->ckl", oh_a, jnp.einsum("mik,mil->mkl", ja, ja)
            )
            bc = bc - jnp.einsum(
                "mc,mk->ck", oh_a, jnp.einsum("mik,mi->mk", ja, ra)
            )

    hcc = _damp_blocks(hcc, damping)
    if fix_first_cam:
        # Row/col 0 of the reduced system is the identity (x0 stays 0):
        # cam-0 Jacobians are zeroed above so W/bc rows are 0.
        hcc = hcc.at[0].set(jnp.eye(6))
    hpp_inv = _inv3x3(_damp_blocks(hpp, damping))
    return ImplicitBlocks(
        jc=jc_g, jp=jp_g, cam_oh=oh,
        hcc=hcc, hpp_inv=hpp_inv, bc=bc, bp=bp,
    )


def _wt_apply(blk: ImplicitBlocks, x: jax.Array) -> jax.Array:
    """W^T x: (C, 6) camera vector -> (P, 3). One-hot matmul, no gather."""
    xg = jnp.einsum("prc,ck->prk", blk.cam_oh, x)           # (P, R, 6)
    t = jnp.einsum("prik,prk->pri", blk.jc, xg)             # (P, R, 2)
    return jnp.einsum("pril,pri->pl", blk.jp, t)            # (P, 3)


def _w_apply(blk: ImplicitBlocks, y: jax.Array) -> jax.Array:
    """W y: (P, 3) point vector -> (C, 6). One-hot matmul, no scatter."""
    t = jnp.einsum("pril,pl->pri", blk.jp, y)               # (P, R, 2)
    u = jnp.einsum("prik,pri->prk", blk.jc, t)              # (P, R, 6)
    return jnp.einsum("prc,prk->ck", blk.cam_oh, u)         # (C, 6)


def schur_matvec(blk: ImplicitBlocks, x: jax.Array) -> jax.Array:
    """S x = Hcc x - W Hpp^-1 W^T x without materializing S or W."""
    v = _wt_apply(blk, x)                                  # (P, 3)
    y = jnp.einsum("pkl,pl->pk", blk.hpp_inv, v)
    return jnp.einsum("ckl,cl->ck", blk.hcc, x) - _w_apply(blk, y)


@_f32_precision
def solve_schur_cg(
    blk: ImplicitBlocks,
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
) -> tuple[jax.Array, jax.Array]:
    """Preconditioned CG on the reduced camera system -> (delta_c, delta_p).

    Block-Jacobi preconditioner (per-camera 6x6 inverse of the damped Hcc
    diagonal). `lax.while_loop` with static shapes: runs until the
    preconditioned residual norm drops to ``cg_tol * rz0`` (i.e. a 1e-4
    relative residual at the default — far below GN linearization error)
    or ``cg_iters``, whichever first. Late Gauss-Newton steps start near
    the solution and exit in a handful of iterations, so the adaptive
    stop cuts the converged-phase cost without touching the fixed point
    (tested vs the dense solver). Set ``cg_tol=0`` for a fixed trip count.
    """
    y0 = jnp.einsum("pkl,pl->pk", blk.hpp_inv, blk.bp)
    b = blk.bc - _w_apply(blk, y0)                         # (C, 6)
    minv = jnp.linalg.inv(blk.hcc)                         # block Jacobi

    def prec(v):
        return jnp.einsum("ckl,cl->ck", minv, v)

    def dot(a, bb):
        return jnp.sum(a * bb)

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
        ap = schur_matvec(blk, p)
        pap = dot(p, ap)
        alpha = jnp.where(pap > 1e-20, rz / jnp.maximum(pap, 1e-20), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 1e-20, rz_new / jnp.maximum(rz, 1e-20), 0.0)
        p = z + beta * p
        return i + 1, x, r, p, rz_new

    _, x, r, p, rz = lax.while_loop(cond, body, (0, x, r, p, rz))
    delta_c = x
    # Landmark back-substitution: delta_p = Hpp^-1 (bp - W^T delta_c).
    v = _wt_apply(blk, delta_c)
    delta_p = jnp.einsum("pkl,pl->pk", blk.hpp_inv, blk.bp - v)
    return delta_c, delta_p


def apply_deltas(
    state: BAState, delta_c: jax.Array, delta_p: jax.Array
) -> BAState:
    return BAState(
        rvecs=state.rvecs + delta_c[:, :3],
        tvecs=state.tvecs + delta_c[:, 3:],
        points=state.points + delta_p,
    )


# C * P above which "auto" prefers the implicit-Schur CG solver: the dense
# cross block W is C*P*18 f32 (4.7 MB at the threshold) and its assembly /
# Y-einsums start to dominate, while CG's grouped layout amortizes. Chosen
# so the north-star 50-cam x 6400-pt SfM map takes the CG path and the
# small windowed-odometry / test scenes keep the bit-stable dense solve.
DENSE_CROSS_LIMIT = 65_536


def resolve_solver(
    n_cams: int, n_points: int, solver: str = "auto"
) -> str:
    """Pick the Schur solver from STATIC capacities (shapes, not values).

    "auto" -> "cg" when the dense (C, P, 6, 3) cross block would exceed
    `DENSE_CROSS_LIMIT` camera-point cells, else "dense". Explicit
    "dense"/"cg" pass through.
    """
    if solver != "auto":
        return solver
    return "cg" if n_cams * n_points >= DENSE_CROSS_LIMIT else "dense"


def ba_step(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    plan: GroupPlan | None = None,
    anchors: Anchors | None = None,
) -> BAState:
    """One damped Gauss-Newton step with Schur-complement elimination.

    ``solver``: "dense" materializes W and solves the (6C, 6C) reduced
    system exactly (best for small scenes, bit-stable); "cg" runs the
    implicit-Schur preconditioned CG (O(M) memory, scales to hundreds of
    cameras — see GroupPlan/ImplicitBlocks). Pass ``plan`` to reuse the
    grouping across steps. ``anchors`` (fixed-landmark factors, dense
    solver only) add camera-block information — see :class:`Anchors`.
    """
    if solver == "cg":
        blk = assemble_implicit_blocks(
            state, obs, K, damping=damping,
            huber_delta=huber_delta, fix_first_cam=fix_first_cam,
            plan=plan, anchors=anchors,
        )
        delta_c, delta_p = solve_schur_cg(
            blk, cg_iters=cg_iters, cg_tol=cg_tol
        )
    else:
        blocks = assemble_normal_blocks(
            state, obs, K,
            huber_delta=huber_delta, fix_first_cam=fix_first_cam,
            anchors=anchors,
        )
        delta_c, delta_p = solve_schur(
            blocks, damping=damping, fix_first_cam=fix_first_cam
        )
    return apply_deltas(state, delta_c, delta_p)


def bundle_adjust(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    n_iters: int = 10,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    max_obs_per_point: int | None = None,
    anchors: Anchors | None = None,
) -> BAState:
    """Run ``n_iters`` damped Gauss-Newton steps (static trip count).

    ``solver`` may be "auto" (resolved from the static camera/point
    capacities — see :func:`resolve_solver`). For the CG solver the
    observation grouping (make_group_plan) is computed once here and
    reused by every step — the layout depends only on the index
    structure, not on the evolving state. ``anchors``: optional
    fixed-landmark factors, supported by both solvers (see
    :class:`Anchors`).
    """
    solver = resolve_solver(
        state.rvecs.shape[0], state.points.shape[0], solver
    )
    plan = None
    if solver == "cg":
        plan = make_group_plan(
            obs, state.rvecs.shape[0], state.points.shape[0],
            max_obs_per_point,
        )

    def body(_, st):
        return ba_step(
            st, obs, K,
            damping=damping,
            huber_delta=huber_delta,
            fix_first_cam=fix_first_cam,
            solver=solver,
            cg_iters=cg_iters,
            cg_tol=cg_tol,
            plan=plan,
            anchors=anchors,
        )

    # NOTE: unrolling short GN loops (Python for instead of fori_loop)
    # measured ~40% SLOWER for the 4-iter W=6 window BA on the engine's
    # first accelerator (not re-measured on the GPU). The rolled loop body is
    # compiled once and scheduled tightly; the unrolled program
    # quadruples in size with no cross-iteration fusion to show for it.
    return lax.fori_loop(0, n_iters, body, state)


def _huber_sum(r: jax.Array, huber_delta: float | None) -> jax.Array:
    """Sum of (Huber) losses over (N, 2) residual rows (zero rows -> 0)."""
    n2 = jnp.sum(r * r, axis=-1)
    if huber_delta is None:
        return 0.5 * jnp.sum(n2)
    n = jnp.sqrt(n2 + 1e-24)
    hub = jnp.where(
        n <= huber_delta, 0.5 * n2, huber_delta * (n - 0.5 * huber_delta)
    )
    return jnp.sum(hub)


def robust_cost(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    huber_delta: float | None = None,
    anchors: Anchors | None = None,
) -> jax.Array:
    """The scalar objective Gauss-Newton/LM minimizes: sum of (Huber)
    losses over valid observations. Invalid slots contribute zero (their
    residuals are zeroed by :func:`residuals`). When ``anchors`` is
    given, their fixed-landmark losses are included — the objective must
    match what the step linearizes, or LM's accept test would accept
    steps the anchored problem rejects (and vice versa)."""
    c = _huber_sum(residuals(state, obs, K), huber_delta)
    if anchors is not None:
        c = c + _huber_sum(
            anchor_residuals(state, anchors, K), huber_delta
        )
    return c


def bundle_adjust_lm(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    max_iters: int = 20,
    lambda_init: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 2.0,
    lambda_max: float = 1e3,
    lambda_min: float = 1e-8,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    solver: str = "auto",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
    max_obs_per_point: int | None = None,
    rel_tol: float = 1e-6,
    anchors: Anchors | None = None,
) -> BAState:
    """Adaptive Levenberg-Marquardt: accept/reject with lambda up/down.

    Fixed-lambda Gauss-Newton (``bundle_adjust``) diverges from poor
    initializations (real-sequence PnP seeds — the north-star config-4/5
    robustness gap): a step that increases the cost is still applied.
    This variant evaluates the true objective after every trial step and
    REJECTS increases, raising lambda (toward gradient descent) until a
    step is productive, lowering it (toward Gauss-Newton) while steps
    succeed — the standard LM trust-region-by-damping loop, phrased as a
    `lax.while_loop` with static shapes so one compiled program serves
    every trajectory of accepts/rejects.

    Exits early when an ACCEPTED step's relative cost decrease falls
    below ``rel_tol`` (converged — further trial steps would only burn
    residual evaluations; a REJECTED step does not exit, it raises
    lambda and retries), when lambda exceeds ``lambda_max`` (stalled —
    no descent direction at any damping), or when the ``max_iters``
    budget is spent. ``lambda_min`` only floors the damping on accepted
    steps.

    ``anchors``: optional fixed-landmark factors (:class:`Anchors`).
    They enter BOTH the trial-step normal equations and the accept-test
    objective (:func:`robust_cost` with anchors) — evaluating the
    objective without them would make LM accept steps the anchored
    problem rejects, the round-4 inconsistency flagged in ROADMAP.
    """
    solver = resolve_solver(
        state.rvecs.shape[0], state.points.shape[0], solver
    )
    plan = None
    if solver == "cg":
        plan = make_group_plan(
            obs, state.rvecs.shape[0], state.points.shape[0],
            max_obs_per_point,
        )

    c0 = robust_cost(state, obs, K, huber_delta, anchors=anchors)

    def cond(carry):
        i, _st, lam, _c, done = carry
        return (i < max_iters) & (lam < lambda_max) & ~done

    def body(carry):
        i, st, lam, c, done = carry
        trial = ba_step(
            st, obs, K,
            damping=lam,
            huber_delta=huber_delta,
            fix_first_cam=fix_first_cam,
            solver=solver,
            cg_iters=cg_iters,
            cg_tol=cg_tol,
            plan=plan,
            anchors=anchors,
        )
        c_new = robust_cost(trial, obs, K, huber_delta, anchors=anchors)
        accept = jnp.isfinite(c_new) & (c_new < c)
        done = accept & (c - c_new <= rel_tol * jnp.maximum(c, 1e-30))
        st = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), st, trial
        )
        lam = jnp.where(
            accept,
            jnp.maximum(lam / lambda_down, lambda_min),
            lam * lambda_up,
        )
        c = jnp.where(accept, c_new, c)
        return i + 1, st, lam, c, done

    _, state, _, _, _ = lax.while_loop(
        cond, body,
        (0, state, jnp.asarray(lambda_init, jnp.float32), c0,
         jnp.asarray(False)),
    )
    return state
