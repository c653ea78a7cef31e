"""Multi-view geometry primitives, batched for the accelerator.

North-star extension (BASELINE.json configs 4-5); no analogue in the
reference. Everything is batched linear algebra — small per-item SVDs and
solves vmapped over points/hypotheses so XLA lowers them to batched kernels.

Conventions: world-to-camera pose (R, t): x_cam = R @ x_world + t.
Pixels via intrinsics K (3x3, zero skew). Rotations stored as 3-vectors
(axis-angle, Rodrigues) wherever they are optimized, as matrices elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def _f32_precision(fn):
    """Run ``fn`` with HIGHEST matmul precision.

    Default matmul precision is reduced on accelerators (TF32 on an
    H100's tensor cores; bf16 on the engine's first accelerator), which
    is catastrophic for the geometry stack (SVDs, triangulation,
    normal-equation solves): the SfM pipeline produced thousands-of-pixels
    reprojection errors until these paths were pinned to f32.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# Fast batched small-matrix primitives
#
# jnp.linalg.svd of tiny matrices lowers to an ITERATIVE Jacobi that
# unrolls into a large scalar-heavy program (on the engine's first
# accelerator, 128 vmapped 12x12 SVDs dominated the tracking step). The
# RANSAC hypothesis path and
# DLT triangulation only need (a) the smallest eigenvector of a tiny PSD
# normal matrix and (b) the nearest rotation to a near-orthogonal 3x3 —
# both reachable with batched LU solves and closed-form 3x3 algebra.
# ---------------------------------------------------------------------------


def smallest_eigvec(ata: jax.Array, iters: int = 3) -> jax.Array:
    """(..., n, n) PSD -> (..., n) unit eigenvector of the smallest
    eigenvalue, via shifted inverse iteration (batched LU solves).

    The matrix is first DIAGONALLY EQUILIBRATED (D a D with
    D = diag(ata)^-1/2): raw DLT normal matrices mix pixel^2 and unit^2
    scales across columns (condition ~1e10, beyond f32 LU), while the
    equilibrated form is near-unit-diagonal — and an exact null vector
    survives equilibration exactly (A D y = 0 <=> A (D y) = 0). For
    noisy inputs this finds the minimizer of |A D y|/|y|, a Hartley
    -style rescaled least squares — a legitimate (often better
    -conditioned) variant of the SVD's minimizer; RANSAC scoring /
    downstream gates judge the result either way.

    The shift (1e-6 on the unit diagonal) keeps the solve nonsingular
    even for degenerate inputs (a RANSAC sample of coplanar points),
    where the result is an arbitrary near-null vector — finite junk
    that scores zero inliers, exactly what the SVD produced.
    Convergence per iteration is ~(lam_min + shift)/(lam_2 + shift):
    essentially one iteration when a clean null vector exists; a few
    cover noisy minimal samples.
    """
    n = ata.shape[-1]
    diag = jnp.diagonal(ata, axis1=-2, axis2=-1)
    d = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-30))
    eq = ata * d[..., :, None] * d[..., None, :]
    shifted = eq + 1e-6 * jnp.eye(n, dtype=ata.dtype)
    # Deterministic generic start vector (not axis-aligned, so it is
    # never exactly orthogonal to the null vector of real inputs).
    v0 = jnp.sin(jnp.arange(1, n + 1, dtype=ata.dtype))
    v = jnp.broadcast_to(v0, ata.shape[:-2] + (n,))
    # Invert ONCE with closed-form/recursive block algebra, iterate with
    # matvecs instead of the batched LU pivot loop jnp.linalg.solve
    # lowers to (sequential, slow at these tiny sizes). The
    # equilibrated+shifted
    # matrix is near-unit-diagonal, exactly the regime _block_inv is
    # safe in; inverse iteration self-corrects any residual inverse
    # error (it only needs the small-eigenvalue subspace amplified).
    inv = _block_inv(shifted)
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", inv, v)
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30
        )
    v = v * d
    return v / jnp.maximum(
        jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30
    )


def _inv2(m: jax.Array) -> jax.Array:
    """Closed-form batched 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack(
        [jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2
    )
    return adj / det[..., None, None]


def _inv3(m: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], -1),
            jnp.stack([D, E, F], -1),
            jnp.stack([G, H, I], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _inv4(m: jax.Array) -> jax.Array:
    """Closed-form batched 4x4 inverse (2x2-minor cofactor expansion).

    Replaces a batched LU factorization (a sequential pivot loop) with
    elementwise cofactor algebra.
    """
    s0 = m[..., 0, 0] * m[..., 1, 1] - m[..., 1, 0] * m[..., 0, 1]
    s1 = m[..., 0, 0] * m[..., 1, 2] - m[..., 1, 0] * m[..., 0, 2]
    s2 = m[..., 0, 0] * m[..., 1, 3] - m[..., 1, 0] * m[..., 0, 3]
    s3 = m[..., 0, 1] * m[..., 1, 2] - m[..., 1, 1] * m[..., 0, 2]
    s4 = m[..., 0, 1] * m[..., 1, 3] - m[..., 1, 1] * m[..., 0, 3]
    s5 = m[..., 0, 2] * m[..., 1, 3] - m[..., 1, 2] * m[..., 0, 3]
    c5 = m[..., 2, 2] * m[..., 3, 3] - m[..., 3, 2] * m[..., 2, 3]
    c4 = m[..., 2, 1] * m[..., 3, 3] - m[..., 3, 1] * m[..., 2, 3]
    c3 = m[..., 2, 1] * m[..., 3, 2] - m[..., 3, 1] * m[..., 2, 2]
    c2 = m[..., 2, 0] * m[..., 3, 3] - m[..., 3, 0] * m[..., 2, 3]
    c1 = m[..., 2, 0] * m[..., 3, 2] - m[..., 3, 0] * m[..., 2, 2]
    c0 = m[..., 2, 0] * m[..., 3, 1] - m[..., 3, 0] * m[..., 2, 1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    inv = jnp.stack([
        jnp.stack([
            m[..., 1, 1] * c5 - m[..., 1, 2] * c4 + m[..., 1, 3] * c3,
            -m[..., 0, 1] * c5 + m[..., 0, 2] * c4 - m[..., 0, 3] * c3,
            m[..., 3, 1] * s5 - m[..., 3, 2] * s4 + m[..., 3, 3] * s3,
            -m[..., 2, 1] * s5 + m[..., 2, 2] * s4 - m[..., 2, 3] * s3,
        ], -1),
        jnp.stack([
            -m[..., 1, 0] * c5 + m[..., 1, 2] * c2 - m[..., 1, 3] * c1,
            m[..., 0, 0] * c5 - m[..., 0, 2] * c2 + m[..., 0, 3] * c1,
            -m[..., 3, 0] * s5 + m[..., 3, 2] * s2 - m[..., 3, 3] * s1,
            m[..., 2, 0] * s5 - m[..., 2, 2] * s2 + m[..., 2, 3] * s1,
        ], -1),
        jnp.stack([
            m[..., 1, 0] * c4 - m[..., 1, 1] * c2 + m[..., 1, 3] * c0,
            -m[..., 0, 0] * c4 + m[..., 0, 1] * c2 - m[..., 0, 3] * c0,
            m[..., 3, 0] * s4 - m[..., 3, 1] * s2 + m[..., 3, 3] * s0,
            -m[..., 2, 0] * s4 + m[..., 2, 1] * s2 - m[..., 2, 3] * s0,
        ], -1),
        jnp.stack([
            -m[..., 1, 0] * c3 + m[..., 1, 1] * c1 - m[..., 1, 2] * c0,
            m[..., 0, 0] * c3 - m[..., 0, 1] * c1 + m[..., 0, 2] * c0,
            -m[..., 3, 0] * s3 + m[..., 3, 1] * s1 - m[..., 3, 2] * s0,
            m[..., 2, 0] * s3 - m[..., 2, 1] * s1 + m[..., 2, 2] * s0,
        ], -1),
    ], -2)
    return inv / det[..., None, None]


def _block_inv(m: jax.Array) -> jax.Array:
    """Batched n x n inverse by recursive 2x2 block elimination.

    Base cases are the closed-form 2/3/4 adjugate inverses; larger n
    splits into [[A, B], [C, D]] and uses the Schur complement
    S = D - C A^-1 B — every step is elementwise algebra or a batched
    matmul, never a LU/pivot loop. Intended for the WELL-SCALED matrices of
    this module's solvers — callers equilibrate first (e.g.
    smallest_eigvec, _psd_solve), which keeps the leading blocks of a
    PSD input safely invertible in f32.
    """
    n = m.shape[-1]
    if n == 1:
        return 1.0 / jnp.where(jnp.abs(m) > 1e-30, m, 1e-30)
    if n == 2:
        return _inv2(m)
    if n == 3:
        return _inv3(m)
    if n == 4:
        return _inv4(m)
    h = n // 2
    a = m[..., :h, :h]
    b = m[..., :h, h:]
    c = m[..., h:, :h]
    d = m[..., h:, h:]
    ai = _block_inv(a)
    aib = ai @ b
    cai = c @ ai
    si = _block_inv(d - c @ aib)
    sicai = si @ cai
    top = jnp.concatenate([ai + aib @ sicai, -(aib @ si)], axis=-1)
    bot = jnp.concatenate([-sicai, si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _psd_solve(h: jax.Array, rhs: jax.Array) -> jax.Array:
    """Batched solve of a PSD system via equilibrated block inversion.

    h (..., n, n), rhs (..., n) -> (..., n). Diagonal equilibration
    tames mixed-unit normal matrices (pixels^2 vs radians^2: cond ~1e8
    raw) before the f32 closed-form inversion; inv(h) = D inv(DhD) D.
    Replaces jnp.linalg.solve on the per-hypothesis GN path, where the
    batched LU pivot loop dominated the whole tracking step.

    One step of ITERATIVE REFINEMENT follows the approximate solve
    (round 5, chip-measured): the unpivoted block-LDU inverse loses
    ~cond * eps accuracy on genuinely ill-conditioned pose Hessians
    (low-parallax minimal samples), and those systematically-short GN
    steps compounded into a 13%-of-span odometry regression on the
    18-frame chip gate (vs 1.3% with LU). The residual correction
    x += B(rhs - h x) — two extra batched matvecs — recovers LU-grade
    steps (gate back to ~1.2%) at ~none of the LU pivot loop's cost.
    """
    diag = jnp.diagonal(h, axis1=-2, axis2=-1)
    d = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-30))
    heq = h * d[..., :, None] * d[..., None, :]
    binv = _block_inv(heq)
    g = rhs * d
    x = jnp.einsum("...ij,...j->...i", binv, g)
    resid = g - jnp.einsum("...ij,...j->...i", heq, x)
    x = x + jnp.einsum("...ij,...j->...i", binv, resid)
    return x * d


def polar_rotation(m: jax.Array, iters: int = 6) -> jax.Array:
    """Nearest rotation (orthogonal polar factor) of (..., 3, 3) with
    det > 0, via the Newton iteration X <- (X + X^-T) / 2 with
    determinant scaling — closed-form 3x3 algebra only, replacing the
    Procrustes SVD on the RANSAC hypothesis path. Callers must
    pre-flip the sign so det(m) > 0 (pnp_dlt already does)."""
    x = m
    for _ in range(iters):
        det = jnp.abs(jnp.linalg.det(x))
        x = x / jnp.cbrt(jnp.maximum(det, 1e-30))[..., None, None]
        x = 0.5 * (x + jnp.swapaxes(_inv3(x), -1, -2))
    return x


# ---------------------------------------------------------------------------
# Rotations (axis-angle <-> matrix)
# ---------------------------------------------------------------------------


@_f32_precision
def rodrigues(w: jax.Array) -> jax.Array:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (exp map).

    Taylor-safe near zero so it is differentiable everywhere.

    Pinned to HIGHEST matmul precision: the K @ K term otherwise runs at
    the backend's reduced default precision and every residual evaluated
    through an unpinned caller (rms_error, the LM accept test) inherits
    ~0.1 px of noise (a 0.12 px BA convergence floor vs 7e-5 pinned, on
    the engine's first accelerator).
    """
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)  # (..., 1)
    small = theta < 1e-6
    th = jnp.where(small, 1.0, theta)
    k = w / th
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = jnp.zeros_like(kx)
    K = jnp.stack(
        [
            jnp.stack([zero, -kz, ky], -1),
            jnp.stack([kz, zero, -kx], -1),
            jnp.stack([-ky, kx, zero], -1),
        ],
        -2,
    )
    eye = jnp.broadcast_to(jnp.eye(3), K.shape)
    s = jnp.sin(theta)[..., None]
    c = jnp.cos(theta)[..., None]
    R = eye + s * K + (1 - c) * (K @ K)
    # Near zero: I + hat(w) (first order, keeps gradients exact).
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    Ws = jnp.stack(
        [
            jnp.stack([zero, -wz, wy], -1),
            jnp.stack([wz, zero, -wx], -1),
            jnp.stack([-wy, wx, zero], -1),
        ],
        -2,
    )
    return jnp.where(small[..., None], eye + Ws, R)


def rotation_log(R: jax.Array) -> jax.Array:
    """(3, 3) rotation -> (3,) axis-angle (log map), robust at theta ~ pi.

    The standard v * theta / (2 sin theta) formula degenerates as
    theta -> pi (the antisymmetric part vanishes); there the axis is
    recovered from the dominant column of R + I instead.
    """
    v = jnp.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    nv = jnp.linalg.norm(v)  # = 2 sin(theta), exact from matrix entries
    cos_t = jnp.clip((jnp.trace(R) - 1) / 2, -1.0, 1.0)
    # atan2(|v|/2, cos) is well conditioned everywhere, unlike arccos whose
    # f32 error near +-1 gets amplified by theta/(2 sin theta).
    theta = jnp.arctan2(nv / 2.0, cos_t)
    # w = v * theta / |v|; as theta -> 0 the ratio -> 1/2 (continuous).
    ratio = jnp.where(nv > 1e-6, theta / jnp.maximum(nv, 1e-12), 0.5)
    w_general = v * ratio
    # Near pi the antisymmetric part vanishes and v carries no direction:
    # recover the axis from R + I = 2 axis axis^T (+ O(pi - theta) error,
    # so keep this branch NARROW). With the atan2 form above, the general
    # formula's direction error is ~eps/(2*gap); the crossover where both
    # errors match is gap ~ sqrt(eps) ~ 3e-4.
    B = R + jnp.eye(3)
    k = jnp.argmax(jnp.diagonal(B))
    col = B[:, k]
    axis = col / jnp.maximum(jnp.linalg.norm(col), 1e-12)
    sign = jnp.where(jnp.dot(axis, v) < 0, -1.0, 1.0)
    w_pi = axis * theta * sign
    return jnp.where(theta > jnp.pi - 3e-4, w_pi, w_general)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------


class Camera(NamedTuple):
    rvec: jax.Array  # (3,) axis-angle world->cam
    tvec: jax.Array  # (3,)

    def matrix(self, K: jax.Array) -> jax.Array:
        """(3, 4) projection matrix P = K [R | t] (HIGHEST precision —
        see rodrigues)."""
        R = rodrigues(self.rvec)
        with jax.default_matmul_precision("highest"):
            return K @ jnp.concatenate([R, self.tvec[:, None]], axis=1)


@_f32_precision
def project(
    pts: jax.Array, rvec: jax.Array, tvec: jax.Array, K: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(N, 3) world pts -> ((N, 2) pixels, (N,) depth).

    Pinned to HIGHEST matmul precision (see rodrigues): this is the
    residual kernel of every solver and every accuracy gate.
    """
    R = rodrigues(rvec)
    pc = pts @ R.T + tvec
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    uv1 = (pc / zs[..., None]) @ K.T
    return uv1[..., :2], z


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


@_f32_precision
def triangulate(
    P1: jax.Array, P2: jax.Array, p1: jax.Array, p2: jax.Array
) -> jax.Array:
    """Batched DLT triangulation: (3,4) x2 projections, (N,2) x2 pixels ->
    (N, 3) world points (homogeneous SVD null vector per correspondence)."""

    def one(u1, u2):
        a = jnp.stack(
            [
                u1[0] * P1[2] - P1[0],
                u1[1] * P1[2] - P1[1],
                u2[0] * P2[2] - P2[0],
                u2[1] * P2[2] - P2[1],
            ]
        )
        # Null vector via the 4x4 normal matrix + inverse iteration —
        # cheaper than a per-point SVD (see smallest_eigvec).
        x = smallest_eigvec(a.T @ a)
        return x[:3] / jnp.where(jnp.abs(x[3]) > 1e-12, x[3], 1e-12)

    return jax.vmap(one)(p1, p2)


# ---------------------------------------------------------------------------
# Essential matrix & relative pose
# ---------------------------------------------------------------------------


def essential_from_fundamental(F: jax.Array, K: jax.Array) -> jax.Array:
    return K.T @ F @ K


def decompose_essential(E: jax.Array):
    """E -> 4 candidate (R, t): (4, 3, 3) rotations, (4, 3) translations."""
    u, _, vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


@_f32_precision
def recover_pose(
    E: jax.Array,
    p1: jax.Array,
    p2: jax.Array,
    K: jax.Array,
    mask: jax.Array,
):
    """Pick the (R, t) candidate with the most points in front of BOTH
    cameras (cheirality check via batched triangulation). Camera 1 is
    identity; returns (R, t, points3d, front_mask) for the winner. |t| = 1
    (monocular scale is unobservable)."""
    Rs, ts = decompose_essential(E)
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)

    def score(R, t):
        P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
        X = triangulate(P1, P2, p1, p2)
        z1 = X[:, 2]
        z2 = (X @ R.T + t)[:, 2]
        front = (z1 > 0) & (z2 > 0) & mask
        return front.sum(), X, front

    counts, Xs, fronts = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], Xs[best], fronts[best]


# ---------------------------------------------------------------------------
# PnP (camera from 2D-3D correspondences)
# ---------------------------------------------------------------------------


@_f32_precision
def pnp_dlt(
    pts3d: jax.Array, pts2d: jax.Array, K: jax.Array, w: jax.Array
) -> Camera:
    """Weighted DLT PnP: (N,3) world, (N,2) pixels, (N,) weights -> Camera.

    Solves for P (3x4) as the null vector of the weighted design matrix,
    then factors K^-1 P into [R|t] with orthogonal Procrustes. Weights make
    it RANSAC-friendly (outliers get w=0) with static shapes.
    """
    x = jnp.concatenate([pts3d, jnp.ones_like(pts3d[:, :1])], -1)  # (N,4)
    u, v = pts2d[:, 0], pts2d[:, 1]
    z = jnp.zeros_like(x)
    rows_u = jnp.concatenate([x, z, -u[:, None] * x], -1)   # (N, 12)
    rows_v = jnp.concatenate([z, x, -v[:, None] * x], -1)
    a = jnp.concatenate([rows_u, rows_v], 0)                # (2N, 12)
    ww = jnp.concatenate([w, w], 0)
    ata = jnp.einsum("ki,k,kj->ij", a, ww, a)
    # Null vector + nearest rotation WITHOUT tiny SVDs (an iterative
    # Jacobi unrolled per hypothesis): inverse iteration + Newton polar
    # use only batched solves / closed-form 3x3 algebra (~same
    # hypothesis, RANSAC scoring decides anyway).
    P = smallest_eigvec(ata).reshape(3, 4)
    # K is a tiny upper-triangular intrinsics matrix; its closed-form
    # inverse replaces two batched LU solves per hypothesis.
    k_inv = _inv3(K)
    M = k_inv @ P[:, :3]
    # The null vector's sign is arbitrary: normalize so M = s*R with s > 0
    # (det(M) = s^3), which also settles cheirality for points in front.
    sgn = jnp.sign(jnp.linalg.det(M))
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    P = P * sgn
    M = M * sgn
    R = polar_rotation(M)
    scale = jnp.trace(R.T @ M) / 3.0
    t = (k_inv @ P[:, 3]) / jnp.where(
        jnp.abs(scale) > 1e-12, scale, 1e-12
    )
    cam = Camera(rvec=rotation_log(R), tvec=t)
    return refine_pose(cam, pts3d, pts2d, K, w, n_iters=3)


@_f32_precision
def refine_pose(
    cam: Camera,
    pts3d: jax.Array,
    pts2d: jax.Array,
    K: jax.Array,
    w: jax.Array,
    n_iters: int = 3,
    damping: float = 1e-6,
    solver: str = "block",
) -> Camera:
    """Gauss-Newton pose-only refinement (weighted reprojection).

    Linearizes with the closed-form camera Jacobian
    (ba._analytic_jacobian_cols — the same structure-of-arrays algebra
    the BA hot path uses; jacfwd's tangent passes are ~an order of
    magnitude more ops). ``solver`` picks the 6x6 normal solve: "block"
    (equilibrated block inverse — the right call when this function is
    VMAPPED over RANSAC hypotheses, where a batched LU pivot loop is
    slow) or "lu" (one fused LU — faster for a single batch-1
    refinement, where the block recursion is kernel-count bound).
    """

    def step(_, theta):
        from sift_parallel_optimization.models.ba import (
            _analytic_jacobians_core,
        )

        n = pts3d.shape[0]
        jc, _jp, r = _analytic_jacobians_core(
            jnp.broadcast_to(theta[:3], (n, 3)),
            jnp.broadcast_to(theta[3:], (n, 3)),
            pts3d, pts2d, jnp.ones(n, bool), K,
        )
        # Residuals were historically weighted by w BEFORE squaring
        # (res * w), i.e. normal equations in w^2 — keep that contract.
        jc = jc * w[:, None, None]
        r = r * w[:, None]
        h = jnp.einsum("mik,mil->kl", jc, jc) + damping * jnp.eye(6)
        g = jnp.einsum("mik,mi->k", jc, r)
        if solver == "lu":
            return theta - jnp.linalg.solve(h, g)
        return theta - _psd_solve(h, g)

    theta = jax.lax.fori_loop(
        0, n_iters, step, jnp.concatenate([cam.rvec, cam.tvec])
    )
    return Camera(rvec=theta[:3], tvec=theta[3:])


def reprojection_error(
    cam: Camera, pts3d: jax.Array, pts2d: jax.Array, K: jax.Array
) -> jax.Array:
    """(N,) pixel reprojection distances."""
    uv, _ = project(pts3d, cam.rvec, cam.tvec, K)
    return jnp.linalg.norm(uv - pts2d, axis=-1)
