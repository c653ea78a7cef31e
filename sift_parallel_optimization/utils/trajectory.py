"""Trajectory alignment + ATE metrics (the BASELINE.json accuracy gate).

ATE (absolute trajectory error) is computed after Umeyama Sim(3) alignment,
the standard protocol for monocular pipelines whose scale is unobservable
(TUM/KITTI-style evaluation referenced by BASELINE.json).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def camera_centers(rvecs: jax.Array, tvecs: jax.Array) -> jax.Array:
    """(C, 3) camera centers from world->cam poses: c = -R^T t."""
    from sift_parallel_optimization.models.geometry import rodrigues

    R = rodrigues(rvecs)                      # (C, 3, 3)
    return -jnp.einsum("cij,ci->cj", R, tvecs)


def _f32_precision(fn):
    """HIGHEST matmul precision wrapper (see models/geometry.py)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@_f32_precision
def umeyama_alignment(
    src: jax.Array, dst: jax.Array, with_scale: bool = True
):
    """Least-squares similarity transform: s * R @ src + t ~= dst.

    (N, 3) point sets. Returns (s, R, t). Umeyama 1991 closed form.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]            # (3, 3)
    u, d, vt = jnp.linalg.svd(cov)
    sgn = jnp.sign(jnp.linalg.det(u) * jnp.linalg.det(vt))
    diag = jnp.stack([jnp.ones(()), jnp.ones(()), sgn])
    R = (u * diag[None, :]) @ vt
    var_s = (xs * xs).sum() / src.shape[0]
    s = jnp.where(
        with_scale,
        jnp.sum(d * diag) / jnp.maximum(var_s, 1e-12),
        1.0,
    )
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_centers: jax.Array, gt_centers: jax.Array, with_scale: bool = True
) -> jax.Array:
    """RMSE of aligned camera centers (the headline ATE number)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = s * est_centers @ R.T + t
    return jnp.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean())


# ---------------------------------------------------------------------------
# TUM-RGB(D) trajectory format
# ---------------------------------------------------------------------------
#
# One pose per line: ``timestamp tx ty tz qx qy qz qw`` ('#' comments),
# poses camera-to-world — the interchange format of the TUM RGB-D benchmark
# tooling, which BASELINE.json's "Sequence ATE (TUM/KITTI-style)" target
# refers to. The reference has no dataset I/O at all (its input is a
# synthetic constant image, SURVEY.md section 4).


def load_tum(path):
    """Read a TUM trajectory file.

    Returns (timestamps (N,), centers (N, 3), quats (N, 4) xyzw) as
    numpy arrays. Camera-to-world convention: the translation IS the
    camera center.
    """
    import numpy as np

    ts, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                raise IOError(f"{path}: bad TUM line {line!r}")
            vals = [float(p) for p in parts[:8]]
            ts.append(vals[0])
            rows.append(vals[1:])
    if not rows:
        raise IOError(f"{path}: no poses")
    arr = np.asarray(rows, np.float64)
    return np.asarray(ts), arr[:, :3].astype(np.float32), arr[:, 3:7].astype(
        np.float32
    )


def save_tum(path, timestamps, rvecs, tvecs) -> None:
    """Write world->cam axis-angle poses as a TUM (cam-to-world) file."""
    import numpy as np

    from sift_parallel_optimization.models.geometry import rodrigues

    R = np.asarray(rodrigues(jnp.asarray(rvecs)))        # (C,3,3) world->cam
    t = np.asarray(tvecs)
    centers = -np.einsum("cij,ci->cj", R, t)             # cam-to-world trans
    r_wc = np.swapaxes(R, 1, 2)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, ts in enumerate(timestamps):
            q = _rotmat_to_quat(r_wc[i])
            c = centers[i]
            f.write(
                f"{float(ts):.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


# ---------------------------------------------------------------------------
# KITTI odometry trajectory format
# ---------------------------------------------------------------------------
#
# One pose per line: 12 floats, the row-major 3x4 [R | t] camera-to-world
# matrix of frame i (no timestamps — KITTI poses are frame-indexed). The
# other half of BASELINE.json's "TUM/KITTI-style" evaluation target.


def load_kitti(path):
    """Read a KITTI odometry poses file.

    Returns (centers (N, 3) f32, rotations (N, 3, 3) f32
    camera-to-world) as numpy arrays; the translation column IS the
    camera center in world coordinates.
    """
    import numpy as np

    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 12:
                raise IOError(f"{path}: bad KITTI line {line!r}")
            rows.append([float(p) for p in parts])
    if not rows:
        raise IOError(f"{path}: no poses")
    m = np.asarray(rows, np.float64).reshape(-1, 3, 4)
    return m[:, :, 3].astype(np.float32), m[:, :, :3].astype(np.float32)


def save_kitti(path, rvecs, tvecs) -> None:
    """Write world->cam axis-angle poses as a KITTI poses file
    (camera-to-world 3x4 per line, frame order)."""
    import numpy as np

    from sift_parallel_optimization.models.geometry import rodrigues

    R = np.asarray(rodrigues(jnp.asarray(rvecs)))        # (C,3,3) world->cam
    t = np.asarray(tvecs)
    centers = -np.einsum("cij,ci->cj", R, t)
    r_wc = np.swapaxes(R, 1, 2)
    with open(path, "w") as f:
        for i in range(len(t)):
            m = np.concatenate([r_wc[i], centers[i][:, None]], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in m.reshape(-1)) + "\n")


def _rotmat_to_quat(R):
    """(3, 3) rotation -> (x, y, z, w) quaternion (Shepperd's method)."""
    import numpy as np

    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / max(s, 1e-12)
        q[j] = (R[j, i] + R[i, j]) / max(s, 1e-12)
        q[k] = (R[k, i] + R[i, k]) / max(s, 1e-12)
        x, y, z, w = q
    return np.asarray([x, y, z, w], np.float32)


def quat_to_rotmat(q):
    """(N, 4) xyzw quaternions -> (N, 3, 3) rotations (jnp, batched)."""
    q = jnp.asarray(q, jnp.float32)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                       2 * (x * z + y * w)], -1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                       2 * (y * z - x * w)], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                       1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Nearest-timestamp association (the TUM evaluation protocol).

    Returns (idx_a, idx_b) integer arrays of matched pairs: for each a,
    the closest b within ``max_dt`` seconds, each b used at most once.
    """
    import numpy as np

    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    order = np.argsort(ts_b)
    tb = ts_b[order]
    ia, ib = [], []
    used = set()
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(tb, t))
        best, best_dt = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(tb) and jj not in used:
                dt = abs(tb[jj] - t)
                if dt <= best_dt:
                    best, best_dt = jj, dt
        if best >= 0:
            used.add(best)
            ia.append(i)
            ib.append(int(order[best]))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
