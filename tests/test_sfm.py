"""Incremental SfM integration tests (geometry-level, synthetic features).

The ATE gate of BASELINE.json config 4: a synthetic trajectory must be
recovered within bound after Sim(3) alignment (monocular scale is free).
Features are synthesized (unique descriptors per landmark + noise) so the
test isolates matching/PnP/triangulation/BA from the image frontend, which
has its own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.frontend import Features
from sift_parallel_optimization.models.geometry import project, rodrigues
from sift_parallel_optimization.models.keypoints import Keypoints
from sift_parallel_optimization.models.sfm import run_sfm
from sift_parallel_optimization.models.ba import rms_error
from sift_parallel_optimization.utils.trajectory import (
    ate_rmse,
    camera_centers,
    umeyama_alignment,
)

K = jnp.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]])
W, H = 400, 300


def _make_features(rng, pts, descs, rvec, tvec, capacity, px_noise=0.2):
    uv, z = project(pts, rvec, tvec, K)
    uv = uv + rng.normal(size=uv.shape).astype(np.float32) * px_noise
    vis = (
        (z > 0.5)
        & (uv[:, 0] > 5) & (uv[:, 0] < W - 5)
        & (uv[:, 1] > 5) & (uv[:, 1] < H - 5)
    )
    n = pts.shape[0]
    assert capacity >= n
    pad = capacity - n
    d = descs + rng.normal(size=descs.shape).astype(np.float32) * 0.03
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    kp = Keypoints(
        x=jnp.pad(uv[:, 0], (0, pad)),
        y=jnp.pad(uv[:, 1], (0, pad)),
        sigma=jnp.pad(jnp.full(n, 2.0), (0, pad)),
        score=jnp.pad(jnp.full(n, 1.0), (0, pad)),
        orientation=jnp.zeros(capacity),
        octave=jnp.zeros(capacity, jnp.int32),
        scale=jnp.ones(capacity, jnp.int32),
        valid=jnp.pad(vis, (0, pad)),
    )
    return Features(
        keypoints=kp,
        descriptors=jnp.pad(jnp.asarray(d), ((0, pad), (0, 0))),
    )


def _trajectory(n_frames):
    rvecs, tvecs = [], []
    for i in range(n_frames):
        ang = 0.05 * i
        rvecs.append([0.0, ang, 0.0])
        tvecs.append([-0.35 * i, 0.02 * i, 0.05 * i])
    return (
        jnp.asarray(rvecs, dtype=jnp.float32),
        jnp.asarray(tvecs, dtype=jnp.float32),
    )


class TestUmeyama:
    def test_recovers_similarity(self, rng):
        src = jnp.asarray(rng.normal(size=(30, 3)).astype(np.float32))
        R = rodrigues(jnp.asarray([0.3, -0.2, 0.5]))
        s_true, t_true = 1.7, jnp.asarray([1.0, -2.0, 0.5])
        dst = s_true * src @ R.T + t_true
        s, R2, t = umeyama_alignment(src, dst)
        assert abs(float(s) - s_true) < 1e-3
        np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-4)
        assert float(ate_rmse(src, dst)) < 1e-3


class TestIncrementalSfm:
    @pytest.mark.slow
    def test_trajectory_ate(self, rng):
        n_frames, n_pts = 8, 200
        pts = rng.uniform(-3, 3, size=(n_pts, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(6, 12, size=n_pts)
        pts = jnp.asarray(pts)
        descs = rng.normal(size=(n_pts, 128)).astype(np.float32)
        descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
        rvecs, tvecs = _trajectory(n_frames)
        feats = [
            _make_features(rng, pts, descs, rvecs[i], tvecs[i], 256)
            for i in range(n_frames)
        ]
        m = run_sfm(jax.random.key(0), feats, K, pts_per_frame=128)
        assert int(m.cam_valid.sum()) == n_frames
        assert int(m.obs.valid.sum()) > n_frames * 50
        # Reprojection quality.
        assert float(rms_error(m.ba_state(), m.obs, K)) < 1.0
        # ATE after Sim(3) alignment (monocular scale free).
        est = camera_centers(m.rvecs, m.tvecs)
        gt = camera_centers(rvecs, tvecs)
        ate = float(ate_rmse(est, gt))
        # Trajectory spans ~2.5 units; demand centimeter-level ATE.
        assert ate < 0.05, f"ATE {ate}"
