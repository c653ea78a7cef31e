"""Checkpoint/resume tests (orbax-backed pytree persistence)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.sfm import empty_map
from sift_parallel_optimization.utils import checkpoint as ckpt


def test_roundtrip_pytree(tmp_path, rng):
    m = empty_map(4, 16)
    m = m._replace(
        points=jnp.asarray(rng.normal(size=m.points.shape).astype(np.float32)),
        pt_valid=m.pt_valid.at[:5].set(True),
    )
    ckpt.save_pytree(tmp_path / "ck", m, step=3)
    assert ckpt.latest_step(tmp_path / "ck") == 3
    m2, step = ckpt.load_pytree(tmp_path / "ck", empty_map(4, 16))
    assert step == 3
    np.testing.assert_array_equal(np.asarray(m2.points), np.asarray(m.points))
    np.testing.assert_array_equal(
        np.asarray(m2.pt_valid), np.asarray(m.pt_valid)
    )


def test_latest_step_selection(tmp_path):
    m = empty_map(2, 4)
    ckpt.save_pytree(tmp_path / "ck", m, step=2)
    ckpt.save_pytree(tmp_path / "ck", m, step=7)
    assert ckpt.latest_step(tmp_path / "ck") == 7
    assert ckpt.latest_step(tmp_path / "nope") is None


def test_sfm_resume(tmp_path, rng):
    """run_sfm resumes from the checkpoint and matches an uninterrupted run."""
    import sys

    sys.path.insert(0, "tests")
    from test_sfm import K, _make_features, _trajectory

    n_frames, n_pts = 6, 120
    pts = rng.uniform(-3, 3, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(6, 12, size=n_pts)
    pts = jnp.asarray(pts)
    descs = rng.normal(size=(n_pts, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    rvecs, tvecs = _trajectory(n_frames)
    feats = [
        _make_features(rng, pts, descs, rvecs[i], tvecs[i], 160)
        for i in range(n_frames)
    ]
    from sift_parallel_optimization.models.sfm import run_sfm

    d = str(tmp_path / "sfm_ck")
    full = run_sfm(
        jax.random.key(0), feats, K, pts_per_frame=64,
        checkpoint_dir=d, checkpoint_every=2,
    )
    # Simulate a crash-resume: latest checkpoint exists; rerun resumes
    # (frames before the checkpoint are not re-registered).
    resumed = run_sfm(
        jax.random.key(0), feats, K, pts_per_frame=64,
        checkpoint_dir=d, checkpoint_every=2,
    )
    assert int(resumed.cam_valid.sum()) == n_frames
    np.testing.assert_allclose(
        np.asarray(resumed.tvecs), np.asarray(full.tvecs), atol=1e-3
    )
