"""Distributed BA equivalence tests on the virtual 8-device CPU mesh.

The variant-equivalence discipline the reference never had (SURVEY.md
section 4): the sharded path must reproduce the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.ba import (
    BAState,
    Observations,
    bundle_adjust,
    rms_error,
)
from sift_parallel_optimization.models.geometry import project
from sift_parallel_optimization.parallel.ba import (
    distributed_bundle_adjust,
    pad_observations,
)
from sift_parallel_optimization.parallel.mesh import make_mesh

K = jnp.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])


def _ba_scene(rng, n_cams=5, n_pts=40):
    pts = rng.uniform(-1, 1, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    pts = jnp.asarray(pts)
    rvecs = jnp.asarray(
        [[0.0, 0.08 * (i - n_cams / 2), 0.0] for i in range(n_cams)],
        dtype=jnp.float32,
    )
    tvecs = jnp.asarray(
        [[0.4 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)],
        dtype=jnp.float32,
    )
    cam_idx = jnp.repeat(jnp.arange(n_cams), n_pts)
    pt_idx = jnp.tile(jnp.arange(n_pts), n_cams)
    uv = jnp.concatenate(
        [project(pts, rvecs[i], tvecs[i], K)[0] for i in range(n_cams)]
    )
    obs = Observations(
        cam_idx=cam_idx, pt_idx=pt_idx, uv=uv,
        valid=jnp.ones(n_cams * n_pts, bool),
    )
    return BAState(rvecs=rvecs, tvecs=tvecs, points=pts), obs


def _perturb(rng, gt):
    return BAState(
        rvecs=gt.rvecs + 0.01 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
        tvecs=gt.tvecs + 0.03 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
        points=gt.points + 0.05 * rng.normal(size=gt.points.shape).astype(np.float32),
    )


def test_pad_observations():
    obs = Observations(
        cam_idx=jnp.zeros(10, jnp.int32),
        pt_idx=jnp.zeros(10, jnp.int32),
        uv=jnp.zeros((10, 2)),
        valid=jnp.ones(10, bool),
    )
    padded = pad_observations(obs, 8)
    assert padded.cam_idx.shape[0] == 16
    assert int(padded.valid.sum()) == 10


def test_distributed_matches_single_device(rng):
    gt, obs = _ba_scene(rng)
    noisy = _perturb(rng, gt)
    mesh = make_mesh(n_data=8, n_spatial=1)
    single = bundle_adjust(noisy, obs, K, n_iters=5, damping=1e-4)
    dist = jax.jit(
        lambda s, o: distributed_bundle_adjust(
            s, o, K, mesh, n_iters=5, damping=1e-4
        )
    )(noisy, obs)
    # Same fixed point up to float reduction order.
    np.testing.assert_allclose(
        np.asarray(dist.points), np.asarray(single.points), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(dist.tvecs), np.asarray(single.tvecs), atol=5e-3
    )
    assert float(rms_error(dist, obs, K)) < 0.05


def test_distributed_converges_under_jit(rng):
    gt, obs = _ba_scene(rng, n_cams=4, n_pts=24)
    noisy = _perturb(rng, gt)
    mesh = make_mesh(n_data=4, n_spatial=2)
    fn = jax.jit(
        lambda s, o: distributed_bundle_adjust(
            s, o, K, mesh, n_iters=8, damping=1e-4
        )
    )
    out = fn(noisy, obs)
    assert float(rms_error(out, obs, K)) < 0.05


def test_distributed_cg_matches_single_device(rng):
    """Implicit-Schur CG sharded step == single-device CG (and both reach
    the dense solver's fixed point) — no dense W is formed anywhere."""
    gt, obs = _ba_scene(rng, n_cams=6, n_pts=48)
    noisy = _perturb(rng, gt)
    mesh = make_mesh(n_data=8, n_spatial=1)
    single = bundle_adjust(
        noisy, obs, K, n_iters=6, damping=1e-4, solver="cg"
    )
    dist = jax.jit(
        lambda s, o: distributed_bundle_adjust(
            s, o, K, mesh, n_iters=6, damping=1e-4, solver="cg"
        )
    )(noisy, obs)
    np.testing.assert_allclose(
        np.asarray(dist.points), np.asarray(single.points), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(dist.tvecs), np.asarray(single.tvecs), atol=5e-3
    )
    assert float(rms_error(dist, obs, K)) < 0.05


def test_distributed_cg_point_padding(rng):
    """Point count NOT divisible by the mesh axis still shards correctly."""
    gt, obs = _ba_scene(rng, n_cams=5, n_pts=37)  # 37 % 8 != 0
    noisy = _perturb(rng, gt)
    mesh = make_mesh(n_data=8, n_spatial=1)
    out = jax.jit(
        lambda s, o: distributed_bundle_adjust(
            s, o, K, mesh, n_iters=6, damping=1e-4, solver="cg"
        )
    )(noisy, obs)
    assert float(rms_error(out, obs, K)) < 0.05
