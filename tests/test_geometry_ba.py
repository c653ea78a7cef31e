"""Tests for multi-view geometry + bundle adjustment (north-star stages)."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.ba import (
    BAState,
    Observations,
    bundle_adjust,
    bundle_adjust_lm,
    resolve_solver,
    robust_cost,
    rms_error,
)
from sift_parallel_optimization.models.geometry import (
    Camera,
    decompose_essential,
    essential_from_fundamental,
    pnp_dlt,
    project,
    recover_pose,
    reprojection_error,
    rodrigues,
    rotation_log,
    triangulate,
)

K = jnp.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])


def _rand_rvec(rng, scale=0.5):
    return jnp.asarray(rng.normal(size=3).astype(np.float32) * scale)


class TestRotations:
    def test_rodrigues_orthonormal(self, rng):
        for _ in range(5):
            R = rodrigues(_rand_rvec(rng, 1.0))
            np.testing.assert_allclose(
                np.asarray(R @ R.T), np.eye(3), atol=1e-5
            )
            assert abs(float(jnp.linalg.det(R)) - 1) < 1e-5

    def test_log_exp_roundtrip(self, rng):
        for _ in range(5):
            w = _rand_rvec(rng, 0.8)
            w2 = rotation_log(rodrigues(w))
            np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)

    def test_zero_rotation(self):
        np.testing.assert_allclose(
            np.asarray(rodrigues(jnp.zeros(3))), np.eye(3), atol=1e-7
        )


def _scene(rng, n_pts=64):
    pts = rng.uniform(-1, 1, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    return jnp.asarray(pts)


class TestTriangulation:
    def test_project_triangulate_roundtrip(self, rng):
        pts = _scene(rng)
        r1, t1 = jnp.zeros(3), jnp.zeros(3)
        r2 = jnp.asarray([0.02, 0.3, 0.01])
        t2 = jnp.asarray([-0.8, 0.05, 0.1])
        p1, _ = project(pts, r1, t1, K)
        p2, _ = project(pts, r2, t2, K)
        P1 = Camera(r1, t1).matrix(K)
        P2 = Camera(r2, t2).matrix(K)
        X = triangulate(P1, P2, p1, p2)
        np.testing.assert_allclose(np.asarray(X), np.asarray(pts), atol=1e-2)


class TestPoseRecovery:
    def test_recover_pose_from_essential(self, rng):
        pts = _scene(rng, 96)
        th = 0.2
        R_true = rodrigues(jnp.asarray([0.0, th, 0.0]))
        t_true = jnp.asarray([-1.0, 0.1, 0.05])
        t_unit = t_true / jnp.linalg.norm(t_true)
        # E = [t]x R
        tx = jnp.array([
            [0, -t_unit[2], t_unit[1]],
            [t_unit[2], 0, -t_unit[0]],
            [-t_unit[1], t_unit[0], 0],
        ])
        E = tx @ R_true
        p1, _ = project(pts, jnp.zeros(3), jnp.zeros(3), K)
        p2, _ = project(pts, rotation_log(R_true), t_true, K)
        R, t, X, front = recover_pose(E, p1, p2, K, jnp.ones(96, bool))
        np.testing.assert_allclose(np.asarray(R), np.asarray(R_true), atol=1e-3)
        # t recovered up to scale (unit norm).
        np.testing.assert_allclose(
            np.asarray(t / jnp.linalg.norm(t)), np.asarray(t_unit), atol=1e-3
        )
        assert int(front.sum()) >= 90

    def test_essential_from_fundamental_roundtrip(self, rng):
        # F = K^-T E K^-1; essential_from_fundamental inverts that.
        t = jnp.asarray([0.3, -0.2, 0.1])
        tx = jnp.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ rodrigues(jnp.asarray([0.1, 0.05, -0.2]))
        Kinv = jnp.linalg.inv(K)
        F = Kinv.T @ E @ Kinv
        E2 = essential_from_fundamental(F, K)
        np.testing.assert_allclose(np.asarray(E2), np.asarray(E), atol=1e-4)


class TestPnP:
    def test_pnp_recovers_pose(self, rng):
        pts = _scene(rng, 48)
        rvec = jnp.asarray([0.1, -0.2, 0.05])
        tvec = jnp.asarray([0.3, -0.1, 0.4])
        uv, _ = project(pts, rvec, tvec, K)
        cam = pnp_dlt(pts, uv, K, jnp.ones(48))
        err = reprojection_error(cam, pts, uv, K)
        assert float(jnp.median(err)) < 0.5

    def test_pnp_weighted_ignores_outliers(self, rng):
        pts = _scene(rng, 48)
        rvec = jnp.asarray([0.1, -0.2, 0.05])
        tvec = jnp.asarray([0.3, -0.1, 0.4])
        uv, _ = project(pts, rvec, tvec, K)
        uv_bad = uv.at[:8].add(rng.uniform(40, 80, (8, 2)).astype(np.float32))
        w = jnp.asarray([0.0] * 8 + [1.0] * 40)
        cam = pnp_dlt(pts, uv_bad, K, w)
        err = reprojection_error(cam, pts, uv, K)
        assert float(jnp.median(err[8:])) < 0.5


def _ba_scene(rng, n_cams=6, n_pts=60):
    """Cameras on an arc, all observing all points."""
    pts = _scene(rng, n_pts)
    rvecs, tvecs = [], []
    for i in range(n_cams):
        ang = 0.08 * (i - n_cams / 2)
        rvecs.append([0.0, ang, 0.0])
        tvecs.append([0.4 * (i - n_cams / 2), 0.0, 0.0])
    rvecs = jnp.asarray(rvecs, dtype=jnp.float32)
    tvecs = jnp.asarray(tvecs, dtype=jnp.float32)
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


class TestBundleAdjustment:
    def test_ba_converges_from_perturbation(self, rng):
        gt, obs = _ba_scene(rng)
        noisy = BAState(
            rvecs=gt.rvecs + 0.01 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs + 0.03 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points + 0.05 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        e0 = float(rms_error(noisy, obs, K))
        out = bundle_adjust(noisy, obs, K, n_iters=15, damping=1e-4)
        e1 = float(rms_error(out, obs, K))
        assert e0 > 1.0
        assert e1 < 0.05, f"BA did not converge: {e0} -> {e1}"

    def test_ba_with_huber_survives_outliers(self, rng):
        gt, obs = _ba_scene(rng)
        uv_bad = obs.uv.at[::17].add(60.0)
        obs_bad = obs._replace(uv=uv_bad)
        noisy = BAState(
            rvecs=gt.rvecs + 0.005 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs + 0.02 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points + 0.03 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        out = bundle_adjust(
            noisy, obs_bad, K, n_iters=15, damping=1e-4, huber_delta=2.0
        )
        # Error on CLEAN observations must still be small.
        e = float(rms_error(out, obs, K))
        assert e < 1.0, f"robust BA failed: {e}"

    def test_ba_jits(self, rng):
        gt, obs = _ba_scene(rng, n_cams=3, n_pts=20)
        fn = jax.jit(lambda s: bundle_adjust(s, obs, K, n_iters=2))
        out = fn(gt)
        assert float(rms_error(out, obs, K)) < 0.1


class TestSolverResolution:
    def test_auto_picks_dense_for_small_scenes(self):
        assert resolve_solver(6, 60, "auto") == "dense"
        assert resolve_solver(8, 1024, "auto") == "dense"

    def test_auto_picks_cg_for_large_scenes(self):
        assert resolve_solver(50, 6400, "auto") == "cg"
        assert resolve_solver(200, 4000, "auto") == "cg"

    def test_explicit_choice_passes_through(self):
        assert resolve_solver(2, 2, "cg") == "cg"
        assert resolve_solver(1000, 1000, "dense") == "dense"

    def test_bundle_adjust_accepts_auto(self, rng):
        gt, obs = _ba_scene(rng, n_cams=3, n_pts=20)
        out = bundle_adjust(gt, obs, K, n_iters=2, solver="auto")
        assert float(rms_error(out, obs, K)) < 0.1


class TestAdaptiveLM:
    """Levenberg-Marquardt accept/reject (the config-4/5 robustness gap:
    fixed-lambda GN diverges from poor PnP initializations)."""

    def _bad_init(self, gt, seed=3):
        # Seed found by sweep: fixed-lambda GN (damping=1e-4) stalls at
        # rms ~277 px from this initialization while LM converges.
        r2 = np.random.default_rng(seed)
        return BAState(
            rvecs=gt.rvecs
            + 0.3 * r2.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs
            + 0.6 * r2.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points
            + 0.3 * r2.normal(size=gt.points.shape).astype(np.float32),
        )

    def test_lm_converges_where_fixed_lambda_gn_fails(self, rng):
        gt, obs = _ba_scene(rng)
        noisy = self._bad_init(gt)
        gn = bundle_adjust(noisy, obs, K, n_iters=30, damping=1e-4)
        lm = bundle_adjust_lm(
            noisy, obs, K, max_iters=60, lambda_init=1e-2
        )
        e_gn = float(rms_error(gn, obs, K))
        e_lm = float(rms_error(lm, obs, K))
        assert e_gn > 1.0, f"GN unexpectedly converged: {e_gn}"
        assert e_lm < 1e-3, f"LM failed to converge: {e_lm}"

    def test_lm_never_increases_cost(self, rng):
        gt, obs = _ba_scene(rng)
        noisy = self._bad_init(gt, seed=26)  # GN explodes to ~1e8 here
        c0 = float(robust_cost(noisy, obs, K))
        out = bundle_adjust_lm(noisy, obs, K, max_iters=20)
        c1 = float(robust_cost(out, obs, K))
        assert np.isfinite(c1) and c1 <= c0

    def test_lm_matches_gn_on_easy_scene(self, rng):
        gt, obs = _ba_scene(rng)
        noisy = BAState(
            rvecs=gt.rvecs
            + 0.01 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs
            + 0.03 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points
            + 0.05 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        lm = bundle_adjust_lm(noisy, obs, K, max_iters=15)
        assert float(rms_error(lm, obs, K)) < 0.05

    def test_lm_jits_with_cg_solver(self, rng):
        gt, obs = _ba_scene(rng, n_cams=5, n_pts=40)
        noisy = gt._replace(points=gt.points + 0.05)
        fn = jax.jit(
            lambda s: bundle_adjust_lm(s, obs, K, max_iters=8, solver="cg")
        )
        assert float(rms_error(fn(noisy), obs, K)) < 0.05


class TestImplicitSchurCG:
    """The scalable BA path: analytic Jacobians + implicit-Schur CG."""

    def test_analytic_jacobians_match_jacfwd(self, rng):
        from sift_parallel_optimization.models.ba import (
            _analytic_jacobians,
            _obs_jacobians,
        )

        gt, obs = _ba_scene(rng, n_cams=5, n_pts=40)
        # Hit the small-angle branch too.
        gt = gt._replace(rvecs=gt.rvecs.at[0].set(0.0))
        obs = obs._replace(valid=obs.valid.at[::7].set(False))
        jc1, jp1, r1 = _obs_jacobians(gt, obs, K)
        jc2, jp2, r2 = _analytic_jacobians(gt, obs, K)
        for a, b in ((jc1, jc2), (jp1, jp2), (r1, r2)):
            scale = float(jnp.max(jnp.abs(a))) + 1.0
            assert float(jnp.max(jnp.abs(a - b))) < 1e-5 * scale

    def test_cg_matches_dense_solver(self, rng):
        gt, obs = _ba_scene(rng)
        noisy = BAState(
            rvecs=gt.rvecs
            + 0.01 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs
            + 0.03 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points
            + 0.05 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        dense = bundle_adjust(noisy, obs, K, n_iters=10, damping=1e-4)
        cg = bundle_adjust(
            noisy, obs, K, n_iters=10, damping=1e-4, solver="cg"
        )
        e_dense = float(rms_error(dense, obs, K))
        e_cg = float(rms_error(cg, obs, K))
        assert e_cg < max(2.0 * e_dense, 0.01), (e_dense, e_cg)

    def test_cg_huber_survives_outliers(self, rng):
        gt, obs = _ba_scene(rng)
        obs_bad = obs._replace(uv=obs.uv.at[::17].add(60.0))
        noisy = BAState(
            rvecs=gt.rvecs
            + 0.005 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs
            + 0.02 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points
            + 0.03 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        out = bundle_adjust(
            noisy, obs_bad, K, n_iters=15, damping=1e-4,
            huber_delta=2.0, solver="cg",
        )
        assert float(rms_error(out, obs, K)) < 1.0

    def test_large_scene_runs_without_dense_cross_block(self, rng):
        """200 cams x 4000 pts: dense W would be 200*4000*18 floats; the
        implicit path runs it in O(M) memory."""
        n_cams, n_pts, n_obs = 200, 4000, 40_000
        pts = jnp.asarray(
            (rng.normal(0, 1.0, (n_pts, 3)) + [0, 0, 8]).astype(np.float32)
        )
        rvecs = jnp.asarray(
            [[0.0, 0.005 * (i - n_cams / 2), 0.0] for i in range(n_cams)],
            jnp.float32,
        )
        tvecs = jnp.asarray(
            [[0.05 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)],
            jnp.float32,
        )
        cam_idx = jnp.asarray(
            rng.integers(0, n_cams, n_obs).astype(np.int32)
        )
        pt_idx = jnp.asarray(rng.integers(0, n_pts, n_obs).astype(np.int32))
        uv = jax.vmap(
            lambda c, p: project(pts[p][None], rvecs[c], tvecs[c], K)[0][0]
        )(cam_idx, pt_idx)
        obs = Observations(
            cam_idx=cam_idx, pt_idx=pt_idx, uv=uv,
            valid=jnp.ones(n_obs, bool),
        )
        gt = BAState(rvecs=rvecs, tvecs=tvecs, points=pts)
        noisy = BAState(
            rvecs=gt.rvecs
            + 0.002 * rng.normal(size=gt.rvecs.shape).astype(np.float32),
            tvecs=gt.tvecs
            + 0.01 * rng.normal(size=gt.tvecs.shape).astype(np.float32),
            points=gt.points
            + 0.02 * rng.normal(size=gt.points.shape).astype(np.float32),
        )
        e0 = float(rms_error(noisy, obs, K))
        out = bundle_adjust(
            noisy, obs, K, n_iters=4, damping=1e-4, solver="cg"
        )
        e1 = float(rms_error(out, obs, K))
        assert e1 < 0.2 * e0, (e0, e1)
