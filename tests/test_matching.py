"""Tests for on-device matching + RANSAC (no analogue in the reference)."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.matching import (
    match_descriptors,
    matched_points,
    ransac_fundamental,
    ransac_homography,
    _apply_h,
    _epipolar_dist_sq,
)
from sift_parallel_optimization.models.frontend import (
    extract_features,
    sift_config,
)


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class TestMatchDescriptors:
    def test_known_correspondence(self, rng):
        base = _unit(rng, 32)
        noise = rng.normal(size=base.shape).astype(np.float32) * 0.05
        d2 = base + noise
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
        perm = rng.permutation(32)
        m = match_descriptors(
            jnp.asarray(base), jnp.asarray(d2[perm]),
            jnp.ones(32, bool), jnp.ones(32, bool),
        )
        m = jax.tree.map(np.asarray, m)
        inv = np.argsort(perm)
        assert m.valid.sum() >= 28
        assert (m.idx2[m.valid] == inv[m.valid]).all()

    def test_ratio_test_rejects_ambiguous(self, rng):
        # Two near-identical database entries -> ratio test must reject.
        q = _unit(rng, 1)
        db = np.concatenate([q + 0.01, q + 0.011, _unit(rng, 6)], axis=0)
        db /= np.linalg.norm(db, axis=-1, keepdims=True)
        m = match_descriptors(
            jnp.asarray(q), jnp.asarray(db.astype(np.float32)),
            jnp.ones(1, bool), jnp.ones(8, bool), mutual=False,
        )
        assert not bool(m.valid[0])

    def test_invalid_masked_out(self, rng):
        d = _unit(rng, 8)
        v1 = jnp.asarray([True] * 4 + [False] * 4)
        m = match_descriptors(jnp.asarray(d), jnp.asarray(d), v1,
                              jnp.ones(8, bool))
        assert not np.asarray(m.valid)[4:].any()
        assert np.asarray(m.valid)[:4].all()


class TestRansacHomography:
    def test_recovers_affine_under_outliers(self, rng):
        n = 128
        p1 = rng.uniform(0, 256, size=(n, 2)).astype(np.float32)
        h_true = np.array(
            [[0.9, 0.1, 5.0], [-0.08, 1.05, -3.0], [1e-4, -5e-5, 1.0]],
            np.float32,
        )
        p2 = np.array(_apply_h(jnp.asarray(h_true), jnp.asarray(p1)))
        # 30% outliers.
        n_out = n * 3 // 10
        p2[:n_out] = rng.uniform(0, 256, size=(n_out, 2))
        res = ransac_homography(
            jax.random.key(0), jnp.asarray(p1), jnp.asarray(p2),
            jnp.ones(n, bool), n_hypotheses=512,
        )
        assert int(res.n_inliers) >= n - n_out - 5
        inl = np.asarray(res.inliers)
        assert inl[n_out:].sum() >= (n - n_out) - 5
        # Model reprojects inliers well.
        proj = np.asarray(_apply_h(res.model, jnp.asarray(p1)))
        err = np.linalg.norm(proj - p2, axis=-1)
        assert np.median(err[inl]) < 1.5

    def test_jittable(self, rng):
        n = 64
        p1 = jnp.asarray(rng.uniform(0, 100, (n, 2)).astype(np.float32))
        p2 = p1 + 3.0
        fn = jax.jit(lambda k, a, b, m: ransac_homography(k, a, b, m, 64))
        res = fn(jax.random.key(1), p1, p2, jnp.ones(n, bool))
        assert int(res.n_inliers) == n


class TestRansacFundamental:
    def test_epipolar_recovery(self, rng):
        n = 128
        # Two cameras: identity and a translated+rotated one.
        pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        pts[:, 2] += 4.0
        K = np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]], np.float32)
        th = 0.15
        R = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
            np.float32,
        )
        t = np.array([0.5, 0.05, 0.0], np.float32)
        x1 = pts @ K.T
        p1 = np.array(x1[:, :2] / x1[:, 2:], dtype=np.float32)
        x2 = (pts @ R.T + t) @ K.T
        p2 = np.array(x2[:, :2] / x2[:, 2:], dtype=np.float32)
        n_out = 24
        p2[:n_out] = rng.uniform(0, 256, size=(n_out, 2))
        res = ransac_fundamental(
            jax.random.key(0), jnp.asarray(p1), jnp.asarray(p2),
            jnp.ones(n, bool), n_hypotheses=512, threshold=1.0,
        )
        assert int(res.n_inliers) >= (n - n_out) * 3 // 4
        # True correspondences satisfy the epipolar constraint under model.
        d = np.asarray(
            _epipolar_dist_sq(res.model, jnp.asarray(p1), jnp.asarray(p2))
        )
        assert np.median(np.sqrt(d[n_out:])) < 1.0


    def test_clustered_points_far_from_origin(self, rng):
        """Per-sample Hartley normalization conditions minimal samples
        drawn from a tight cluster far from the pixel origin (the raw
        8-point DLT is numerically hopeless there)."""
        n = 96
        pts = rng.uniform(-0.15, 0.15, size=(n, 3)).astype(np.float32)
        pts[:, 2] += 6.0
        K = np.array(
            [[1200.0, 0, 1800], [0, 1200.0, 1400], [0, 0, 1]], np.float32
        )
        th = 0.1
        R = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
             [-np.sin(th), 0, np.cos(th)]],
            np.float32,
        )
        t = np.array([0.4, 0.02, 0.0], np.float32)
        x1 = pts @ K.T
        p1 = np.array(x1[:, :2] / x1[:, 2:], dtype=np.float32)
        x2 = (pts @ R.T + t) @ K.T
        p2 = np.array(x2[:, :2] / x2[:, 2:], dtype=np.float32)
        # Cluster spans ~60 px around (1800, 1400): every minimal sample
        # is "degenerate clustered" in raw pixel coordinates.
        res = ransac_fundamental(
            jax.random.key(1), jnp.asarray(p1), jnp.asarray(p2),
            jnp.ones(n, bool), n_hypotheses=512, threshold=1.0,
        )
        assert int(res.n_inliers) >= n * 3 // 4, int(res.n_inliers)


class TestEndToEndPair:
    def test_translated_texture_pair(self, rng):
        size = 128
        cfg = sift_config(size)
        # Field of random blobs: dense, distinctive, scale-varied features.
        full = size + 16
        y, x = np.mgrid[0:full, 0:full].astype(np.float32)
        big = np.full((full, full), 0.5, np.float32)
        for _ in range(40):
            cy, cx = rng.uniform(8, full - 8, 2)
            s = rng.uniform(2.0, 6.0)
            a = rng.uniform(-0.4, 0.4)
            big += a * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
        # Overlay band-limited noise so features are DISTINCTIVE (pure
        # blobs are mutually ambiguous and the ratio test rightly rejects
        # them).
        from jax.scipy.signal import convolve2d
        noise = rng.random((full, full)).astype(np.float32)
        k = np.ones((3, 3), np.float32) / 9
        noise = np.asarray(convolve2d(jnp.asarray(noise), jnp.asarray(k), "same"))
        big += 0.3 * (noise - noise.mean())
        img1 = jnp.asarray(big[:size, :size])
        img2 = jnp.asarray(big[8:8 + size, 8:8 + size])  # shift by (-8, -8)
        f1 = extract_features(img1, cfg, max_keypoints=256)
        f2 = extract_features(img2, cfg, max_keypoints=256)
        m = match_descriptors(
            f1.descriptors, f2.descriptors,
            f1.keypoints.valid, f2.keypoints.valid,
        )
        p1, p2, mask = matched_points(f1.keypoints, f2.keypoints, m)
        assert int(mask.sum()) >= 10
        res = ransac_homography(
            jax.random.key(0), p1, p2, mask, n_hypotheses=256, threshold=1.5
        )
        assert int(res.n_inliers) >= int(mask.sum()) * 2 // 3
        # Homography ~ pure translation by (-8, -8).
        h = np.asarray(res.model)
        h = h / h[2, 2]
        assert abs(h[0, 2] + 8) < 1.0 and abs(h[1, 2] + 8) < 1.0
        assert abs(h[0, 0] - 1) < 0.05 and abs(h[1, 1] - 1) < 0.05
