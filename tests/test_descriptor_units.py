"""Unit-level properties of the descriptor machinery + scale invariance."""

import jax
import jax.numpy as jnp
import numpy as np

import sift_parallel_optimization.models.descriptor as D
from sift_parallel_optimization.models.detect import detect_pyramid
from sift_parallel_optimization.models.frontend import sift_config
from sift_parallel_optimization.core.pyramid_ref import sift_dog_pyramid


def test_resample_matches_bilinear_reference(rng):
    """The separable hat-weight matmul resampler == direct bilinear."""
    k, g = 4, 7
    patches = jnp.asarray(
        rng.random((k, D.PATCH_ROWS, D.PATCH_COLS)).astype(np.float32)
    )
    py = jnp.asarray(rng.uniform(52, 56, k).astype(np.float32))
    px = jnp.asarray(rng.uniform(53, 60, k).astype(np.float32))
    offsets = jnp.asarray(
        rng.uniform(-40, 40, (k, g)).astype(np.float32)
    )
    out = np.asarray(D._resample(patches, py, px, offsets))

    pn = np.asarray(patches)
    for kk in range(k):
        for i in range(g):
            for j in range(g):
                cy = float(py[kk] + offsets[kk, i])
                cx = float(px[kk] + offsets[kk, j])
                y0, x0 = int(np.floor(cy)), int(np.floor(cx))
                fy, fx = cy - y0, cx - x0
                ref = (
                    pn[kk, y0, x0] * (1 - fy) * (1 - fx)
                    + pn[kk, y0 + 1, x0] * fy * (1 - fx)
                    + pn[kk, y0, x0 + 1] * (1 - fy) * fx
                    + pn[kk, y0 + 1, x0 + 1] * fy * fx
                )
                assert abs(out[kk, i, j] - ref) < 1e-4


def test_detection_scale_invariance(rng):
    """A blob rendered at 2x size in a 2x image doubles its sigma."""
    def detect_blob(size, blob_sigma):
        y, x = np.mgrid[0:size, 0:size].astype(np.float32)
        img = np.full((size, size), 0.5, np.float32)
        c = size / 2
        img -= 0.4 * np.exp(-((y - c) ** 2 + (x - c) ** 2) / (2 * blob_sigma**2))
        cfg = sift_config(size)
        kp = detect_pyramid(
            sift_dog_pyramid(jnp.asarray(img), cfg), cfg, max_keypoints=16
        )
        kp = jax.tree.map(np.asarray, kp)
        best = np.argmax(kp.score)
        assert kp.valid[best]
        return float(kp.sigma[best]), float(kp.x[best]), float(kp.y[best])

    s1, x1, y1 = detect_blob(128, 4.0)
    s2, x2, y2 = detect_blob(256, 8.0)
    # Sigma scales with the blob; position stays centered.
    assert abs(s2 / s1 - 2.0) < 0.35, (s1, s2)
    assert abs(x1 - 64) < 1.5 and abs(x2 - 128) < 1.5


def test_dual_orientation_duplicates(rng):
    """Lowe 80% mode doubles capacity; duplicates share position/sigma and
    carry a different orientation with a unit-norm descriptor."""
    from sift_parallel_optimization.models.frontend import (
        extract_features,
    )

    size = 128
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), 0.5, np.float32)
    for _ in range(15):
        cy, cx = rng.uniform(12, size - 12, 2)
        s = rng.uniform(2, 5)
        img += rng.uniform(-0.4, 0.4) * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s)
        )
    img += 0.1 * (rng.random((size, size), np.float32) - 0.5)
    cfg = sift_config(size)
    k = 64
    f = extract_features(jnp.asarray(img), cfg, max_keypoints=k,
                         dual_orientation=True)
    kp = jax.tree.map(np.asarray, f.keypoints)
    assert kp.x.shape[0] == 2 * k
    d = np.asarray(f.descriptors)
    assert d.shape[0] == 2 * k
    prim, sec = kp.valid[:k], kp.valid[k:]
    assert prim.sum() >= 4
    # Secondary slots are a subset of primaries and share position/sigma.
    assert np.all(sec <= prim)
    np.testing.assert_array_equal(kp.x[k:][sec], kp.x[:k][sec])
    np.testing.assert_array_equal(kp.sigma[k:][sec], kp.sigma[:k][sec])
    if sec.sum():
        # Orientations differ (bins are >= 2 apart) and descriptors are
        # unit-norm.
        do = np.abs(kp.orientation[k:][sec] - kp.orientation[:k][sec])
        do = np.minimum(do, 2 * np.pi - do)
        assert (do > 0.15).all()
        norms = np.linalg.norm(d[k:][sec], axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    # Primary half must be identical to the single-orientation run.
    f1 = extract_features(jnp.asarray(img), cfg, max_keypoints=k)
    np.testing.assert_allclose(
        np.asarray(f1.descriptors), d[:k], atol=1e-6
    )
