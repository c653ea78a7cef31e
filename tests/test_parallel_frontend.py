"""Sharded batched frontend equivalence on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.models.frontend import (
    extract_features,
    sift_config,
)
from sift_parallel_optimization.parallel.frontend import (
    batched_extract_features,
)
from sift_parallel_optimization.parallel.mesh import make_mesh


def _frames(rng, b, size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for i in range(b):
        img = np.full((size, size), 0.5, np.float32)
        fr = np.random.default_rng(i)
        for _ in range(12):
            cy, cx = fr.uniform(10, size - 10, 2)
            s = fr.uniform(2, 5)
            img += fr.uniform(-0.4, 0.4) * np.exp(
                -((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s)
            )
        img += 0.1 * (fr.random((size, size), np.float32) - 0.5)
        out.append(img)
    return jnp.asarray(np.stack(out))


def test_sharded_batch_matches_per_frame(rng):
    size, b = 64, 8
    cfg = sift_config(size)
    frames = _frames(rng, b, size)
    mesh = make_mesh(n_data=8, n_spatial=1)
    fn = jax.jit(
        lambda x: batched_extract_features(x, cfg, max_keypoints=64, mesh=mesh)
    )
    out = fn(frames)
    for i in range(b):
        ref = extract_features(frames[i], cfg, max_keypoints=64)
        # Slot ORDER may differ (top-k tie-breaking changes under vmap);
        # compare the keypoint SETS by coordinates.
        rv = np.asarray(ref.keypoints.valid)
        bv = np.asarray(out.keypoints.valid[i])
        assert rv.sum() == bv.sum()
        bx = np.asarray(out.keypoints.x[i])[bv]
        by = np.asarray(out.keypoints.y[i])[bv]
        bs = np.asarray(out.keypoints.sigma[i])[bv]
        bo = np.asarray(out.keypoints.orientation[i])[bv]
        bd = np.asarray(out.descriptors[i])[bv]
        exact = 0
        idxs = np.where(rv)[0]
        for j in idxs:
            # Disambiguate same-position scale twins by including sigma.
            d = (
                np.hypot(
                    bx - float(ref.keypoints.x[j]),
                    by - float(ref.keypoints.y[j]),
                )
                + np.abs(bs - float(ref.keypoints.sigma[j]))
            )
            n = int(np.argmin(d))
            assert d[n] < 1e-3, "keypoint missing in sharded batch output"
            do = abs(float(bo[n] - ref.keypoints.orientation[j]))
            do = min(do, 2 * np.pi - do)
            rd = np.asarray(ref.descriptors[j])
            if do < 1e-3:
                np.testing.assert_allclose(bd[n], rd, atol=2e-4)
                exact += 1
            else:
                # Flat-peaked orientation histograms can wobble sub-bin
                # under batched-einsum float reassociation; the descriptor
                # must still describe the same structure.
                assert do < 0.15, f"orientation diverged by {do}"
                assert float(bd[n] @ rd) > 0.9
        # The wobble must be the exception, not the rule.
        assert exact >= int(0.85 * len(idxs))
