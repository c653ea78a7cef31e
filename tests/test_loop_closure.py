"""Loop closure efficacy: an out-and-back (revisit) trajectory under
local-map odometry must see ATE improve by >= 2x when loop closure is on.

The reference has no back end at all (SURVEY.md: it stops at the DoG
pyramid); this gates the north-star loop-closure component
(models/loop_closure.py): place recognition against old landmarks via the
MXU matcher, PnP loop constraints, re-observation writing, PGO re-anchor,
final BA. Measured on this fixture (CPU, deterministic): 2.34% -> 0.45%
of span (5.2x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.frontend import (
    extract_features,
    sift_config,
)
from sift_parallel_optimization.models.sfm import run_sfm
from sift_parallel_optimization.utils import native
from sift_parallel_optimization.utils.trajectory import (
    ate_rmse,
    camera_centers,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native renderer unavailable"
)


@pytest.mark.slow
def test_revisit_loop_closure_halves_ate():
    size, n = 256, 16
    focal = float(size)
    cfg = sift_config(size)
    K = jnp.array(
        [[focal, 0.0, size / 2], [0.0, focal, size / 2], [0.0, 0.0, 1.0]]
    )
    # 8 frames out, 8 back to the start pose: a revisit with enough
    # accumulated odometric drift (local_window=2 registration) for loop
    # closure to have something to correct.
    xs = np.concatenate([np.linspace(0, -1.8, 8), np.linspace(-1.8, 0, 8)])
    yaw = np.concatenate(
        [np.linspace(0, 0.22, 8), np.linspace(0.22, 0, 8)]
    )
    gt_r = np.stack([[0.0, y, 0.0] for y in yaw]).astype(np.float32)
    gt_t = np.stack(
        [[x, 0.0, 0.02 * min(i, n - 1 - i)] for i, x in enumerate(xs)]
    ).astype(np.float32)

    fe = jax.jit(
        lambda x: extract_features(x, cfg, 256, dual_orientation=True)
    )
    feats = [
        fe(jnp.asarray(native.render_frame(size, gt_r[i], gt_t[i], focal,
                                           seed=5)))
        for i in range(n)
    ]
    gt = camera_centers(jnp.asarray(gt_r), jnp.asarray(gt_t))
    span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))

    ates = {}
    for lc in (False, True):
        m = run_sfm(
            jax.random.key(2), feats, K,
            ba_every=0, final_ba_iters=25,
            loop_closure=lc, local_window=2,
            loop_min_gap=6, loop_min_inliers=25,
        )
        assert int(m.cam_valid.sum()) == n
        est = camera_centers(m.rvecs, m.tvecs)
        ates[lc] = float(ate_rmse(est, gt))

    # Loop closure must at least halve the drift, and land under 1% of
    # span in absolute terms.
    assert ates[True] * 2.0 <= ates[False], ates
    assert ates[True] < 0.01 * span, (ates, span)
