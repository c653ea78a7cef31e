"""Sliding-window odometry: constant-memory long-sequence tracking.

Validates the eviction shift (block relabeling + invalidation), that the
window map's capacities depend only on the window size, and the
end-to-end accuracy of the windowed pipeline on a rendered sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.ba import Observations
from sift_parallel_optimization.models.odometry import (
    archive_evicted_block,
    empty_archive,
    run_odometry,
    shift_window,
)
from sift_parallel_optimization.models.sfm import SfmMap, empty_map


def _toy_map(W=3, B=2):
    """A window map with distinguishable per-slot content."""
    m = empty_map(W, B, max_loops=0)
    C, P, M = W, W * B, 3 * W * B
    obs = Observations(
        cam_idx=jnp.arange(M, dtype=jnp.int32) % C,
        pt_idx=jnp.arange(M, dtype=jnp.int32) % P,
        uv=jnp.arange(2 * M, dtype=jnp.float32).reshape(M, 2),
        valid=jnp.ones(M, bool),
    )
    return SfmMap(
        rvecs=jnp.arange(3 * C, dtype=jnp.float32).reshape(C, 3),
        tvecs=-jnp.arange(3 * C, dtype=jnp.float32).reshape(C, 3),
        cam_valid=jnp.ones(C, bool),
        points=jnp.arange(3 * P, dtype=jnp.float32).reshape(P, 3),
        pt_valid=jnp.ones(P, bool),
        pt_desc=jnp.arange(P, dtype=jnp.float32)[:, None]
        * jnp.ones((P, 128), jnp.float32),
        obs=obs,
    )


def test_harvest_anchors_freezes_evicted_block_observations():
    """Observations of the departing block (pt_idx < B) by surviving
    cameras become fixed-landmark anchors with the landmarks' frozen
    positions and shifted camera indices; old anchors expire with their
    camera; everything stays inside the fixed capacity."""
    from sift_parallel_optimization.models.ba import empty_anchors
    from sift_parallel_optimization.models.odometry import (
        harvest_anchors,
    )

    W, B = 3, 2
    m = _toy_map(W, B)
    # The toy map's modular obs pattern never pairs block-0 points with
    # camera >= 2; craft rows that do (plus decoys that must NOT
    # harvest: evicted cam, non-evicted block, invalid row).
    m = m._replace(obs=Observations(
        cam_idx=jnp.asarray([2, 2, 1, 0, 2, 2], jnp.int32),
        pt_idx=jnp.asarray([0, 1, 0, 1, 3, 0], jnp.int32),
        uv=jnp.arange(12, dtype=jnp.float32).reshape(6, 2),
        valid=jnp.asarray([True, True, True, True, True, False]),
    ))
    anc0 = empty_anchors((W - 1) * B)
    anc = harvest_anchors(m, anc0, B, per_eviction=B)
    anc_np = {
        "cam": np.asarray(anc.cam_idx),
        "xyz": np.asarray(anc.xyz),
        "uv": np.asarray(anc.uv),
        "valid": np.asarray(anc.valid),
    }
    obs = m.obs
    want = {}
    for r in range(obs.valid.shape[0]):
        pt = int(obs.pt_idx[r])
        cam = int(obs.cam_idx[r])
        if pt < B and cam >= 2:
            want[(cam - 1, tuple(np.asarray(obs.uv[r])))] = tuple(
                np.asarray(m.points[pt])
            )
    got = {
        (int(anc_np["cam"][k]), tuple(anc_np["uv"][k])): tuple(
            anc_np["xyz"][k]
        )
        for k in range(anc.valid.shape[0])
        if anc_np["valid"][k]
    }
    # per_eviction=B caps the take; every harvested anchor must be a
    # wanted one, and with capacity >= candidates they match exactly.
    assert got and set(got).issubset(set(want))
    for k in got:
        assert got[k] == want[k]

    # A second harvest: survivors shift their camera again and expire
    # once the camera reaches slot 0 (gauge-fixed — useless row).
    anc2 = harvest_anchors(m, anc, B, per_eviction=B)
    cams2 = np.asarray(anc2.cam_idx)[np.asarray(anc2.valid)]
    assert (cams2 >= 1).all()


def test_anchor_factors_pull_camera_back():
    """BA with anchors only (no live landmarks' worth of signal) must
    correct a perturbed camera against the frozen points."""
    from sift_parallel_optimization.models.ba import (
        Anchors,
        BAState,
        bundle_adjust,
    )
    from sift_parallel_optimization.models.geometry import project

    rng = np.random.default_rng(0)
    K = jnp.array([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]], jnp.float32)
    pts = jnp.asarray(
        rng.uniform(-1, 1, (24, 3)).astype(np.float32) + [0, 0, 6.0]
    )
    rv_true = jnp.asarray([[0.0, 0, 0], [0.02, -0.03, 0.01]], jnp.float32)
    tv_true = jnp.asarray([[0.0, 0, 0], [0.4, -0.2, 0.1]], jnp.float32)
    uv1, _ = project(pts, rv_true[1], tv_true[1], K)
    anchors = Anchors(
        cam_idx=jnp.full(24, 1, jnp.int32),
        xyz=pts,
        uv=uv1,
        valid=jnp.ones(24, bool),
    )
    # Live BA problem: camera 0's own observations keep the normal path
    # exercised; camera 1 is constrained ONLY by anchors.
    uv0, _ = project(pts[:4], rv_true[0], tv_true[0], K)
    obs = Observations(
        cam_idx=jnp.zeros(4, jnp.int32),
        pt_idx=jnp.arange(4, dtype=jnp.int32),
        uv=uv0,
        valid=jnp.ones(4, bool),
    )
    st = BAState(
        rvecs=rv_true.at[1].add(jnp.asarray([0.03, -0.02, 0.01])),
        tvecs=tv_true.at[1].add(jnp.asarray([0.08, -0.05, 0.06])),
        points=pts[:4],
    )
    out = bundle_adjust(
        st, obs, K, n_iters=10, damping=1e-4, solver="dense",
        anchors=anchors,
    )
    err0 = float(jnp.abs(st.tvecs[1] - tv_true[1]).max())
    err1 = float(jnp.abs(out.tvecs[1] - tv_true[1]).max())
    assert err1 < 0.02 * err0, (err0, err1)
    # Without anchors the perturbed camera has no constraints at all.
    out_na = bundle_adjust(
        st, obs, K, n_iters=10, damping=1e-4, solver="dense"
    )
    assert float(jnp.abs(out_na.tvecs[1] - tv_true[1]).max()) > 10 * err1
    # The implicit-Schur CG solver supports anchors too and lands on the
    # same fixed point as the dense solve.
    out_cg = bundle_adjust(
        st, obs, K, n_iters=10, damping=1e-4, solver="cg",
        anchors=anchors,
    )
    np.testing.assert_allclose(
        np.asarray(out_cg.tvecs), np.asarray(out.tvecs), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out_cg.rvecs), np.asarray(out.rvecs), atol=1e-5
    )


def test_coverage_eviction_is_age_stratified():
    """coverage_write_slot must (a) fill empty blocks first in index
    order, (b) recycle a YOUNG block sitting on old coverage rather
    than the old memory itself (the measured failure of pure spatial
    redundancy: refreshing a revisited place wipes its loop-closable
    birth — see the function docstring), (c) never let the incoming
    block displace OLD memory, and (d) evict the younger of a
    co-located old pair."""
    from types import SimpleNamespace

    from sift_parallel_optimization.models.odometry import (
        coverage_write_slot,
        empty_archive,
    )

    B, nb, gap = 3, 4, 5
    centers = np.array(
        [[0, 0, 0], [10, 0, 0], [0, 10, 0], [10, 10, 0]], np.float32
    )

    def block(c):
        return jnp.asarray(c + 0.1 * np.eye(3, dtype=np.float32))

    def write(a, slot, c, birth):
        pos = a.positions.at[slot * B:(slot + 1) * B].set(block(c))
        val = a.valid.at[slot * B:(slot + 1) * B].set(True)
        bth = a.birth.at[slot * B:(slot + 1) * B].set(birth)
        return a._replace(positions=pos, valid=val, birth=bth)

    def slot(a, pts, fi):
        return int(coverage_write_slot(a, pts, fi, gap, B))

    incoming = SimpleNamespace(
        points=block(centers[0]), pt_valid=jnp.ones(B, bool)
    )
    # (a) Fill phase: empty blocks are chosen in index order (== FIFO).
    arch = empty_archive(B * nb)
    for k in range(nb):
        assert slot(arch, incoming, k) == k
        arch = write(arch, k, centers[k], birth=k)
    # (b)+(c) Blocks 0/1 OLD (births 0/1) at regions 0/1; blocks 2/3
    # YOUNG (births 12/13) at region 0 (on old coverage) and region 3.
    # Incoming at region 0, frame 18 (old = birth <= 13... use 16:
    # old = birth <= 11 -> 0/1 old, 2/3 young). The young block 2
    # duplicating OLD block 0's place is the redundant one; old block 0
    # survives with its loop-closable birth.
    arch = empty_archive(B * nb)
    arch = write(arch, 0, centers[0], birth=0)
    arch = write(arch, 1, centers[1], birth=1)
    arch = write(arch, 2, centers[0], birth=12)
    arch = write(arch, 3, centers[3], birth=13)
    assert slot(arch, incoming, 16) == 2
    # Even with block 2 moved to distinct territory, the incoming
    # block near OLD block 0 must not displace it: the eviction falls
    # on a young block (the nearest-to-anything young one), never 0/1.
    arch2 = write(arch, 2, centers[2], birth=12)
    assert slot(arch2, incoming, 16) in (2, 3)
    # (d) Co-located OLD pair (births 3 and 7, region 2): the YOUNGER
    # (birth 7) is evicted, keeping the largest achievable loop gap.
    arch3 = empty_archive(B * nb)
    arch3 = write(arch3, 0, centers[0], birth=0)
    arch3 = write(arch3, 1, centers[2], birth=3)
    arch3 = write(arch3, 2, centers[2], birth=7)
    arch3 = write(arch3, 3, centers[3], birth=2)
    far = SimpleNamespace(
        points=block(np.float32([50, 50, 0])),
        pt_valid=jnp.ones(B, bool),
    )
    assert slot(arch3, far, 30) == 2
    # All-invalid incoming block must not bias the choice (centroid 0
    # would sit on block 0): same co-located-pair eviction.
    empty_in = SimpleNamespace(
        points=jnp.zeros((B, 3), jnp.float32),
        pt_valid=jnp.zeros(B, bool),
    )
    assert slot(arch3, empty_in, 30) == 2


def test_lm_with_anchors_is_anchor_aware():
    """Adaptive LM must linearize AND accept against the anchored
    objective (round-4 ROADMAP item: the accept test previously had no
    anchor path at all). Camera 1 is constrained ONLY by anchors, so an
    anchor-blind LM cannot correct it; robust_cost(anchors=...) is the
    objective the loop must monotonically decrease."""
    from sift_parallel_optimization.models.ba import (
        Anchors,
        BAState,
        bundle_adjust_lm,
        robust_cost,
    )
    from sift_parallel_optimization.models.geometry import project

    rng = np.random.default_rng(0)
    K = jnp.array([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]], jnp.float32)
    pts = jnp.asarray(
        rng.uniform(-1, 1, (24, 3)).astype(np.float32) + [0, 0, 6.0]
    )
    rv_true = jnp.asarray([[0.0, 0, 0], [0.02, -0.03, 0.01]], jnp.float32)
    tv_true = jnp.asarray([[0.0, 0, 0], [0.4, -0.2, 0.1]], jnp.float32)
    uv1, _ = project(pts, rv_true[1], tv_true[1], K)
    anchors = Anchors(
        cam_idx=jnp.full(24, 1, jnp.int32),
        xyz=pts,
        uv=uv1,
        valid=jnp.ones(24, bool),
    )
    uv0, _ = project(pts[:4], rv_true[0], tv_true[0], K)
    obs = Observations(
        cam_idx=jnp.zeros(4, jnp.int32),
        pt_idx=jnp.arange(4, dtype=jnp.int32),
        uv=uv0,
        valid=jnp.ones(4, bool),
    )
    st = BAState(
        rvecs=rv_true.at[1].add(jnp.asarray([0.03, -0.02, 0.01])),
        tvecs=tv_true.at[1].add(jnp.asarray([0.08, -0.05, 0.06])),
        points=pts[:4],
    )
    out = bundle_adjust_lm(
        st, obs, K, max_iters=15, solver="dense", anchors=anchors
    )
    err0 = float(jnp.abs(st.tvecs[1] - tv_true[1]).max())
    err1 = float(jnp.abs(out.tvecs[1] - tv_true[1]).max())
    assert err1 < 0.02 * err0, (err0, err1)
    # The anchored objective decreased (the accept test saw the anchors:
    # obs-only cost here is ~0 throughout, so any decrease is anchor
    # signal).
    c_in = float(robust_cost(st, obs, K, anchors=anchors))
    c_out = float(robust_cost(out, obs, K, anchors=anchors))
    assert c_out < 1e-3 * c_in, (c_in, c_out)
    # Anchor-blind LM sees a ~zero objective (obs-only residuals are
    # consistent), immediately converges, and leaves camera 1 wrong —
    # the discriminating behavior the anchors= path exists to fix.
    out_blind = bundle_adjust_lm(st, obs, K, max_iters=15, solver="dense")
    assert float(jnp.abs(out_blind.tvecs[1] - tv_true[1]).max()) > 10 * err1
    # Huber branch of the anchored objective compiles and decreases too.
    out_h = bundle_adjust_lm(
        st, obs, K, max_iters=15, solver="dense", anchors=anchors,
        huber_delta=4.0,
    )
    ch_in = float(robust_cost(st, obs, K, 4.0, anchors=anchors))
    ch_out = float(robust_cost(out_h, obs, K, 4.0, anchors=anchors))
    assert ch_out < 1e-2 * ch_in, (ch_in, ch_out)


def test_shift_moves_blocks_and_relabels():
    W, B = 3, 2
    m = _toy_map(W, B)
    s = shift_window(m, B)

    # Cameras shift down one slot; the freed slot is invalid.
    np.testing.assert_allclose(np.asarray(s.rvecs[:-1]), np.asarray(m.rvecs[1:]))
    assert not bool(s.cam_valid[-1])
    assert bool(s.cam_valid[0])

    # Point blocks shift down B; the last block is freed.
    np.testing.assert_allclose(
        np.asarray(s.points[: (W - 1) * B]), np.asarray(m.points[B:])
    )
    assert not bool(s.pt_valid[-1])
    np.testing.assert_allclose(
        np.asarray(s.pt_desc[: (W - 1) * B]), np.asarray(m.pt_desc[B:])
    )

    # Observation blocks shift down 3B with indices decremented; rows that
    # referenced camera 0 or point block 0 are invalidated.
    old = m.obs
    new = s.obs
    k = 3 * B
    kept = np.asarray(old.valid[k:] & (old.cam_idx[k:] >= 1)
                      & (old.pt_idx[k:] >= B))
    np.testing.assert_array_equal(np.asarray(new.valid[: -k]), kept)
    sel = np.nonzero(kept)[0]
    np.testing.assert_array_equal(
        np.asarray(new.cam_idx)[sel], np.asarray(old.cam_idx[k:])[sel] - 1
    )
    np.testing.assert_array_equal(
        np.asarray(new.pt_idx)[sel], np.asarray(old.pt_idx[k:])[sel] - B
    )
    np.testing.assert_allclose(
        np.asarray(new.uv[: -k]), np.asarray(old.uv[k:])
    )
    # Freed tail region is invalid.
    assert not bool(new.valid[-k:].any())


def test_shift_is_idempotent_on_empty():
    m = empty_map(4, 3, max_loops=0)
    s = shift_window(m, 3)
    assert not bool(s.cam_valid.any())
    assert not bool(s.obs.valid.any())


def test_archive_ring_writes_and_wraps():
    """Evicted blocks land at (write_slot * B) mod A and overwrite on wrap."""
    W, B, A = 3, 2, 3 * 2  # ring holds exactly 3 eviction blocks
    arch = empty_archive(A)
    assert not bool(arch.valid.any())
    m = _toy_map(W, B)

    # Four evictions into a 3-block ring: slot 3 wraps onto slot 0.
    for slot in range(4):
        arch = archive_evicted_block(
            arch, m, jnp.asarray(slot, jnp.int32),
            jnp.asarray(10 + slot, jnp.int32), B,
        )
        lo = (slot * B) % A
        np.testing.assert_allclose(
            np.asarray(arch.positions[lo : lo + B]), np.asarray(m.points[:B])
        )
        np.testing.assert_array_equal(
            np.asarray(arch.birth[lo : lo + B]), 10 + slot
        )
    assert bool(arch.valid.all())
    # The wrap overwrote block 0's birth frame (10 -> 13).
    np.testing.assert_array_equal(np.asarray(arch.birth[:B]), 13)
    np.testing.assert_array_equal(np.asarray(arch.birth[B : 2 * B]), 11)


def test_loop_buffer_accept_semantics():
    """Device-side acceptance: threshold, cooldown, capacity, and the
    dropped-counter all behave like the round-3 host-side gate did."""
    from sift_parallel_optimization.models.odometry import (
        ArchiveLoop,
        accept_loop_proposal,
        empty_loop_buffer,
    )

    def prop(n, birth=3):
        return ArchiveLoop(
            rvec=jnp.ones(3), tvec=jnp.full(3, 2.0),
            n_inliers=jnp.asarray(n, jnp.int32),
            birth=jnp.asarray(birth, jnp.int32),
        )

    buf = empty_loop_buffer(2)
    step = jax.jit(
        lambda b, p, i: accept_loop_proposal(
            b, p, i, min_inliers=25, cooldown=3
        )
    )
    buf = step(buf, prop(10), 10)       # below threshold -> rejected
    assert int(buf.count) == 0 and int(buf.n_dropped) == 0
    buf = step(buf, prop(30), 11)       # accepted
    assert int(buf.count) == 1 and int(buf.frames[0]) == 11
    assert int(buf.births[0]) == 3
    buf = step(buf, prop(40), 13)       # cooldown (13-11 <= 3) -> rejected
    assert int(buf.count) == 1 and int(buf.n_dropped) == 0
    buf = step(buf, prop(40), 15)       # accepted (15-11 > 3)
    assert int(buf.count) == 2
    buf = step(buf, prop(50), 19)       # full -> counted as dropped
    assert int(buf.count) == 2 and int(buf.n_dropped) == 1
    np.testing.assert_array_equal(np.asarray(buf.frames), [11, 15])


class TestRenderedOdometry:
    """End-to-end on the native renderer (shared fixture at class scope)."""

    size, n_frames, window = 256, 12, 6

    @pytest.fixture(scope="class")
    def sequence(self):
        from sift_parallel_optimization.models.frontend import (
            extract_features,
            sift_config,
        )
        from sift_parallel_optimization.utils import native

        if not native.available():
            pytest.skip("native renderer unavailable")
        size, n_frames = self.size, self.n_frames
        focal = float(size)
        cfg = sift_config(size)
        K = jnp.array(
            [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
            jnp.float32,
        )
        gt_rvecs = np.stack(
            [[0.0, 0.02 * i, 0.002 * i] for i in range(n_frames)]
        ).astype(np.float32)
        gt_tvecs = np.stack(
            [[-0.22 * i, 0.01 * i, 0.03 * i] for i in range(n_frames)]
        ).astype(np.float32)
        fe = jax.jit(
            lambda x: extract_features(x, cfg, 256, dual_orientation=True)
        )
        feats = [
            fe(jnp.asarray(native.render_frame(
                size, gt_rvecs[i], gt_tvecs[i], focal, seed=3)))
            for i in range(n_frames)
        ]
        return feats, K, gt_rvecs, gt_tvecs

    @pytest.mark.slow
    def test_windowed_ate_bounded(self, sequence):
        from sift_parallel_optimization.utils.trajectory import (
            ate_rmse,
            camera_centers,
        )

        feats, K, gt_rvecs, gt_tvecs = sequence
        traj, m = run_odometry(
            jax.random.key(1), feats, K, window=self.window,
        )
        # Constant-memory guarantee: capacities track the WINDOW, not n.
        assert m.rvecs.shape[0] == self.window
        assert m.points.shape[0] == self.window * 128
        assert traj.rvecs.shape == (self.n_frames, 3)

        est = camera_centers(traj.rvecs, traj.tvecs)
        gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
        ate = float(ate_rmse(est, gt))
        span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
        # Windowed odometry (no global BA, no loop closure) drifts more
        # than full SfM; demand < 10% of span (full SfM gates 5%).
        assert ate < 0.10 * span, f"ATE {ate} over span {span}"

    @pytest.mark.slow
    def test_full_window_matches_global_sfm_class(self, sequence):
        """window >= n never evicts: accuracy should match plain SfM's
        gate (same map capacity story as run_sfm without loop closure)."""
        from sift_parallel_optimization.utils.trajectory import (
            ate_rmse,
            camera_centers,
        )

        feats, K, gt_rvecs, gt_tvecs = sequence
        traj, m = run_odometry(
            jax.random.key(1), feats, K, window=self.n_frames,
        )
        est = camera_centers(traj.rvecs, traj.tvecs)
        gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
        ate = float(ate_rmse(est, gt))
        span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
        assert ate < 0.05 * span, f"ATE {ate} over span {span}"


class TestWindowedLoopClosure:
    """Out-and-back revisit: the windowed pipeline composed with the
    landmark-archive loop closure must beat windowed-only ATE and meet
    the GLOBAL 5%-of-span gate, not just the windowed 10% one."""

    size, n_frames, window = 256, 18, 6

    @pytest.fixture(scope="class")
    def sequence(self):
        from sift_parallel_optimization.models.frontend import (
            extract_features,
            sift_config,
        )
        from sift_parallel_optimization.utils import native

        if not native.available():
            pytest.skip("native renderer unavailable")
        size, n = self.size, self.n_frames
        focal = float(size)
        cfg = sift_config(size)
        K = jnp.array(
            [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
            jnp.float32,
        )
        # Out to an apex at frame n//2, back to the start: frames near the
        # end revisit places whose landmarks the window evicted long ago.
        ks = [i if i <= n // 2 else n - 1 - i for i in range(n)]
        gt_rvecs = np.stack(
            [[0.0, 0.025 * k, 0.002 * k] for k in ks]
        ).astype(np.float32)
        gt_tvecs = np.stack(
            [[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks]
        ).astype(np.float32)
        fe = jax.jit(
            lambda x: extract_features(x, cfg, 256, dual_orientation=True)
        )
        feats = [
            fe(jnp.asarray(native.render_frame(
                size, gt_rvecs[i], gt_tvecs[i], focal, seed=3)))
            for i in range(n)
        ]
        return feats, K, gt_rvecs, gt_tvecs

    @pytest.mark.slow
    def test_loop_closure_beats_windowed_only(self, sequence):
        """Round-4 update: anchor marginalization (harvest_anchors)
        removed most windowed-only drift on this 18-frame revisit —
        measured 2.33% of span without anchors vs 0.92% with (default),
        at which point loop closure has nothing left to correct (0.92%
        both ways). The gates now check each claim where it is real:

        * the DEFAULT pipeline (anchors on) meets the GLOBAL 5% bar
          windowed-only, and loop closure must not degrade it;
        * the loop-closure machinery's >= 1.8x relative benefit is
          demonstrated on the ablated (marginalize=False) run, where
          drift actually accumulates — and at length it still matters
          even WITH anchors (tests/test_long_sequence.py gates the
          120-frame three-cycle at >= 1.8x with anchors on).
        """
        from sift_parallel_optimization.utils.trajectory import (
            ate_rmse,
            camera_centers,
        )

        feats, K, gt_rvecs, gt_tvecs = sequence
        gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
        span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))

        ates = {}
        for marg, lc in (
            (True, False), (True, True), (False, False), (False, True),
        ):
            traj, m = run_odometry(
                jax.random.key(1), feats, K, window=self.window,
                loop_closure=lc, marginalize=marg,
            )
            # Constant memory holds with or without the archive.
            assert m.rvecs.shape[0] == self.window
            est = camera_centers(traj.rvecs, traj.tvecs)
            ates[(marg, lc)] = float(ate_rmse(est, gt))

        # Default pipeline: anchored windowed-only meets the global 5%
        # bar outright (measured 0.92%), loop closure within 10%.
        assert ates[(True, False)] < 0.05 * span, (ates, span)
        assert ates[(True, True)] < 0.05 * span, (ates, span)
        assert ates[(True, True)] <= ates[(True, False)] * 1.1, ates
        # Anchors are the reason: the ablation drifts >= 1.8x worse.
        assert ates[(True, False)] * 1.8 < ates[(False, False)], ates
        # Loop closure earns its keep on the drifting ablation
        # (measured 2.33% -> 0.82%).
        assert ates[(False, True)] * 1.8 < ates[(False, False)], ates
        assert ates[(False, True)] < 0.05 * span, (ates, span)

    @pytest.mark.slow
    def test_checkpoint_resume_matches_uninterrupted(
        self, sequence, tmp_path
    ):
        """Kill the run at ~3/4 and resume: the trajectory must match
        the uninterrupted run (failure recovery for the driver whose
        whole point is sequences of any length). The archive ring, loop
        buffer, frozen poses, and used-mask all ride the checkpoint."""
        from sift_parallel_optimization.utils import checkpoint as ck

        feats, K, gt_rvecs, gt_tvecs = sequence
        kw = dict(window=self.window, loop_closure=True)
        full, _ = run_odometry(jax.random.key(1), feats, K, **kw)

        d = str(tmp_path / "odo_ck")
        k = (3 * self.n_frames) // 4
        # "Crash" at frame k: the interrupted run only saw a prefix.
        run_odometry(
            jax.random.key(1), feats[:k], K,
            checkpoint_dir=d, checkpoint_every=2, **kw,
        )
        step = ck.latest_step(d)
        assert step is not None and step < self.n_frames - 1
        resumed, m2 = run_odometry(
            jax.random.key(1), feats, K,
            checkpoint_dir=d, checkpoint_every=2, **kw,
        )
        assert m2.rvecs.shape[0] == self.window
        np.testing.assert_allclose(
            np.asarray(resumed.rvecs), np.asarray(full.rvecs), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(resumed.tvecs), np.asarray(full.tvecs), atol=1e-4
        )

    def test_checkpoint_fingerprint_refuses_mismatch(
        self, sequence, tmp_path
    ):
        feats, K, _, _ = sequence
        d = str(tmp_path / "odo_ck_fp")
        run_odometry(
            jax.random.key(1), feats[:8], K, window=self.window,
            loop_closure=True, checkpoint_dir=d, checkpoint_every=2,
        )
        with pytest.raises(ValueError, match="fingerprint"):
            run_odometry(
                jax.random.key(1), feats[:10], K, window=self.window + 2,
                loop_closure=True, checkpoint_dir=d, checkpoint_every=2,
            )


@pytest.mark.slow
def test_odometry_stream_matches_batch():
    """OdometryStream (the online serving API) runs the same state
    machine as the batch run_odometry driver — same jitted functions in
    the same order — so a streamed sequence reproduces the batch
    trajectory on the same features. n is chosen with
    (n-1) % ba_every == 0 so the final-frame BA aligns (the one place
    the batch driver uses its knowledge of n)."""
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.odometry import (
        OdometryStream,
    )
    from sift_parallel_optimization.utils import native

    if not native.available():
        pytest.skip("native renderer unavailable")
    size, n, W = 256, 15, 6
    focal = float(size)
    cfg = sift_config(size)
    K = jnp.array(
        [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
        jnp.float32,
    )
    ks = [i if i <= n // 2 else n - 1 - i for i in range(n)]
    gt_rvecs = np.stack(
        [[0.0, 0.025 * k, 0.002 * k] for k in ks]
    ).astype(np.float32)
    gt_tvecs = np.stack(
        [[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks]
    ).astype(np.float32)
    fe = jax.jit(
        lambda x: extract_features(x, cfg, 256, dual_orientation=True)
    )
    feats = [
        fe(jnp.asarray(native.render_frame(
            size, gt_rvecs[i], gt_tvecs[i], focal, seed=3)))
        for i in range(n)
    ]
    key = jax.random.key(1)
    traj_b, m_b = run_odometry(
        key, feats, K, window=W, loop_closure=True, max_loops=64,
    )
    stream = OdometryStream(key, K, window=W, loop_closure=True)
    for f in feats:
        r, t = stream.push(f)
    traj_s, m_s, info = stream.finish()
    np.testing.assert_allclose(
        np.asarray(traj_s.tvecs), np.asarray(traj_b.tvecs), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(traj_s.rvecs), np.asarray(traj_b.rvecs), atol=1e-5
    )
    assert info["loops_dropped"] == 0


def test_odometry_stream_short_sequences():
    """OdometryStream degrades gracefully below the window size: 1 frame
    (identity pose), 2 frames (bootstrap pair), W-1 frames (fill only)."""
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.odometry import (
        OdometryStream,
    )
    from sift_parallel_optimization.utils import native

    if not native.available():
        pytest.skip("native renderer unavailable")
    size = 128
    focal = float(size)
    cfg = sift_config(size)
    K = jnp.array(
        [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
        jnp.float32,
    )
    fe = jax.jit(
        lambda x: extract_features(x, cfg, 128, dual_orientation=True)
    )
    feats = [
        fe(jnp.asarray(native.render_frame(
            size,
            np.asarray([0.0, 0.02 * i, 0.0], np.float32),
            np.asarray([-0.2 * i, 0.0, 0.02 * i], np.float32),
            focal, seed=3)))
        for i in range(4)
    ]
    for n in (1, 2, 3, 4):
        stream = OdometryStream(jax.random.key(0), K, window=5)
        for f in feats[:n]:
            stream.push(f)
        traj, m, info = stream.finish()
        assert traj.rvecs.shape[0] == min(n, 5)
        assert bool(jnp.isfinite(traj.tvecs).all())
        assert info["loops_dropped"] == 0
