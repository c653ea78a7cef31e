"""Sliding-window visual odometry: O(window) memory for long sequences.

`models/sfm.py`'s map capacities scale with the TOTAL frame count
(C = n, P = n*B, M ~ 3*P) — fine for the ~50-keyframe north-star scene,
quadratic-cost BA and unbounded memory for long sequences. This module is
the constant-memory companion: a fixed WINDOW of the most recent frames
is kept in a map of static capacity (C = W cameras, P = W*B points,
M = 3*W*B observations); older frames are EVICTED by shifting every
block-structured array left by one frame slot, and their poses are frozen
into the output trajectory.

Static-shape structure (no reference analogue — the reference has no SfM):

* The shift is a static-shape roll: cameras move down one slot, point
  blocks down B slots, observation blocks down 3*B slots, and the
  observation indices are decremented in place — one fused elementwise
  pass, no gather tables, one compiled executable for every frame.
* Because eviction renumbers slots, a full window always registers the
  new frame at slot W-1 against slot W-2 — the register step is the SAME
  jitted `register_frame` used by global SfM, with a CONSTANT frame
  index, so the steady state reuses one executable forever.
* Window BA gauge-fixes slot 0 — the oldest surviving camera, whose pose
  is already consistent with the frozen past — anchoring each window to
  the trajectory that has left it (classic marginalization-by-fixing;
  no prior blocks needed for the fixed-lambda GN used here).

Observations referencing an evicted camera or an evicted landmark are
invalidated by the shift mask; landmarks live at most W frames (their
birth block leaves the window with their birth frame).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from sift_parallel_optimization.models.ba import (
    Observations,
    bundle_adjust,
)
from sift_parallel_optimization.models.frontend import Features
from sift_parallel_optimization.models.sfm import (
    SfmMap,
    empty_map,
    init_two_view,
    register_frame,
)


class Trajectory(NamedTuple):
    """Full-sequence pose estimates (world->cam axis-angle + translation)."""

    rvecs: jax.Array  # (n, 3)
    tvecs: jax.Array  # (n, 3)


class LandmarkArchive(NamedTuple):
    """Fixed-capacity ring of EVICTED landmarks for loop closure.

    When a frame leaves the window its landmark block is frozen — world
    positions, appearance descriptors, birth frame — into this ring
    (capacity A, write head wraps). The archive is the window pipeline's
    long-term place memory: the current frame's descriptors are matched
    against it (one masked matmul, the same machinery as
    models/loop_closure.py) and a PnP against the archived world points
    yields an ABSOLUTE pose constraint — metric scale comes from the
    archived map for free.
    """

    positions: jax.Array  # (A, 3) world coordinates, frozen at eviction
    desc: jax.Array       # (A, 128)
    birth: jax.Array      # (A,) i32 global frame id of the birth keyframe
    valid: jax.Array      # (A,)


def empty_archive(capacity: int) -> LandmarkArchive:
    return LandmarkArchive(
        positions=jnp.zeros((capacity, 3), jnp.float32),
        desc=jnp.zeros((capacity, 128), jnp.float32),
        birth=jnp.zeros(capacity, jnp.int32),
        valid=jnp.zeros(capacity, bool),
    )


def archive_evicted_block(
    arch: LandmarkArchive,
    m: SfmMap,
    write_slot,
    birth_frame,
    pts_per_frame: int,
) -> LandmarkArchive:
    """Freeze window slot 0's landmark block into the ring before a shift.

    ``write_slot`` counts evictions (traced); the block lands at ring
    offset (write_slot * B) mod A. One compiled executable serves every
    eviction (dynamic_update_slice with a traced offset). Under the
    coverage policy, ``write_slot`` is the block index chosen by
    :func:`coverage_write_slot` (< A/B, so the mod is a no-op).
    """
    from jax import lax

    B = pts_per_frame
    A = arch.valid.shape[0]
    start = (jnp.asarray(write_slot, jnp.int32) * B) % A

    def upd(arr, vals):
        return lax.dynamic_update_slice_in_dim(
            arr, vals.astype(arr.dtype), start, axis=0
        )

    return LandmarkArchive(
        positions=upd(arch.positions, m.points[:B]),
        desc=upd(arch.desc, m.pt_desc[:B]),
        birth=upd(
            arch.birth,
            jnp.full(B, jnp.asarray(birth_frame, jnp.int32)),
        ),
        valid=upd(arch.valid, m.pt_valid[:B]),
    )


def coverage_write_slot(
    arch: LandmarkArchive,
    m: SfmMap,
    birth_frame,
    min_gap: int,
    pts_per_frame: int,
    now_frame=None,
) -> jax.Array:
    """Pick the archive BLOCK to overwrite by age-stratified redundancy.

    FIFO eviction forgets by AGE: a ring of ``A/B`` blocks wraps after
    that many evictions, so a revisit later than one ring period finds
    its place memory overwritten (ROADMAP "archive ring capacity auto
    -sizing"). Pure spatial redundancy is NOT the fix — measured on the
    120-frame three-cycle (8-block ring): the window trail evicts blocks
    spatially NEAR the current pose, so a revisit "refreshes" the old
    block covering that place with a fresh birth, and the loop proposer
    (which requires ``birth <= frame - min_gap``) finds nothing to match
    — 1 accepted loop vs FIFO's 5. The policy must therefore protect
    OLD coverage:

    * a block is OLD if its birth precedes ``now_frame - min_gap`` —
      ``now_frame`` is the CURRENT frame (defaulting to ``birth_frame``
      for compatibility), matching exactly the age at which the loop
      proposer starts treating the block as loop fodder (round-5
      ADVICE fix: classifying against the incoming block's birth,
      ``birth_frame = now - W``, left a W-frame band of
      already-proposable blocks unprotected);
    * a YOUNG block is redundant if any other occupied block or the
      incoming block covers its place — young trail refreshes young
      trail, and a young block sitting on old coverage is expendable;
    * an OLD block can only be made redundant by another OLD block
      (two old blocks covering one place keep one); the incoming
      (youngest) block never displaces old memory;
    * among equals, the YOUNGER of a redundant pair is evicted —
      exact lexicographic (min novelty, then max birth among
      near-ties), scale-free at any coordinate magnitude (round-5
      ADVICE fix: the old -1e-5*birth additive tie-break fell below
      f32 resolution once novelty was large);
    * empty blocks are filled first in index order, which reproduces
      FIFO during initial fill.

    O((A/B)^2) centroid distances per eviction — 64x64 at the default
    sizing, negligible next to the window BA. Fully on device (no host
    sync); the returned i32 block index feeds
    :func:`archive_evicted_block` as its ``write_slot`` (block k lands
    at offset k*B, and k < A/B keeps the mod a no-op).
    (No reference analogue — north-star long-sequence robustness; the
    closest reference cousin is the `is_initialized` state-reset guard,
    /root/reference/GaussDePyramid-MPI.h:87-100.)
    """
    B = pts_per_frame
    nb = arch.valid.shape[0] // B
    big = jnp.float32(1e30)
    now = birth_frame if now_frame is None else now_frame
    pos = arch.positions.reshape(nb, B, 3)
    val = arch.valid.reshape(nb, B).astype(jnp.float32)
    cnt = val.sum(-1)
    cent = (pos * val[..., None]).sum(1) / jnp.maximum(cnt, 1.0)[:, None]
    occupied = cnt > 0                                     # (nb,)
    bb = arch.birth.reshape(nb, B)[:, 0]                   # (nb,) i32
    old = occupied & (bb <= jnp.asarray(now, jnp.int32) - min_gap)
    iv = m.pt_valid[:B].astype(jnp.float32)
    icent = (m.points[:B] * iv[:, None]).sum(0) / jnp.maximum(
        iv.sum(), 1.0
    )
    d2 = jnp.sum((cent[:, None] - cent[None]) ** 2, -1)    # (nb, nb)
    # c may mark b redundant unless b is OLD and c is not.
    allow = occupied[None, :] & ~(old[:, None] & ~old[None, :])
    d2 = jnp.where(allow, d2, big) + jnp.eye(nb, dtype=d2.dtype) * big
    d_in = jnp.sum((cent - icent) ** 2, -1)
    d_in = jnp.where((iv.sum() > 0) & ~old, d_in, big)
    novelty = jnp.minimum(d2.min(axis=1), d_in)
    # Fill empty blocks first (index order = FIFO during initial fill);
    # otherwise exact lexicographic (min novelty, youngest among ties).
    first_empty = jnp.argmax(~occupied)
    m0 = jnp.min(jnp.where(occupied, novelty, big))
    tie = occupied & (novelty <= m0 * (1.0 + 1e-6) + 1e-30)
    youngest_tie = jnp.argmax(jnp.where(tie, bb, -(2**30)))
    return jnp.where(
        jnp.any(~occupied), first_empty, youngest_tie
    ).astype(jnp.int32)


class ArchiveLoop(NamedTuple):
    rvec: jax.Array       # (3,) absolute world->cam PnP pose
    tvec: jax.Array       # (3,)
    n_inliers: jax.Array  # () i32 — gates acceptance
    birth: jax.Array      # () i32 median birth frame of inlier landmarks


def propose_archive_loop(
    key,
    feats: Features,
    arch: LandmarkArchive,
    frame_i,
    K: jax.Array,
    min_gap: int = 8,
    threshold: float = 3.0,
) -> ArchiveLoop:
    """PnP the current frame against archived landmarks born >= min_gap
    frames ago. Jittable with a traced ``frame_i``.

    ``birth`` (median birth frame of the PnP inliers) is the loop's
    anchor node: archived landmark positions carry the trajectory error
    accumulated up to their BIRTH frame, so the PnP pose is only
    "absolute" relative to the map as it stood then. A pose-graph edge
    (birth -> frame_i) cancels that common error to first order, where
    the round-3 (0 -> frame_i) absolute edge baked it into the
    constraint — measured on the 120-frame three-cycle sequence, the
    0-anchored edges made the corrected ATE WORSE than windowed-only
    (5.9% vs 5.2% of span) while birth-anchored edges fix it.
    """
    from sift_parallel_optimization.models.matching import (
        match_descriptors,
    )
    from sift_parallel_optimization.models.sfm import ransac_pnp

    old = arch.valid & (
        arch.birth <= jnp.asarray(frame_i, jnp.int32) - min_gap
    )
    match = match_descriptors(
        feats.descriptors, arch.desc, feats.keypoints.valid, old
    )
    uv = jnp.stack([feats.keypoints.x, feats.keypoints.y], -1)
    pts3d = arch.positions[match.idx2]
    mask = match.valid & old[match.idx2]
    cam, inl, n = ransac_pnp(key, pts3d, uv, mask, K, threshold=threshold)
    births = arch.birth[match.idx2]
    # Median inlier birth: sort invalids to +inf, take the middle one.
    keep = inl & mask
    cnt = jnp.maximum(keep.sum(), 1)
    b_sorted = jnp.sort(jnp.where(keep, births, jnp.int32(2**30)))
    birth = b_sorted[jnp.clip((cnt - 1) // 2, 0, births.shape[0] - 1)]
    birth = jnp.where(keep.any(), birth, 0)
    return ArchiveLoop(
        rvec=cam.rvec, tvec=cam.tvec, n_inliers=n, birth=birth
    )


class LoopBuffer(NamedTuple):
    """Device-side accepted-loop accumulator.

    Reading ``int(prop.n_inliers)`` back to the host every frame to gate
    loop acceptance would cost a device-to-host synchronization per
    frame and stall the dispatch pipeline. Here acceptance (inlier threshold + cooldown + capacity) is computed on
    device and accepted constraints land in this fixed-capacity buffer;
    the host reads it back ONCE at end of run. ``n_dropped`` counts
    would-be-accepted proposals lost to a full buffer so saturation is
    LOGGED instead of silently dropping closures.
    """

    rvecs: jax.Array      # (cap, 3) accepted PnP poses
    tvecs: jax.Array      # (cap, 3)
    frames: jax.Array     # (cap,) i32 global frame ids
    inliers: jax.Array    # (cap,) i32
    births: jax.Array     # (cap,) i32 anchor node per loop
    count: jax.Array      # () i32 accepted so far
    last_loop: jax.Array  # () i32 frame id of last acceptance (cooldown)
    n_dropped: jax.Array  # () i32 accepted-quality proposals dropped


def empty_loop_buffer(capacity: int) -> LoopBuffer:
    return LoopBuffer(
        rvecs=jnp.zeros((capacity, 3), jnp.float32),
        tvecs=jnp.zeros((capacity, 3), jnp.float32),
        frames=jnp.zeros(capacity, jnp.int32),
        inliers=jnp.zeros(capacity, jnp.int32),
        births=jnp.zeros(capacity, jnp.int32),
        count=jnp.zeros((), jnp.int32),
        last_loop=jnp.full((), -(2**30), jnp.int32),
        n_dropped=jnp.zeros((), jnp.int32),
    )


def accept_loop_proposal(
    buf: LoopBuffer,
    prop: ArchiveLoop,
    frame_i,
    min_inliers: int,
    cooldown: int,
) -> LoopBuffer:
    """Masked device-side acceptance: no host read, one executable."""
    cap = buf.frames.shape[0]
    fi = jnp.asarray(frame_i, jnp.int32)
    good = (prop.n_inliers >= min_inliers) & (
        fi - buf.last_loop > cooldown
    )
    ok = good & (buf.count < cap)
    idx = jnp.minimum(buf.count, cap - 1)

    def put(arr, val):
        return arr.at[idx].set(
            jnp.where(ok, jnp.asarray(val, arr.dtype), arr[idx])
        )

    return LoopBuffer(
        rvecs=put(buf.rvecs, prop.rvec),
        tvecs=put(buf.tvecs, prop.tvec),
        frames=put(buf.frames, fi),
        inliers=put(buf.inliers, prop.n_inliers),
        births=put(buf.births, prop.birth),
        count=buf.count + ok.astype(jnp.int32),
        last_loop=jnp.where(ok, fi, buf.last_loop),
        n_dropped=buf.n_dropped + (good & ~ok).astype(jnp.int32),
    )


class Sim3(NamedTuple):
    """World similarity X_arch = s * (r @ X_win) + t (drift correction
    mapping the window's drifted frame onto the archive's world frame)."""

    s: jax.Array   # () scale
    r: jax.Array   # (3, 3)
    t: jax.Array   # (3,)
    n_pairs: jax.Array  # () i32 — trimmed landmark pairs (host gates)


def landmark_sim3(
    m: SfmMap,
    arch: LandmarkArchive,
    frame_i,
    min_gap: int = 8,
    trim_factor: float = 3.0,
) -> Sim3:
    """Sim(3) drift estimate from landmark-to-landmark correspondences.

    The window's CURRENT landmark positions and the archive's FROZEN
    positions of the same physical points (matched by descriptor) differ
    by exactly the accumulated drift — including SCALE, which monocular
    odometry drifts multiplicatively and which no SE(3) correction (and
    no SE(3) pose graph) can absorb. A weighted Umeyama fit over the
    matched pairs, trimmed once at ``trim_factor`` x rms, recovers the
    full similarity. Round-3 measurement (40-frame two-cycle revisit,
    256^2): the SE(3)-only re-anchor left ATE at ~14% of span; the
    Sim(3) re-anchor is what makes multi-cycle sequences track.
    """
    from sift_parallel_optimization.models.matching import (
        match_descriptors,
    )

    old = arch.valid & (
        arch.birth <= jnp.asarray(frame_i, jnp.int32) - min_gap
    )
    match = match_descriptors(m.pt_desc, arch.desc, m.pt_valid, old)
    src = m.points
    dst = arch.positions[match.idx2]
    w = (match.valid & old[match.idx2]).astype(jnp.float32)

    def fit(w):
        with jax.default_matmul_precision("highest"):
            sw = jnp.maximum(w.sum(), 1e-9)
            mu_s = (src * w[:, None]).sum(0) / sw
            mu_d = (dst * w[:, None]).sum(0) / sw
            xs = src - mu_s
            xd = dst - mu_d
            cov = (xd * w[:, None]).T @ xs / sw
            u, d, vt = jnp.linalg.svd(cov)
            sgn = jnp.sign(jnp.linalg.det(u) * jnp.linalg.det(vt))
            diag = jnp.stack([jnp.ones(()), jnp.ones(()), sgn])
            r = (u * diag[None, :]) @ vt
            var_s = ((xs * xs).sum(-1) * w).sum() / sw
            s = jnp.sum(d * diag) / jnp.maximum(var_s, 1e-12)
            t = mu_d - s * r @ mu_s
            return s, r, t

    s1, r1, t1 = fit(w)
    resid = jnp.linalg.norm(s1 * src @ r1.T + t1 - dst, axis=-1)
    rms = jnp.sqrt(
        (resid**2 * w).sum() / jnp.maximum(w.sum(), 1e-9)
    )
    w2 = w * (resid <= trim_factor * rms + 1e-9)
    s2, r2, t2 = fit(w2)
    return Sim3(s=s2, r=r2, t=t2, n_pairs=w2.sum().astype(jnp.int32))


def pnp_sim3(m: SfmMap, slot, rvec_p, tvec_p) -> Sim3:
    """SE(3) fallback correction (scale 1) aligning window camera
    ``slot`` to its archive-PnP pose (used when too few landmark pairs
    survive for :func:`landmark_sim3`)."""
    from sift_parallel_optimization.models.geometry import rodrigues

    rs = rodrigues(m.rvecs[slot])
    rp = rodrigues(rvec_p)
    rg = rp.T @ rs                       # R' = R rg^T = Rp at slot
    tg = rp.T @ (m.tvecs[slot] - tvec_p)
    # In the X_arch = s r X_win + t convention: r = rg^T? Derive: cams
    # transform R' = R @ r^T; want Rs @ r^T = Rp -> r = Rp^T... careful:
    # r^T = Rs^T Rp -> r = Rp^T Rs = rg. t from t' = s*t - R' @ t_g with
    # R' = Rp: tvec_p = tvecs[slot] - Rp @ t  ->  t = Rp^T (ts - tp).
    return Sim3(
        s=jnp.ones(()), r=rg, t=tg,
        n_pairs=jnp.zeros((), jnp.int32),
    )


def apply_sim3_map(m: SfmMap, g: Sim3) -> SfmMap:
    """Apply the drift correction to every window camera and landmark.

    X' = s (r X) + t; cameras R' = R r^T, t' = s t - R' @ t_g.
    Reprojections are invariant (R'X' + t' = s (RX + t), and projection
    is homogeneous), so the map stays self-consistent — what changes is
    that tracking continues in archive-consistent coordinates, so drift
    (including scale drift) cannot compound across revisit cycles.
    """
    from sift_parallel_optimization.models.geometry import (
        rodrigues,
        rotation_log,
    )

    r_all = rodrigues(m.rvecs)
    r_new = jnp.einsum("cij,kj->cik", r_all, g.r)       # R @ r^T
    t_new = g.s * m.tvecs - jnp.einsum("cij,j->ci", r_new, g.t)
    pts_new = g.s * (m.points @ g.r.T) + g.t
    return m._replace(
        rvecs=jax.vmap(rotation_log)(r_new), tvecs=t_new, points=pts_new
    )


def apply_sim3_poses(
    rvecs: jax.Array, tvecs: jax.Array, g: Sim3
) -> tuple[jax.Array, jax.Array]:
    """Apply the drift correction to a stack of world->cam poses (the
    frozen past trajectory moves WITH the window so the whole estimate
    stays in one frame)."""
    from sift_parallel_optimization.models.geometry import (
        rodrigues,
        rotation_log,
    )

    r_all = rodrigues(rvecs)
    r_new = jnp.einsum("cij,kj->cik", r_all, g.r)
    t_new = g.s * tvecs - jnp.einsum("cij,j->ci", r_new, g.t)
    return jax.vmap(rotation_log)(r_new), t_new


def shift_window(m: SfmMap, pts_per_frame: int) -> SfmMap:
    """Evict frame slot 0: shift every per-frame block down one slot.

    Cameras shift by 1, point blocks by B, observation blocks by 3*B
    (matching `register_frame`'s static block layout). Observation camera
    and point indices are decremented; rows that now reference the evicted
    camera (cam_idx < 0) or an evicted landmark block (pt_idx < 0) are
    invalidated. All shapes static — jit once, reuse every eviction.
    """
    B = pts_per_frame

    def shift(arr, k):
        pad = jnp.zeros((k,) + arr.shape[1:], arr.dtype)
        return jnp.concatenate([arr[k:], pad], axis=0)

    obs = m.obs
    cam_idx = obs.cam_idx - 1
    pt_idx = obs.pt_idx - B
    valid = obs.valid & (cam_idx >= 0) & (pt_idx >= 0)
    obs = Observations(
        cam_idx=shift(jnp.maximum(cam_idx, 0), 3 * B),
        pt_idx=shift(jnp.maximum(pt_idx, 0), 3 * B),
        uv=shift(obs.uv, 3 * B),
        valid=shift(valid, 3 * B),
    )
    return SfmMap(
        rvecs=shift(m.rvecs, 1),
        tvecs=shift(m.tvecs, 1),
        cam_valid=shift(m.cam_valid, 1),
        points=shift(m.points, B),
        pt_valid=shift(m.pt_valid, B),
        pt_desc=shift(m.pt_desc, B),
        obs=obs,
    )


def harvest_anchors(
    m: SfmMap,
    anchors,
    pts_per_frame: int,
    per_eviction: int = 128,
):
    """Called just BEFORE :func:`shift_window`: turn the departing
    landmark block's surviving observations into fixed-landmark factors.

    Rows of ``m.obs`` that reference the evicted block (pt_idx < B) from
    cameras that survive the shift (cam_idx >= 1) would be INVALIDATED
    by shift_window — discarding the constraints that tie the remaining
    window to the geometry it just left, the dominant windowed-only
    drift source. Here they become :class:`~.ba.Anchors` against the
    landmarks' frozen world positions (marginalization-lite; see the
    Anchors docstring for the locality/bias argument).

    Static-shape bookkeeping: up to ``per_eviction`` candidates are kept
    per eviction (ranked valid-first, then LATEST camera first — later
    cameras survive the most future evictions, so their anchors pay rent
    longest), existing anchors shift down one camera slot and expire
    when their camera leaves, and the merge compacts valid-first
    (stable) into the fixed capacity. All O(|obs| log |obs|) argsorts on
    ~2-3k rows — device-side, jit once.
    """
    import jax

    B = pts_per_frame
    A = anchors.valid.shape[0]
    obs = m.obs
    W = m.rvecs.shape[0]
    # cam_idx >= 2: post-shift the camera must land on slot >= 1 —
    # slot 0 is gauge-fixed in the window BA (its Jacobians are zeroed),
    # so a slot-0 anchor would occupy a row and constrain nothing.
    new_valid = (
        obs.valid & (obs.pt_idx < B) & (obs.cam_idx >= 2)
        & m.pt_valid[obs.pt_idx]
    )
    from sift_parallel_optimization.models.ba import Anchors

    cand = Anchors(
        cam_idx=jnp.maximum(obs.cam_idx - 1, 0),
        xyz=m.points[obs.pt_idx],
        uv=obs.uv,
        valid=new_valid,
    )
    # Rank: valid first, then latest camera first; stable for obs-order
    # determinism within a camera.
    key_new = jnp.where(new_valid, W - cand.cam_idx, 10_000)
    sel = jnp.argsort(key_new, stable=True)[:per_eviction]
    cand = jax.tree.map(lambda a: a[sel], cand)

    old_cam = anchors.cam_idx - 1
    old = anchors._replace(
        cam_idx=jnp.maximum(old_cam, 0),
        valid=anchors.valid & (old_cam >= 1),
    )
    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), old, cand
    )
    order = jnp.argsort(~merged.valid, stable=True)[:A]
    return jax.tree.map(lambda a: a[order], merged)


def make_steady_step(
    features_stacked: Features | None,
    K: jax.Array,
    *,
    key,
    window: int,
    pts_per_frame: int,
    n_frames: int,
    ba_every: int,
    ba_iters: int,
    ba_kwargs: dict,
    marginalize: bool,
    loop_closure: bool,
    loop_min_gap: int = 8,
    loop_min_inliers: int = 25,
    loop_cooldown: int = 3,
    archive_policy: str = "fifo",
):
    """Build the FUSED steady-state frame step for ``lax.scan``.

    Instead of 4-6 separately-jitted calls per frame (archive/coverage,
    harvest, shift, register, BA, loop), each a host dispatch, the whole
    steady-state frame (every phase is static-shape) is ONE traced
    program, and `run_odometry` scans it over frame-index chunks, so a
    thousand-frame steady state costs a handful of dispatches total.
    (Analogue: the reference's one-launch worker pool that amortizes
    thread startup over all octaves,
    /root/reference/GaussDePyramid-pThread.h:176-188.)

    carry = (m, used, anchors_or_None, archive_or_None, buf_or_None);
    xs = the global frame index i (traced i32, i >= window) when
    ``features_stacked`` is given (the batch driver gathers each
    frame's features from the stack), or the triple
    ``(i, feats_i, feats_prev)`` when it is None (the ONLINE serving
    driver, :class:`OdometryStream`, feeds one frame per call — same
    traced program either way). Emits the evicted slot-0 pose per step
    — the frozen trajectory — as scan ys.
    Identical op sequence to the round-4 per-frame path: eviction
    (archive write under the configured policy), anchor harvest, shift,
    register at slot W-1, window BA on ``ba_every`` frames
    (lax.cond), loop propose+accept for i > W (lax.cond).
    """
    from jax import lax

    W = window
    B = pts_per_frame
    loop_base = jax.random.fold_in(key, 11)

    def step(carry, xs):
        m, used, anc, arch, buf = carry
        frozen = (m.rvecs[0], m.tvecs[0])
        if features_stacked is None:
            i, feats_i, feats_p = xs
        else:
            i = xs
        i = jnp.asarray(i, jnp.int32)
        if loop_closure:
            birth = i - W
            wslot = (
                coverage_write_slot(
                    arch, m, birth, loop_min_gap, B, now_frame=i
                )
                if archive_policy == "coverage"
                else birth
            )
            arch = archive_evicted_block(arch, m, wslot, birth, B)
        if marginalize:
            anc = harvest_anchors(m, anc, B, per_eviction=B)
        m = shift_window(m, B)
        if features_stacked is not None:
            feats_i = jax.tree.map(lambda a: a[i], features_stacked)
            feats_p = jax.tree.map(lambda a: a[i - 1], features_stacked)
        m, used = register_frame(
            jax.random.fold_in(key, i), m, feats_i, feats_p,
            jnp.asarray(W - 1, jnp.int32), K, used, B,
        )
        if ba_every:
            do_ba = ((i % ba_every) == 0) | (i == n_frames - 1)

            def run_ba(mm):
                st = bundle_adjust(
                    mm.ba_state(), mm.obs, K, n_iters=ba_iters,
                    anchors=anc, **ba_kwargs,
                )
                return mm._replace(
                    rvecs=st.rvecs, tvecs=st.tvecs, points=st.points
                )

            m = lax.cond(do_ba, run_ba, lambda mm: mm, m)
        if loop_closure:

            def run_loop(b):
                prop = propose_archive_loop(
                    jax.random.fold_in(loop_base, i), feats_i, arch,
                    i, K, min_gap=loop_min_gap,
                )
                return accept_loop_proposal(
                    b, prop, i, loop_min_inliers, loop_cooldown
                )

            buf = lax.cond(i > W, run_loop, lambda b: b, buf)
        return (m, used, anc, arch, buf), frozen

    return step


def run_odometry(
    key,
    features: Sequence[Features],
    K: jax.Array,
    window: int = 8,
    pts_per_frame: int = 128,
    ba_every: int = 2,
    ba_iters: int = 8,
    damping: float = 1e-4,
    huber_delta: float | None = 2.0,
    solver: str = "auto",
    loop_closure: bool = False,
    loop_min_gap: int | None = None,
    loop_min_inliers: int = 25,
    loop_weight: float = 4.0,
    loop_cooldown: int = 3,
    max_loops: int | None = None,
    archive_size: int | None = None,
    archive_policy: str = "fifo",
    pgo_iters: int = 15,
    return_info: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    marginalize: bool = True,
):
    """Constant-memory odometry over a frame sequence of ANY length.

    ``marginalize`` keeps evicted-landmark observations alive as
    fixed-landmark anchor factors in the window BA
    (:func:`harvest_anchors` / :class:`~.ba.Anchors`) — the
    marginalization-lite counterpart of the frozen-pose convention
    (measured effect: BASELINE.md round-4 windowed-only rows).

    Returns the full (n, 3)+(n, 3) trajectory plus the final window map
    (whose capacities depend only on ``window`` and ``pts_per_frame``).
    Poses of evicted frames are frozen at eviction time; frames still in
    the final window carry the last window-BA refinement.

    ``solver`` picks the window-BA Schur solver ("auto" resolves from the
    window capacities — small windows keep the dense solve, wide windows
    take the implicit-Schur CG path; models/ba.py resolve_solver).

    ``loop_closure`` composes the window pipeline with revisit
    correction: evicted landmark blocks are frozen into a fixed-capacity
    :class:`LandmarkArchive` ring, every frame is PnP-matched against it
    (:func:`propose_archive_loop`), and accepted constraints feed ONE
    pose-graph optimization over the full trajectory at the end —
    odometry-chain edges from the estimates, loop edges anchored at
    their inlier-birth frames. Above the dense-solver node limit the
    DEFAULT Sim(3) corrector dispatches to the exact O(n)
    block-tridiagonal + Woodbury chain solver
    (models/pose_graph_sim3.solve_sim3_chain; the SE(3) path has its
    matrix-free CG, models/pose_graph.py), so the end-of-run correction
    stays O(n) even for thousand-frame sequences, preserving the
    O(window) memory story (the archive ring is the only per-sequence
    state, and its capacity is fixed).

    ``loop_min_gap`` defaults to ``window + 1`` (an archived landmark is
    at least ``window`` frames old by construction; +1 rejects border
    cases). ``loop_cooldown`` suppresses acceptances for that many
    frames after one, so one revisit yields one constraint, not a
    burst. ``max_loops`` (the device buffer's capacity) defaults to the
    structural acceptance bound of THIS sequence — the cooldown admits
    at most one loop per ``loop_cooldown + 1`` frames after the first
    eviction — so default-knob runs can never saturate the buffer
    regardless of length (round-5 fix: the fixed default 8 saturated
    the 120-frame three-cycle and logged dropped closures; the
    reference's analogous knob was autotuned,
    /root/reference/GaussDePyramid-pThread.h:310-326). The buffer costs
    ~52 bytes per slot, so sizing it for the worst case is free. Pass
    an explicit ``max_loops`` to pin the capacity — required if a
    checkpointed run is to be resumed and then EXTENDED past its
    original length (the auto value depends on ``len(features)`` and
    is part of the checkpoint fingerprint). ``archive_size`` (landmark
    slots) defaults to 64 eviction blocks. ``archive_policy`` picks the ring-overwrite rule once the
    archive is full: "fifo" (overwrite by age — one ring period of
    memory) or "coverage" (overwrite the spatially most redundant block
    — :func:`coverage_write_slot`; place memory survives any number of
    revisits of distinct regions regardless of ring size). Loop
    acceptance is DEVICE-SIDE (:class:`LoopBuffer`): the
    steady-state tracking loop performs zero per-frame host reads; the
    buffer is fetched once at end of run, and a saturated buffer
    (``max_loops`` hit while closures were still being proposed) is
    logged instead of silently dropping them.

    With ``checkpoint_dir`` set, the full resumable state — window map,
    used-mask, frozen poses, landmark archive, loop buffer — is saved
    every ``checkpoint_every`` frames and the run RESUMES from the
    latest checkpoint if one exists (the failure-recovery subsystem the
    ``run_sfm`` driver already had; the config fingerprint refuses a
    checkpoint written under different capacities). The fingerprint
    deliberately excludes the frame COUNT: a crash-resume may continue
    the same sequence to any length — which is the point of a driver
    whose memory is O(window).
    """
    n = len(features)
    W = window
    if W < 3:
        raise ValueError("window must be >= 3 (bootstrap pair + PnP frame)")
    m = empty_map(W, pts_per_frame, max_loops=0)
    # Per-frame keys via fold_in (NOT split(key, n)): the stream for
    # frame i must not depend on the sequence length, so a checkpointed
    # run can resume and continue to ANY length bit-identically.
    keys = [jax.random.fold_in(key, i) for i in range(n)]

    init_fn = jax.jit(
        functools.partial(init_two_view, pts_per_frame=pts_per_frame)
    )
    reg_fn = jax.jit(
        functools.partial(register_frame, pts_per_frame=pts_per_frame)
    )
    from sift_parallel_optimization.models.ba import resolve_solver

    solver = resolve_solver(W, W * pts_per_frame, solver)
    ba_kwargs: dict = dict(
        damping=damping, huber_delta=huber_delta, solver=solver,
    )
    if solver == "cg":
        # A window landmark sees at most every window frame (2 birth obs
        # + one PnP re-observation per remaining frame).
        ba_kwargs["max_obs_per_point"] = -(-W // 8) * 8
    ba_fn = jax.jit(
        functools.partial(bundle_adjust, n_iters=ba_iters, **ba_kwargs)
    )

    anc = None
    if marginalize:
        from sift_parallel_optimization.models.ba import empty_anchors

        anc = empty_anchors((W - 1) * pts_per_frame)

    # Evicted (frozen) poses, kept as a list of (k, 3) CHUNK arrays —
    # the fused steady-state scan emits whole chunks as ys.
    frozen_r: list[jax.Array] = []
    frozen_t: list[jax.Array] = []

    arch = None
    buf = None
    if loop_closure:
        if loop_min_gap is None:
            loop_min_gap = W + 1
        if max_loops is None:
            # Structural acceptance bound: proposals start at frame
            # W + 1 and the cooldown admits at most one acceptance per
            # loop_cooldown + 1 frames.
            max_loops = max(
                8, (n - W) // (loop_cooldown + 1) + 1
            )
        if archive_size is None:
            archive_size = 64 * pts_per_frame
        if archive_policy not in ("fifo", "coverage"):
            raise ValueError(
                f"archive_policy must be 'fifo' or 'coverage', "
                f"got {archive_policy!r}"
            )
        if (
            archive_policy == "coverage"
            and archive_size % pts_per_frame != 0
        ):
            raise ValueError(
                "archive_policy='coverage' needs archive_size to be a "
                f"multiple of pts_per_frame ({pts_per_frame}); got "
                f"{archive_size}"
            )
        arch = empty_archive(archive_size)
        buf = empty_loop_buffer(max_loops)
        # Archive writes, loop proposal, and device-side acceptance all
        # live INSIDE the fused steady-state scan body
        # (make_steady_step): zero per-frame host work of any kind.

    # --- checkpoint/resume (mirrors run_sfm; utils/checkpoint.py) ----
    ckpt = None
    start = 2
    if checkpoint_dir is not None:
        from sift_parallel_optimization.utils import (
            checkpoint as ckpt,
        )

        ckpt_meta = {
            "window": W,
            "pts_per_frame": pts_per_frame,
            "loop_closure": bool(loop_closure),
            "archive_size": int(archive_size or 0),
            "desc_capacity": int(features[0].descriptors.shape[0]),
            # Anchor capacity changes the checkpoint pytree AND the BA
            # trajectory — a resume under a different marginalize
            # setting must be refused like any capacity change.
            "anchors": 0 if anc is None else int(anc.valid.shape[0]),
        }
        if loop_closure:
            # The overwrite policy changes which blocks survive, hence
            # the trajectory — resuming under a different one would
            # silently diverge from the uninterrupted run. (Loop-only
            # keys are fingerprinted only on loop runs; a checkpoint
            # written before archive_policy existed resumes as the
            # "fifo" its run actually was — load_pytree meta_defaults.)
            ckpt_meta["archive_policy"] = archive_policy
            ckpt_meta["max_loops"] = int(max_loops)

        def _ckpt_like(step: int) -> dict:
            # Frozen-pose count is a function of the step, so the
            # restore template is exact without fingerprinting n.
            F = max(0, step - W + 1)
            like = {
                "m": empty_map(W, pts_per_frame, max_loops=0),
                "used": jnp.zeros(
                    features[0].keypoints.valid.shape[0], bool
                ),
            }
            if F > 0:
                like["frozen_r"] = jnp.zeros((F, 3), jnp.float32)
                like["frozen_t"] = jnp.zeros((F, 3), jnp.float32)
            if loop_closure:
                like["arch"] = empty_archive(archive_size)
                like["buf"] = empty_loop_buffer(max_loops)
            if anc is not None:
                from sift_parallel_optimization.models.ba import (
                    empty_anchors,
                )

                like["anc"] = empty_anchors((W - 1) * pts_per_frame)
            return like

        step = ckpt.latest_step(checkpoint_dir)
        if step is not None:
            state, step = ckpt.load_pytree(
                checkpoint_dir, _ckpt_like(step), meta=ckpt_meta,
                meta_defaults={"archive_policy": "fifo"},
            )
            m, used = state["m"], state["used"]
            if max(0, step - W + 1) > 0:
                frozen_r = [state["frozen_r"]]
                frozen_t = [state["frozen_t"]]
            if loop_closure:
                arch, buf = state["arch"], state["buf"]
            if anc is not None and "anc" in state:
                anc = state["anc"]
            start = step + 1

    def _save_checkpoint(at_step: int):
        state = {"m": m, "used": used}
        if frozen_r:
            state["frozen_r"] = jnp.concatenate(frozen_r)
            state["frozen_t"] = jnp.concatenate(frozen_t)
        if loop_closure:
            state["arch"] = arch
            state["buf"] = buf
        if anc is not None:
            state["anc"] = anc
        ckpt.save_pytree(
            checkpoint_dir, state, step=at_step, meta=ckpt_meta
        )

    if start == 2:
        m, used = init_fn(keys[0], features[0], features[1], K, m)
    # ---- window-filling frames (i < W): register-only, no eviction --
    for i in range(start, min(n, W)):
        m, used = reg_fn(
            keys[i], m, features[i], features[i - 1],
            jnp.asarray(i, jnp.int32), K, used,
        )
        if ba_every and (i % ba_every == 0 or i == n - 1):
            st = ba_fn(m.ba_state(), m.obs, K, anchors=anc)
            m = m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)
        if ckpt is not None and checkpoint_every and i % checkpoint_every == 0:
            _save_checkpoint(i)

    # ---- steady state (i >= W): ONE fused scan body, chunked only at
    # checkpoint boundaries. Round 5: the round-4 driver paid 4-6 host
    # dispatch rounds per frame; this path pays a handful per RUN.
    # (The NOTE on mid-run re-anchoring still stands: snapping the
    # window onto the archive frame at each acceptance measured
    # NEGATIVE in round 3 — correction stays END-OF-RUN via
    # correct_trajectory; Sim3/apply_sim3_map remain tested studies.)
    lo = max(start, W)
    if lo < n:
        from jax import lax

        feats_stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs), *features
        )
        steady = make_steady_step(
            feats_stacked, K, key=key, window=W,
            pts_per_frame=pts_per_frame, n_frames=n,
            ba_every=ba_every, ba_iters=ba_iters, ba_kwargs=ba_kwargs,
            marginalize=marginalize, loop_closure=loop_closure,
            loop_min_gap=loop_min_gap or 0,
            loop_min_inliers=loop_min_inliers,
            loop_cooldown=loop_cooldown, archive_policy=archive_policy,
        )
        scan_fn = jax.jit(functools.partial(lax.scan, steady))
        cur = lo
        while cur < n:
            if ckpt is not None and checkpoint_every:
                end = min(
                    n - 1,
                    ((cur // checkpoint_every) + 1) * checkpoint_every,
                )
            else:
                end = n - 1
            idx = jnp.arange(cur, end + 1, dtype=jnp.int32)
            carry, (fr, ft) = scan_fn((m, used, anc, arch, buf), idx)
            m, used, anc, arch, buf = carry
            frozen_r.append(fr)
            frozen_t.append(ft)
            cur = end + 1
            if (
                ckpt is not None
                and checkpoint_every
                and end % checkpoint_every == 0
            ):
                _save_checkpoint(end)

    # ONE host read drains the device-side loop buffer.
    loop_frames: list[int] = []
    loop_poses: list[ArchiveLoop] = []
    n_dropped = 0
    if loop_closure:
        import numpy as np

        cnt = int(buf.count)
        n_dropped = int(buf.n_dropped)
        frames_np = np.asarray(buf.frames[:cnt])
        for k in range(cnt):
            loop_frames.append(int(frames_np[k]))
            loop_poses.append(
                ArchiveLoop(
                    rvec=buf.rvecs[k], tvec=buf.tvecs[k],
                    n_inliers=buf.inliers[k], birth=buf.births[k],
                )
            )
        if n_dropped > 0:
            import logging

            logging.getLogger(__name__).warning(
                "loop buffer saturated: %d accepted-quality closures "
                "dropped (max_loops=%d) — raise max_loops for this "
                "sequence length",
                n_dropped, max_loops,
            )

    in_window = min(n, W)
    rvecs = jnp.concatenate(frozen_r + [m.rvecs[:in_window]])
    tvecs = jnp.concatenate(frozen_t + [m.tvecs[:in_window]])
    traj = Trajectory(rvecs=rvecs, tvecs=tvecs)
    if loop_closure and loop_frames:
        traj = correct_trajectory(
            traj, loop_frames, loop_poses, loop_weight=loop_weight,
            pgo_iters=pgo_iters,
        )
    if return_info:
        info = {
            "loop_frames": list(loop_frames),
            "loop_inliers": [int(p.n_inliers) for p in loop_poses],
            "loops_dropped": n_dropped,
        }
        return traj, m, info
    return traj, m


class OdometryStream:
    """ONLINE (frame-at-a-time) odometry for serving pipelines.

    :func:`run_odometry` is the batch driver: it scans the fused steady
    step over a pre-extracted feature stack. A serving pipeline receives
    frames one at a time; this wrapper runs the SAME state machine —
    identical jitted functions in identical order, so a streamed
    sequence produces the same trajectory as the batch driver over the
    same features (equivalence-tested) — behind a ``push()`` API with
    one fused device call per frame in the steady state.

    Usage::

        stream = OdometryStream(key, K, window=8, loop_closure=True)
        for feats in source:
            pose = stream.push(feats)     # latest pose estimate (r, t)
        traj, m, info = stream.finish()   # corrected full trajectory

    ``push`` never blocks on device results (poses are returned as lazy
    device arrays); ``finish`` performs the single end-of-run host read
    (loop buffer) + the Sim(3)/SE(3) pose-graph correction, exactly like
    the batch driver's tail. Since the stream length is unknown,
    ``max_loops`` defaults to a fixed 64 (pass a larger cap for
    multi-hour sessions — the buffer costs ~52 bytes/slot).
    """

    def __init__(
        self,
        key,
        K: jax.Array,
        window: int = 8,
        pts_per_frame: int = 128,
        ba_every: int = 2,
        ba_iters: int = 8,
        damping: float = 1e-4,
        huber_delta: float | None = 2.0,
        solver: str = "auto",
        loop_closure: bool = False,
        loop_min_gap: int | None = None,
        loop_min_inliers: int = 25,
        loop_weight: float = 4.0,
        loop_cooldown: int = 3,
        max_loops: int = 64,
        archive_size: int | None = None,
        archive_policy: str = "fifo",
        pgo_iters: int = 15,
        marginalize: bool = True,
    ):
        from sift_parallel_optimization.models.ba import (
            empty_anchors,
            resolve_solver,
        )

        if window < 3:
            raise ValueError("window must be >= 3")
        W = window
        self._key = key
        self._K = K
        self._W = W
        self._B = pts_per_frame
        self._ba_every = ba_every
        self._loop_closure = loop_closure
        self._loop_weight = loop_weight
        self._pgo_iters = pgo_iters
        self._damping = damping
        solver = resolve_solver(W, W * pts_per_frame, solver)
        ba_kwargs: dict = dict(
            damping=damping, huber_delta=huber_delta, solver=solver,
        )
        if solver == "cg":
            ba_kwargs["max_obs_per_point"] = -(-W // 8) * 8
        self._ba_kwargs = ba_kwargs
        self._ba_iters = ba_iters

        self._m = empty_map(W, pts_per_frame, max_loops=0)
        self._used = None
        self._anc = (
            empty_anchors((W - 1) * pts_per_frame) if marginalize else None
        )
        self._arch = None
        self._buf = None
        if loop_closure:
            if loop_min_gap is None:
                loop_min_gap = W + 1
            if archive_size is None:
                archive_size = 64 * pts_per_frame
            self._arch = empty_archive(archive_size)
            self._buf = empty_loop_buffer(max_loops)
        self._i = 0
        self._pending = []          # features awaiting bootstrap
        self._prev_feats = None
        self._frozen_r: list[jax.Array] = []
        self._frozen_t: list[jax.Array] = []
        self._last_ba_i = -1

        self._init_fn = jax.jit(
            functools.partial(init_two_view, pts_per_frame=pts_per_frame)
        )
        self._reg_fn = jax.jit(
            functools.partial(register_frame, pts_per_frame=pts_per_frame)
        )
        self._ba_fn = jax.jit(
            functools.partial(
                bundle_adjust, n_iters=ba_iters, **ba_kwargs
            )
        )
        steady = make_steady_step(
            None, K, key=key, window=W, pts_per_frame=pts_per_frame,
            n_frames=1 << 30, ba_every=ba_every, ba_iters=ba_iters,
            ba_kwargs=ba_kwargs, marginalize=marginalize,
            loop_closure=loop_closure,
            loop_min_gap=loop_min_gap or 0,
            loop_min_inliers=loop_min_inliers,
            loop_cooldown=loop_cooldown, archive_policy=archive_policy,
        )

        def one(carry, i, feats_i, feats_p):
            return steady(carry, (i, feats_i, feats_p))

        self._steady_fn = jax.jit(one)

    def push(self, feats: Features):
        """Feed one frame; returns (rvec, tvec) of its current estimate
        (lazy device arrays — no host sync)."""
        i = self._i
        W = self._W
        if i == 0:
            self._pending.append(feats)
            self._i = 1
            return jnp.zeros(3), jnp.zeros(3)
        if i == 1:
            f0 = self._pending.pop()
            self._m, self._used = self._init_fn(
                jax.random.fold_in(self._key, 0), f0, feats, self._K,
                self._m,
            )
            self._prev_feats = feats
            self._i = 2
            return self._m.rvecs[1], self._m.tvecs[1]
        if i < W:
            # Window-filling: register-only (same path as run_odometry).
            self._m, self._used = self._reg_fn(
                jax.random.fold_in(self._key, i), self._m, feats,
                self._prev_feats, jnp.asarray(i, jnp.int32), self._K,
                self._used,
            )
            if self._ba_every and i % self._ba_every == 0:
                st = self._ba_fn(
                    self._m.ba_state(), self._m.obs, self._K,
                    anchors=self._anc,
                )
                self._m = self._m._replace(
                    rvecs=st.rvecs, tvecs=st.tvecs, points=st.points
                )
                self._last_ba_i = i
            self._prev_feats = feats
            self._i = i + 1
            return self._m.rvecs[i], self._m.tvecs[i]
        carry = (self._m, self._used, self._anc, self._arch, self._buf)
        carry, (fr, ft) = self._steady_fn(
            carry, jnp.asarray(i, jnp.int32), feats, self._prev_feats
        )
        self._m, self._used, self._anc, self._arch, self._buf = carry
        self._frozen_r.append(fr)
        self._frozen_t.append(ft)
        if self._ba_every and i % self._ba_every == 0:
            self._last_ba_i = i
        self._prev_feats = feats
        self._i = i + 1
        return self._m.rvecs[W - 1], self._m.tvecs[W - 1]

    def finish(self):
        """Final BA (if the last frame didn't run one), loop-buffer
        drain, and pose-graph correction — the batch driver's tail.
        Returns (Trajectory, final window map, info dict)."""
        n = self._i
        if n >= 2 and self._ba_every and self._last_ba_i != n - 1:
            # run_odometry always BAs on the final frame (i == n - 1).
            st = self._ba_fn(
                self._m.ba_state(), self._m.obs, self._K,
                anchors=self._anc,
            )
            self._m = self._m._replace(
                rvecs=st.rvecs, tvecs=st.tvecs, points=st.points
            )
        loop_frames: list[int] = []
        loop_poses: list[ArchiveLoop] = []
        n_dropped = 0
        if self._loop_closure and self._buf is not None:
            import numpy as np

            buf = self._buf
            cnt = int(buf.count)
            n_dropped = int(buf.n_dropped)
            frames_np = np.asarray(buf.frames[:cnt])
            for k in range(cnt):
                loop_frames.append(int(frames_np[k]))
                loop_poses.append(
                    ArchiveLoop(
                        rvec=buf.rvecs[k], tvec=buf.tvecs[k],
                        n_inliers=buf.inliers[k], birth=buf.births[k],
                    )
                )
        in_window = min(n, self._W)
        if self._frozen_r:
            # push() collects one (3,) frozen pose per steady frame.
            rvecs = jnp.concatenate(
                [jnp.stack(self._frozen_r), self._m.rvecs[:in_window]]
            )
            tvecs = jnp.concatenate(
                [jnp.stack(self._frozen_t), self._m.tvecs[:in_window]]
            )
        else:
            rvecs = self._m.rvecs[:in_window]
            tvecs = self._m.tvecs[:in_window]
        traj = Trajectory(rvecs=rvecs, tvecs=tvecs)
        if self._loop_closure and loop_frames:
            traj = correct_trajectory(
                traj, loop_frames, loop_poses,
                loop_weight=self._loop_weight,
                pgo_iters=self._pgo_iters, damping=self._damping,
            )
        info = {
            "loop_frames": loop_frames,
            "loops_dropped": n_dropped,
        }
        return traj, self._m, info


def correct_trajectory(
    traj: Trajectory,
    loop_frames: Sequence[int],
    loop_poses: Sequence[ArchiveLoop],
    loop_weight: float = 4.0,
    pgo_iters: int = 15,
    damping: float = 1e-4,
    sim3: bool = True,
) -> Trajectory:
    """Pose-graph-correct a frozen trajectory with absolute loop edges.

    Edges: the odometry chain (consecutive relative poses from the
    estimates — exactly consistent, carrying the accumulated drift) plus
    one edge (0 -> f) per accepted loop whose measurement is the PnP
    pose composed with node 0 (the archive lives in camera-0's frame).

    ``sim3`` (default) optimizes over Sim(3) — per-node scale — which is
    what lets the loop constraints actually SHRINK a scale-drifted
    chain. Loop edges (j != i+1) are flagged METRIC: their translation
    row compares the de-scaled relative translation against the metric
    PnP measurement, so the optimizer itself recovers the accumulated
    scale at the loop endpoint and distributes it along the chain's
    soft scale-prior rows (ORB-SLAM-style essential-graph correction;
    see models/pose_graph_sim3.py, whose round-3 version passed
    rel_log_s = 0 on loops with a scale-blind translation row and was
    provably inert). ``sim3=False`` keeps the SE(3) pose graph
    (models/pose_graph.py, matrix-free CG at large N).
    """
    from sift_parallel_optimization.models.loop_closure import (
        build_pose_graph_edges,
    )
    from sift_parallel_optimization.models.geometry import Camera

    n = traj.rvecs.shape[0]
    # Anchor each loop edge at the median inlier birth frame (see
    # propose_archive_loop) — clamped to stay a genuine backward edge.
    sources = [
        min(max(int(getattr(p, "birth", 0)), 0), max(int(f) - 2, 0))
        for f, p in zip(loop_frames, loop_poses)
    ]
    edges = build_pose_graph_edges(
        traj, n, list(loop_frames),
        [Camera(rvec=p.rvec, tvec=p.tvec) for p in loop_poses],
        loop_weight=loop_weight,
        loop_sources=sources,
    )
    if sim3:
        from sift_parallel_optimization.models.pose_graph_sim3 import (
            Sim3Edges,
            optimize_sim3_graph,
            se3_to_sim3_poses,
            sim3_to_se3_poses,
        )

        metric = (
            (edges.j != edges.i + 1) & (edges.weight > 0)
        ).astype(jnp.float32)
        s_edges = Sim3Edges(
            i=edges.i, j=edges.j, rel_rvec=edges.rel_rvec,
            rel_tvec=edges.rel_tvec,
            rel_log_s=jnp.zeros_like(edges.weight),
            weight=edges.weight,
            metric=metric,
        )
        # Off-chain edge count is host-known here, so "auto" above the
        # dense limit takes the exact O(n) chain+Woodbury solver (the
        # dense (7N, 7N) solve is quadratic-memory; see
        # pose_graph_sim3.resolve_sim3_solver). Damping scales down
        # with length so the global ramp mode is not frozen
        # (pose_graph_sim3.chain_damping).
        from sift_parallel_optimization.models.pose_graph_sim3 import (
            chain_damping,
        )

        cap = max(len(loop_frames), 1)
        out = jax.jit(
            lambda p, e: optimize_sim3_graph(
                p, e, n_iters=pgo_iters,
                damping=chain_damping(n, damping),
                offchain_cap=cap,
            )
        )(se3_to_sim3_poses(traj.rvecs, traj.tvecs), s_edges)
        rv, tv = sim3_to_se3_poses(out)
        return Trajectory(rvecs=rv, tvecs=tv)
    from sift_parallel_optimization.models.pose_graph import (
        Poses,
        chain_damping as se3_chain_damping,
        optimize_pose_graph,
    )

    poses = Poses(rvecs=traj.rvecs, tvecs=traj.tvecs)
    cap = max(len(loop_frames), 1)
    out = jax.jit(
        lambda p, e: optimize_pose_graph(
            p, e, n_iters=pgo_iters,
            damping=se3_chain_damping(n, damping),
            offchain_cap=cap,
        )
    )(poses, edges)
    return Trajectory(rvecs=out.rvecs, tvecs=out.tvecs)
