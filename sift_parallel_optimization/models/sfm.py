"""Incremental structure-from-motion (small scene, single host).

North-star extension (BASELINE.json config 4: "incremental triangulation +
bundle adjustment on ~50 keyframes"). Static-shape structure:

* The map has FIXED capacities (cameras, points, observations) with valid
  masks; every frame owns statically-placed slot blocks (frame i writes
  points into [i*B, (i+1)*B) and observations into fixed blocks), so every
  jitted step sees static shapes and the incremental loop is a plain
  Python orchestration over jit-compiled kernels.
* PnP registration is BATCHED RANSAC like models/matching.py: all minimal
  6-point hypotheses are solved (vmapped DLT + GN refine) and scored in
  one shot.
* New landmarks are triangulated against the previous keyframe with
  cheirality + reprojection gating; descriptors are cached per landmark
  for 2D-3D matching of later frames.
* Refinement is the Schur-complement BA of models/ba.py (or its
  distributed version in parallel/ba.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from sift_parallel_optimization.models.ba import (
    BAState,
    Observations,
    bundle_adjust,
    resolve_solver,
)
from sift_parallel_optimization.models.frontend import Features
from sift_parallel_optimization.models.geometry import (
    Camera,
    essential_from_fundamental,
    pnp_dlt,
    project,
    recover_pose,
    refine_pose,
    reprojection_error,
    rodrigues,
    triangulate,
)
from sift_parallel_optimization.models.matching import (
    match_descriptors,
    matched_points,
    ransac_fundamental,
)


class SfmMap(NamedTuple):
    """Fixed-capacity incremental map (capacities are static)."""

    rvecs: jax.Array      # (C, 3)
    tvecs: jax.Array      # (C, 3)
    cam_valid: jax.Array  # (C,)
    points: jax.Array     # (P, 3)
    pt_valid: jax.Array   # (P,)
    pt_desc: jax.Array    # (P, 128) descriptor of first observation
    obs: Observations     # capacity M observations

    def n_cameras(self) -> jax.Array:
        return self.cam_valid.sum()

    def n_points(self) -> jax.Array:
        return self.pt_valid.sum()

    def ba_state(self) -> BAState:
        return BAState(rvecs=self.rvecs, tvecs=self.tvecs, points=self.points)


def _empty_obs(capacity: int) -> Observations:
    return Observations(
        cam_idx=jnp.zeros(capacity, jnp.int32),
        pt_idx=jnp.zeros(capacity, jnp.int32),
        uv=jnp.zeros((capacity, 2), jnp.float32),
        valid=jnp.zeros(capacity, bool),
    )


def empty_map(
    n_cams: int, pts_per_frame: int, max_loops: int = 8
) -> SfmMap:
    """Capacities: P = n_cams * pts_per_frame, M = 3 * P + max_loops * B
    (each point gets up to one obs at birth in two frames + one PnP obs
    per later frame, amortized to 3 blocks per frame — see block layout in
    the writers; accepted loop closures append up to ``max_loops`` extra
    blocks of 2D-3D re-observations of old landmarks)."""
    C = n_cams
    P = n_cams * pts_per_frame
    M = 3 * P + max_loops * pts_per_frame
    return SfmMap(
        rvecs=jnp.zeros((C, 3), jnp.float32),
        tvecs=jnp.zeros((C, 3), jnp.float32),
        cam_valid=jnp.zeros(C, bool),
        points=jnp.zeros((P, 3), jnp.float32),
        pt_valid=jnp.zeros(P, bool),
        pt_desc=jnp.zeros((P, 128), jnp.float32),
        obs=_empty_obs(M),
    )


def _write_obs_block(
    obs: Observations, start, cam, pt_idx, uv, valid
) -> Observations:
    """Write a contiguous observation block at (possibly traced) ``start``.

    `dynamic_update_slice` keeps the op traceable with a runtime offset, so
    ONE compiled executable serves every frame index (the incremental loop
    does not recompile per frame).
    """
    from jax import lax

    n = pt_idx.shape[0]
    start = jnp.asarray(start, jnp.int32)

    def upd(arr, vals):
        return lax.dynamic_update_slice_in_dim(
            arr, vals.astype(arr.dtype), start, axis=0
        )

    return Observations(
        cam_idx=upd(obs.cam_idx, jnp.full(n, cam, jnp.int32)),
        pt_idx=upd(obs.pt_idx, pt_idx.astype(jnp.int32)),
        uv=upd(obs.uv, uv),
        valid=upd(obs.valid, valid),
    )


# ---------------------------------------------------------------------------
# Two-view bootstrap
# ---------------------------------------------------------------------------


def init_two_view(
    key,
    f0: Features,
    f1: Features,
    K: jax.Array,
    m: SfmMap,
    pts_per_frame: int,
    max_reproj: float = 2.0,
    slot_a=0,
    slot_b=1,
    return_used_pair: bool = False,
) -> tuple[SfmMap, jax.Array]:
    """Bootstrap the map from a frame pair: F -> E -> (R, t) -> triangulate.

    Writes cameras ``slot_a``/``slot_b`` (defaults 0/1 — the sequential
    driver), point block ``slot_a``, and two observation blocks in
    frame ``slot_a``'s block region (3*slot_a*B + {0, B} — slots a
    never-registered bootstrap frame leaves free). Keeps at most
    ``pts_per_frame`` best landmarks (static top-k). Camera ``slot_a``
    gets the identity pose; when slot_a != 0, BA's camera-0 gauge has
    nothing to fix until frame 0 registers — Marquardt damping keeps
    the interim iterations well-posed (covisibility-order driver,
    round 5).

    Returns (map, used_b), or (map, used_a, used_b) with
    ``return_used_pair`` — the masks of each frame's keypoints consumed
    by bootstrap landmarks, so a later frame triangulating against
    either bootstrap frame does not duplicate them.
    """
    match = match_descriptors(
        f0.descriptors, f1.descriptors,
        f0.keypoints.valid, f1.keypoints.valid,
    )
    p0, p1, pair_ok = matched_points(f0.keypoints, f1.keypoints, match)
    res = ransac_fundamental(key, p0, p1, pair_ok, n_hypotheses=512)
    E = essential_from_fundamental(res.model, K)
    R, t, X, front = recover_pose(E, p0, p1, K, res.inliers)

    from sift_parallel_optimization.models.geometry import rotation_log

    rvec1 = rotation_log(R)
    # Gate: in front of both cameras + reprojection error in both views.
    e0 = reprojection_error(Camera(jnp.zeros(3), jnp.zeros(3)), X, p0, K)
    e1 = reprojection_error(Camera(rvec1, t), X, p1, K)
    good = front & (e0 < max_reproj) & (e1 < max_reproj)
    score = jnp.where(good, match.similarity, -jnp.inf)
    _, keep = jax.lax.top_k(score, pts_per_frame)
    keep_ok = jnp.isfinite(jnp.take(score, keep))

    B = pts_per_frame
    slot_a = jnp.asarray(slot_a, jnp.int32)
    slot_b = jnp.asarray(slot_b, jnp.int32)
    pt_idx = slot_a * B + jnp.arange(pts_per_frame)
    m = m._replace(
        rvecs=m.rvecs.at[slot_b].set(rvec1),
        tvecs=m.tvecs.at[slot_b].set(t),
        cam_valid=m.cam_valid.at[slot_a].set(True).at[slot_b].set(True),
        points=m.points.at[pt_idx].set(X[keep]),
        pt_valid=m.pt_valid.at[pt_idx].set(keep_ok),
        pt_desc=m.pt_desc.at[pt_idx].set(f0.descriptors[keep]),
    )
    obs = _write_obs_block(
        m.obs, 3 * slot_a * B, slot_a, pt_idx, p0[keep], keep_ok
    )
    obs = _write_obs_block(
        obs, 3 * slot_a * B + B, slot_b, pt_idx, p1[keep], keep_ok
    )
    k1 = f1.keypoints.valid.shape[0]
    used_b = jnp.zeros(k1, bool).at[
        jnp.where(keep_ok, match.idx2[keep], k1)
    ].set(True, mode="drop")
    if not return_used_pair:
        return m._replace(obs=obs), used_b
    k0 = f0.keypoints.valid.shape[0]
    used_a = jnp.zeros(k0, bool).at[
        jnp.where(keep_ok, keep, k0)
    ].set(True, mode="drop")
    return m._replace(obs=obs), used_a, used_b


# ---------------------------------------------------------------------------
# PnP RANSAC registration
# ---------------------------------------------------------------------------


def ransac_pnp(
    key,
    pts3d: jax.Array,
    pts2d: jax.Array,
    mask: jax.Array,
    K: jax.Array,
    n_hypotheses: int = 128,
    threshold: float = 3.0,
) -> tuple[Camera, jax.Array, jax.Array]:
    """Batched-hypothesis PnP: (cam, inliers, n_inliers)."""
    from sift_parallel_optimization.models.matching import _sample_indices

    idx = _sample_indices(key, mask, n_hypotheses, 6)   # (N, 6)

    # Gather each minimal sample's 6 points instead of one-hot weighting
    # the full set: the DLT design is (12, 12) per hypothesis, not
    # (2*P, 12) — same solution up to f32 summation order.
    p3 = pts3d[idx]                                      # (N, 6, 3)
    p2 = pts2d[idx]                                      # (N, 6, 2)

    def solve(p3i, p2i):
        cam = pnp_dlt(p3i, p2i, K, jnp.ones(6))
        return jnp.concatenate([cam.rvec, cam.tvec])

    thetas = jax.vmap(solve)(p3, p2)                     # (N, 6)
    ok = jnp.all(jnp.isfinite(thetas), axis=-1)
    thetas = jnp.where(ok[:, None], thetas, 0.0)

    def score(theta):
        uv, z = project(pts3d, theta[:3], theta[3:], K)
        err = jnp.linalg.norm(uv - pts2d, axis=-1)
        return (err < threshold) & (z > 0) & mask

    inl = jax.vmap(score)(thetas)                        # (N, K)
    counts = jnp.where(ok, inl.sum(-1), -1)
    best = jnp.argmax(counts)
    cam = Camera(rvec=thetas[best, :3], tvec=thetas[best, 3:])
    cam = refine_pose(
        cam, pts3d, pts2d, K, inl[best].astype(jnp.float32), n_iters=5,
        solver="lu",  # batch-1: one fused LU beats the block recursion
    )
    uv, z = project(pts3d, cam.rvec, cam.tvec, K)
    err = jnp.linalg.norm(uv - pts2d, axis=-1)
    inliers = (err < threshold) & (z > 0) & mask
    return cam, inliers, inliers.sum()


# ---------------------------------------------------------------------------
# Frame registration
# ---------------------------------------------------------------------------


def register_frame(
    key,
    m: SfmMap,
    feats: Features,
    prev_feats: Features,
    frame_i: int,
    K: jax.Array,
    prev_used: jax.Array,
    pts_per_frame: int,
    max_reproj: float = 2.0,
    local_window: int | None = None,
    partner_i=None,
) -> tuple[SfmMap, jax.Array]:
    """Register frame ``frame_i`` (>= 2): PnP against the map, then
    triangulate fresh landmarks against its PARTNER frame.

    ``partner_i`` is the triangulation partner's frame slot (default
    ``frame_i - 1`` — the sequential driver; the covisibility-order
    driver passes each frame's most-covisible registered frame, with
    ``prev_feats`` being THAT frame's features).

    ``prev_used`` marks the partner frame's keypoints already associated
    with map landmarks (PnP inliers or new-landmark births) — those are
    excluded from fresh triangulation so an existing landmark whose match
    missed the PnP inlier set is not duplicated. Returns the map and this
    frame's own used mask for the next call.

    ``local_window`` restricts PnP matching to landmarks born within the
    last ``local_window`` frames (local-map odometry — O(window) matching
    for long sequences; pair it with loop closure to re-associate against
    the old map, models/loop_closure.py). None = global matching.

    Static block layout (B = pts_per_frame):
      * points block  [frame_i*B, (frame_i+1)*B)          — new landmarks
      * obs block 3*frame_i*B + [0, B)                    — PnP (2D-3D) obs
      * obs block 3*frame_i*B + [B, 2B)                   — new pts, this frame
      * obs block 3*frame_i*B + [2B, 3B)                  — new pts, prev frame
    """
    B = pts_per_frame
    if partner_i is None:
        partner_i = frame_i - 1
    partner_i = jnp.asarray(partner_i, jnp.int32)
    k_pnp, k_tri = jax.random.split(key)

    # --- 2D-3D: match this frame's descriptors against landmark descriptors.
    pt_bank = m.pt_valid
    if local_window is not None:
        birth = jnp.arange(m.points.shape[0], dtype=jnp.int32) // B
        pt_bank = pt_bank & (
            birth >= jnp.asarray(frame_i, jnp.int32) - local_window
        )
    m3 = match_descriptors(
        feats.descriptors, m.pt_desc, feats.keypoints.valid, pt_bank
    )
    uv = jnp.stack([feats.keypoints.x, feats.keypoints.y], -1)   # (K, 2)
    pts3d = m.points[m3.idx2]
    mask3 = m3.valid & pt_bank[m3.idx2]
    cam, inl, _n = ransac_pnp(k_pnp, pts3d, uv, mask3, K)

    m = m._replace(
        rvecs=m.rvecs.at[frame_i].set(cam.rvec),
        tvecs=m.tvecs.at[frame_i].set(cam.tvec),
        cam_valid=m.cam_valid.at[frame_i].set(True),
    )
    # PnP observations (cap to B by similarity-ranked top-k).
    score = jnp.where(inl, m3.similarity, -jnp.inf)
    _, keep = jax.lax.top_k(score, B)
    keep_ok = jnp.isfinite(jnp.take(score, keep))
    obs = _write_obs_block(
        m.obs, 3 * frame_i * B, frame_i, m3.idx2[keep], uv[keep], keep_ok
    )
    # Refresh matched landmarks' descriptors with the CURRENT view:
    # descriptors frozen at first observation stop matching once the
    # viewpoint drifts; last-inlier-view descriptors track appearance.
    refresh_idx = jnp.where(keep_ok, m3.idx2[keep], m.pt_desc.shape[0])
    new_desc = feats.descriptors[keep]
    m = m._replace(
        pt_desc=m.pt_desc.at[refresh_idx].set(
            new_desc, mode="drop"
        )
    )

    # --- 2D-2D vs previous frame: triangulate new landmarks.
    m2 = match_descriptors(
        prev_feats.descriptors, feats.descriptors,
        prev_feats.keypoints.valid, feats.keypoints.valid,
    )
    p_prev, p_cur, pair_ok = matched_points(
        prev_feats.keypoints, feats.keypoints, m2
    )
    # Exclude keypoints already explained by the map: a current keypoint
    # used as an inlier PnP obs is not "new", and a PREV-frame keypoint
    # already associated with a landmark (prev_used) must not seed a
    # duplicate — even when its map match missed this frame's PnP inliers.
    used = jnp.zeros(uv.shape[0], bool).at[keep].set(keep_ok)
    fresh = pair_ok & ~used[m2.idx2] & ~prev_used

    prev_cam = Camera(m.rvecs[partner_i], m.tvecs[partner_i])
    P_prev = prev_cam.matrix(K)
    P_cur = cam.matrix(K)
    X = triangulate(P_prev, P_cur, p_prev, p_cur)
    z_prev = (X @ rodrigues(prev_cam.rvec).T + prev_cam.tvec)[:, 2]
    z_cur = (X @ rodrigues(cam.rvec).T + cam.tvec)[:, 2]
    e_prev = reprojection_error(prev_cam, X, p_prev, K)
    e_cur = reprojection_error(cam, X, p_cur, K)
    good = (
        fresh & (z_prev > 0) & (z_cur > 0)
        & (e_prev < max_reproj) & (e_cur < max_reproj)
    )
    score2 = jnp.where(good, m2.similarity, -jnp.inf)
    _, keep2 = jax.lax.top_k(score2, B)
    keep2_ok = jnp.isfinite(jnp.take(score2, keep2))

    pt_idx = frame_i * B + jnp.arange(B)
    m = m._replace(
        points=m.points.at[pt_idx].set(X[keep2]),
        pt_valid=m.pt_valid.at[pt_idx].set(keep2_ok),
        pt_desc=m.pt_desc.at[pt_idx].set(feats.descriptors[m2.idx2[keep2]]),
    )
    obs = _write_obs_block(
        obs, 3 * frame_i * B + B, frame_i,
        pt_idx, p_cur[keep2], keep2_ok,
    )
    obs = _write_obs_block(
        obs, 3 * frame_i * B + 2 * B, partner_i,
        pt_idx, p_prev[keep2], keep2_ok,
    )
    kc = uv.shape[0]
    used_cur = used.at[
        jnp.where(keep2_ok, m2.idx2[keep2], kc)
    ].set(True, mode="drop")
    return m._replace(obs=obs), used_cur


# ---------------------------------------------------------------------------
# Incremental driver
# ---------------------------------------------------------------------------


def run_sfm(
    key,
    features: Sequence[Features],
    K: jax.Array,
    pts_per_frame: int = 128,
    ba_every: int = 4,
    final_ba_iters: int = 15,
    damping: float = 1e-4,
    huber_delta: float | None = 2.0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    loop_closure: bool = True,
    loop_min_gap: int = 5,
    loop_min_inliers: int = 30,
    loop_weight: float = 4.0,
    max_loops: int = 8,
    pgo_mesh=None,
    local_window: int | None = None,
    solver: str = "auto",
    pair_selection: str = "sequential",
    pair_mesh=None,
) -> SfmMap:
    """Full incremental pipeline over a list of per-frame features.

    ``pair_selection``: "sequential" (default) registers frame i against
    frame i-1 — correct for temporally-ordered captures.
    "covisibility" first builds the (F, F) pairwise match-count table
    (parallel/matching.pairwise_match_counts, or the ring-sharded
    ring_pairwise_match_counts when ``pair_mesh`` is given — the
    distributed place-recognition sweep) and registers frames in
    maximum-covisibility spanning-tree order, each against its most
    covisible already-registered PARTNER
    (parallel/matching.covisibility_order) — what makes shuffled or
    unordered photo sets reconstructable at all (tested: the round-5
    shuffled-sequence gate, where sequential registration fails
    outright). Checkpointing currently requires sequential order.

    Python orchestration over jitted steps (each step has static shapes;
    `jit` caches one executable per frame index pattern).

    With ``checkpoint_dir`` set, the map is saved every
    ``checkpoint_every`` frames and the run RESUMES from the latest
    checkpoint if one exists — restartable steps for long sequences
    (the failure-recovery subsystem, utils/checkpoint.py).

    With ``loop_closure`` (default), every frame past ``loop_min_gap + 2``
    is PnP-matched against landmarks born >= ``loop_min_gap`` frames
    earlier (models/loop_closure.py); accepted constraints feed a
    pose-graph optimization + landmark re-anchoring before the final BA.
    ``pgo_mesh`` routes the PGO through the edge-sharded distributed
    solver (parallel/pose_graph.distributed_pgo).

    ``local_window`` switches registration to local-map odometry (PnP
    only against landmarks born within the window — O(window) matching
    for long sequences); loop closure then carries the burden of
    re-associating revisited places against the old map.

    ``solver`` selects the BA Schur solver ("auto" resolves from the map
    capacities — models/ba.py resolve_solver: the north-star ~50-frame
    scene takes the implicit-Schur CG path with analytic Jacobians, tiny
    scenes keep the bit-stable dense solve). The CG group capacity is the
    structural bound on observations per landmark in this driver's block
    layout: 2 birth obs + at most one PnP re-observation per later frame
    + up to ``max_loops`` loop re-observations -> n + max_loops.
    """
    import functools

    n = len(features)
    m = empty_map(n, pts_per_frame, max_loops=max_loops)
    keys = jax.random.split(key, n)
    loop_keys = jax.random.split(jax.random.fold_in(key, 7), n)

    # Config fingerprint: refuses to resume a checkpoint written by a
    # differently-configured run (ADVICE round 1 — shape coincidences can
    # otherwise silently resume another sequence's map).
    ckpt_meta = {
        "n_frames": n,
        "pts_per_frame": pts_per_frame,
        "desc_capacity": int(features[0].descriptors.shape[0]),
    }
    start_frame = 2
    if checkpoint_dir is not None:
        from sift_parallel_optimization.utils import checkpoint as ckpt

        step = ckpt.latest_step(checkpoint_dir)
        if step is not None:
            m, step = ckpt.load_pytree(checkpoint_dir, m, meta=ckpt_meta)
            start_frame = step + 1

    # One executable per step kind: frame index and block offsets are
    # traced, so every frame reuses the same compiled register step.
    init_fn = jax.jit(
        functools.partial(init_two_view, pts_per_frame=pts_per_frame)
    )
    reg_fn = jax.jit(
        functools.partial(
            register_frame,
            pts_per_frame=pts_per_frame,
            local_window=local_window,
        )
    )
    solver = resolve_solver(n, n * pts_per_frame, solver)
    ba_kwargs: dict = dict(
        damping=damping, huber_delta=huber_delta, solver=solver,
    )
    if solver == "cg":
        # Structural per-landmark observation bound (see docstring),
        # rounded up to the sublane multiple.
        ba_kwargs["max_obs_per_point"] = -(-(n + max_loops) // 8) * 8
    ba_mid = jax.jit(
        functools.partial(bundle_adjust, n_iters=5, **ba_kwargs)
    )
    ba_final = jax.jit(
        functools.partial(
            bundle_adjust, n_iters=final_ba_iters, **ba_kwargs
        )
    )

    if loop_closure:
        from sift_parallel_optimization.models.loop_closure import (
            close_loops,
            propose_loop_closure,
            write_loop_observations,
        )

        loop_fn = jax.jit(
            functools.partial(
                propose_loop_closure,
                pts_per_frame=pts_per_frame,
                min_gap=loop_min_gap,
            )
        )
        loop_write_fn = jax.jit(
            functools.partial(
                write_loop_observations, pts_per_frame=pts_per_frame
            )
        )
    loop_frames: list[int] = []
    loop_poses: list[Camera] = []

    if pair_selection == "covisibility":
        if checkpoint_dir is not None:
            raise ValueError(
                "pair_selection='covisibility' does not support "
                "checkpointing (resume assumes sequential frame order)"
            )
        return _run_sfm_covisibility(
            keys, loop_keys, features, K, m,
            pts_per_frame=pts_per_frame, ba_every=ba_every,
            init_fn=init_fn, reg_fn=reg_fn, ba_mid=ba_mid,
            ba_final=ba_final, pair_mesh=pair_mesh,
            loop_closure=loop_closure,
            loop_fn=loop_fn if loop_closure else None,
            loop_write_fn=loop_write_fn if loop_closure else None,
            loop_min_gap=loop_min_gap,
            loop_min_inliers=loop_min_inliers,
            loop_weight=loop_weight, max_loops=max_loops,
            pgo_mesh=pgo_mesh,
        )
    if pair_selection != "sequential":
        raise ValueError(
            f"pair_selection must be 'sequential' or 'covisibility', "
            f"got {pair_selection!r}"
        )

    # Per-frame keypoint-used mask (duplicate-landmark suppression). After
    # a checkpoint resume the previous frame's mask is unknown — start
    # conservative (all-unused; at worst one frame may birth duplicates).
    used = jnp.zeros(features[0].keypoints.valid.shape[0], bool)
    if start_frame == 2:
        m, used = init_fn(keys[0], features[0], features[1], K, m)
    for i in range(start_frame, n):
        m, used = reg_fn(
            keys[i], m, features[i], features[i - 1],
            jnp.asarray(i, jnp.int32), K, used,
        )
        if loop_closure and i >= loop_min_gap + 2:
            prop = loop_fn(
                loop_keys[i], features[i], m, jnp.asarray(i, jnp.int32), K
            )
            if (
                int(prop.n_inliers) >= loop_min_inliers
                and len(loop_frames) < max_loops
            ):
                m = loop_write_fn(
                    m, prop, jnp.asarray(i, jnp.int32),
                    jnp.asarray(len(loop_frames), jnp.int32),
                )
                loop_frames.append(i)
                loop_poses.append(Camera(rvec=prop.rvec, tvec=prop.tvec))
        if ba_every and (i % ba_every == 0 or i == n - 1):
            st = ba_mid(m.ba_state(), m.obs, K)
            m = m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)
        if checkpoint_dir is not None and checkpoint_every and (
            i % checkpoint_every == 0 or i == n - 1
        ):
            from sift_parallel_optimization.utils import checkpoint as ckpt

            ckpt.save_pytree(checkpoint_dir, m, step=i, meta=ckpt_meta)
    if loop_closure and loop_frames:
        m = close_loops(
            m, n, loop_frames, loop_poses, pts_per_frame,
            loop_weight=loop_weight, mesh=pgo_mesh,
        )
    st = ba_final(m.ba_state(), m.obs, K)
    return m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)


def _run_sfm_covisibility(
    keys, loop_keys, features, K, m, *,
    pts_per_frame, ba_every, init_fn, reg_fn, ba_mid, ba_final,
    pair_mesh, loop_closure, loop_fn, loop_write_fn, loop_min_gap,
    loop_min_inliers, loop_weight, max_loops, pgo_mesh,
):
    """Covisibility-order registration (run_sfm pair_selection mode).

    The ring-matching pair table becomes the production pair-selection
    input (SURVEY section-5 promise: sharded matching FOR SfM pair
    selection): frames register in maximum-spanning-tree order against
    their most covisible partner, so unordered captures reconstruct
    where strictly-sequential registration fails outright. Frame ids
    keep their original slots (the block layout is order-independent),
    so downstream BA / loop closure / trajectory indexing are untouched.
    """
    import numpy as np

    from sift_parallel_optimization.models.loop_closure import (
        close_loops,
    )
    from sift_parallel_optimization.parallel.matching import (
        covisibility_order,
        pairwise_match_counts,
        ring_pairwise_match_counts,
    )

    n = len(features)
    desc = jnp.stack([f.descriptors for f in features])
    val = jnp.stack([f.keypoints.valid for f in features])
    if pair_mesh is not None:
        table = ring_pairwise_match_counts(pair_mesh, desc, val)
    else:
        table = jax.jit(pairwise_match_counts)(desc, val)
    order, partner = covisibility_order(np.asarray(table))

    a, b = order[0], order[1]
    # return_used_pair changes the RETURN STRUCTURE — bind it statically
    # in the partial (a traced jit kwarg cannot steer Python control
    # flow).
    import functools

    init_pair = jax.jit(
        functools.partial(
            init_two_view, pts_per_frame=pts_per_frame,
            return_used_pair=True,
        )
    )
    m, used_a, used_b = init_pair(
        keys[0], features[a], features[b], K, m,
        slot_a=jnp.asarray(a, jnp.int32),
        slot_b=jnp.asarray(b, jnp.int32),
    )
    del init_fn
    used = {a: used_a, b: used_b}
    loop_frames: list[int] = []
    loop_poses: list[Camera] = []
    for pos, f in enumerate(order[2:], start=2):
        p = partner[f]
        m, used_f = reg_fn(
            keys[f], m, features[f], features[p],
            jnp.asarray(f, jnp.int32), K, used[p],
            partner_i=jnp.asarray(p, jnp.int32),
        )
        used[f] = used_f
        if loop_closure and pos >= loop_min_gap + 2:
            prop = loop_fn(
                loop_keys[f], features[f], m, jnp.asarray(f, jnp.int32), K
            )
            if (
                int(prop.n_inliers) >= loop_min_inliers
                and len(loop_frames) < max_loops
            ):
                m = loop_write_fn(
                    m, prop, jnp.asarray(f, jnp.int32),
                    jnp.asarray(len(loop_frames), jnp.int32),
                )
                loop_frames.append(f)
                loop_poses.append(Camera(rvec=prop.rvec, tvec=prop.tvec))
        if ba_every and (pos % ba_every == 0 or pos == n - 1):
            st = ba_mid(m.ba_state(), m.obs, K)
            m = m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)
    if loop_closure and loop_frames:
        m = close_loops(
            m, n, loop_frames, loop_poses, pts_per_frame,
            loop_weight=loop_weight, mesh=pgo_mesh,
        )
    st = ba_final(m.ba_state(), m.obs, K)
    return m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)
