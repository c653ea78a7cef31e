"""Loop closure: place recognition + pose-graph correction for the SfM
driver.

North-star back-end component (BASELINE.json config 5); no analogue in the
reference (which stops at the DoG pyramid — SURVEY.md). Static-shape form:

* Place recognition IS the MXU brute-force matcher (models/matching.py):
  the current frame's descriptors are matched against the landmark bank
  RESTRICTED to old map blocks (landmarks born >= ``min_gap`` frames ago —
  block ownership is static, models/sfm.py), one masked (K, P) matmul.
* The loop constraint is a PnP RANSAC pose against those old landmarks —
  metric scale comes from the map for free, resolving the monocular
  scale ambiguity that a 2D-2D essential-matrix edge would leave open.
* Constraints feed the pose graph (models/pose_graph.py) as edges
  anchored at node 0 (the PnP pose is absolute in the old-map frame,
  which IS camera 0's frame); odometry edges come from the current
  incremental estimates. After PGO, landmarks are re-anchored by their
  birth keyframe's pose correction and a final BA polishes everything.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_parallel_optimization.models.frontend import Features
from sift_parallel_optimization.models.geometry import (
    Camera,
    rodrigues,
)
from sift_parallel_optimization.models.matching import match_descriptors
from sift_parallel_optimization.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    optimize_pose_graph,
    relative_pose,
)
from sift_parallel_optimization.models.sfm import SfmMap, ransac_pnp


class LoopProposal(NamedTuple):
    rvec: jax.Array       # (3,) PnP pose of the query frame vs the old map
    tvec: jax.Array       # (3,)
    n_inliers: jax.Array  # () i32 — host gates acceptance on this
    pt_idx: jax.Array     # (B,) matched old-landmark indices (top inliers)
    uv: jax.Array         # (B, 2) their pixel observations in this frame
    valid: jax.Array      # (B,) slot mask


def propose_loop_closure(
    key,
    feats: Features,
    m: SfmMap,
    frame_i,
    K: jax.Array,
    pts_per_frame: int,
    min_gap: int = 4,
    threshold: float = 3.0,
) -> LoopProposal:
    """PnP the current frame against landmarks born >= min_gap frames ago.

    Jittable with a traced ``frame_i``; acceptance (n_inliers >= bar) is
    the caller's host-side decision, like the rest of the incremental
    driver's orchestration. The top ``pts_per_frame`` inlier matches come
    back as ready-to-write observations: a loop closure only constrains
    the bundle when its 2D-3D re-associations enter the measurement graph
    (``write_loop_observations``), not just the pose-graph initialization.
    """
    P = m.points.shape[0]
    birth_frame = jnp.arange(P, dtype=jnp.int32) // pts_per_frame
    old = m.pt_valid & (
        birth_frame <= jnp.asarray(frame_i, jnp.int32) - min_gap
    )
    match = match_descriptors(
        feats.descriptors, m.pt_desc, feats.keypoints.valid, old
    )
    uv = jnp.stack([feats.keypoints.x, feats.keypoints.y], -1)
    pts3d = m.points[match.idx2]
    mask = match.valid & old[match.idx2]
    cam, inl, n = ransac_pnp(key, pts3d, uv, mask, K, threshold=threshold)
    score = jnp.where(inl, match.similarity, -jnp.inf)
    _, keep = jax.lax.top_k(score, pts_per_frame)
    keep_ok = jnp.isfinite(jnp.take(score, keep))
    return LoopProposal(
        rvec=cam.rvec,
        tvec=cam.tvec,
        n_inliers=n,
        pt_idx=match.idx2[keep],
        uv=uv[keep],
        valid=keep_ok,
    )


def write_loop_observations(
    m: SfmMap, prop: LoopProposal, frame_i, loop_slot, pts_per_frame: int
) -> SfmMap:
    """Append an accepted loop's 2D-3D matches as observation block
    ``loop_slot`` in the loop region of the obs list (models/sfm.py
    ``empty_map`` reserves max_loops blocks past the per-frame layout)."""
    from sift_parallel_optimization.models.sfm import _write_obs_block

    B = pts_per_frame
    C = m.rvecs.shape[0]
    start = 3 * C * B + jnp.asarray(loop_slot, jnp.int32) * B
    obs = _write_obs_block(
        m.obs, start, jnp.asarray(frame_i, jnp.int32),
        prop.pt_idx, prop.uv, prop.valid,
    )
    return m._replace(obs=obs)


def build_pose_graph_edges(
    m: SfmMap,
    n_frames: int,
    loop_frames: list[int],
    loop_poses: list[Camera],
    capacity: int | None = None,
    loop_weight: float = 4.0,
    loop_sources: list[int] | None = None,
) -> PoseGraphEdges:
    """Odometry chain from the current estimates + loop edges.

    Each accepted loop becomes an edge (loop_sources[k] -> loop_frames[k])
    whose measurement is the PnP pose composed with the source node's
    estimate. ``loop_sources`` defaults to node 0 for every loop (the
    PnP pose is absolute in camera-0's frame); the odometry driver
    passes each loop's median inlier BIRTH frame instead — the archived
    landmarks carry the trajectory error accumulated up to their birth,
    and a (birth -> f) relative edge cancels that common error to first
    order where a 0-anchored absolute edge bakes it in (see
    models/odometry.propose_archive_loop, round-4 120-frame measurement).
    """
    if capacity is None:
        capacity = (n_frames - 1) + max(len(loop_frames), 1)
    if loop_sources is None:
        loop_sources = [0] * len(loop_frames)
    src, dst, rel_r, rel_t, w = [], [], [], [], []
    for i in range(n_frames - 1):
        rr, rt = relative_pose(
            m.rvecs[i], m.tvecs[i], m.rvecs[i + 1], m.tvecs[i + 1]
        )
        src.append(i)
        dst.append(i + 1)
        rel_r.append(rr)
        rel_t.append(rt)
        w.append(1.0)
    for fi, cam, sb in zip(loop_frames, loop_poses, loop_sources):
        sb = int(sb)
        rr, rt = relative_pose(
            m.rvecs[sb], m.tvecs[sb], cam.rvec, cam.tvec
        )
        src.append(sb)
        dst.append(int(fi))
        rel_r.append(rr)
        rel_t.append(rt)
        w.append(loop_weight)
    pad = capacity - len(src)
    if pad < 0:
        raise ValueError(f"edge capacity {capacity} < {len(src)} edges")
    src += [0] * pad
    dst += [0] * pad
    rel_r += [jnp.zeros(3)] * pad
    rel_t += [jnp.zeros(3)] * pad
    w += [0.0] * pad
    return PoseGraphEdges(
        i=jnp.asarray(src, jnp.int32),
        j=jnp.asarray(dst, jnp.int32),
        rel_rvec=jnp.stack(rel_r).astype(jnp.float32),
        rel_tvec=jnp.stack(rel_t).astype(jnp.float32),
        weight=jnp.asarray(w, jnp.float32),
    )


def apply_pose_correction(
    m: SfmMap, new_poses: Poses, pts_per_frame: int
) -> SfmMap:
    """Re-anchor landmarks by their birth keyframe's pose correction.

    A landmark born at keyframe k keeps its camera-frame coordinates under
    k's correction: X' = R_new^T (R_old X + t_old - t_new). Observations
    are untouched (they live in pixel space); the follow-up BA consumes
    the corrected geometry as its initialization.
    """
    P = m.points.shape[0]
    birth = jnp.arange(P, dtype=jnp.int32) // pts_per_frame
    birth = jnp.clip(birth, 0, m.rvecs.shape[0] - 1)
    r_old = rodrigues(m.rvecs[birth])             # (P, 3, 3)
    r_new = rodrigues(new_poses.rvecs[birth])
    x_cam = (
        jnp.einsum("pij,pj->pi", r_old, m.points) + m.tvecs[birth]
    )
    x_new = jnp.einsum(
        "pji,pj->pi", r_new, x_cam - new_poses.tvecs[birth]
    )
    return m._replace(
        rvecs=new_poses.rvecs,
        tvecs=new_poses.tvecs,
        points=jnp.where(m.pt_valid[:, None], x_new, m.points),
    )


def close_loops(
    m: SfmMap,
    n_frames: int,
    loop_frames: list[int],
    loop_poses: list[Camera],
    pts_per_frame: int,
    loop_weight: float = 4.0,
    pgo_iters: int = 12,
    damping: float = 1e-3,
    mesh=None,
) -> SfmMap:
    """PGO over the odometry chain + loop edges, then landmark re-anchor.

    With ``mesh`` set, the edge-sharded distributed PGO
    (parallel/pose_graph.distributed_pgo) runs instead of the
    single-device solver — same fixed point, edges sharded over the mesh.
    """
    edges = build_pose_graph_edges(
        m, n_frames, loop_frames, loop_poses, loop_weight=loop_weight
    )
    poses = Poses(rvecs=m.rvecs, tvecs=m.tvecs)
    if mesh is not None:
        from sift_parallel_optimization.parallel.pose_graph import (
            distributed_pgo,
        )

        new_poses = distributed_pgo(
            poses, edges, mesh, n_iters=pgo_iters, damping=damping
        )
    else:
        new_poses = jax.jit(
            lambda p, e: optimize_pose_graph(
                p, e, n_iters=pgo_iters, damping=damping
            )
        )(poses, edges)
    return apply_pose_correction(m, new_poses, pts_per_frame)
