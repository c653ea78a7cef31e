"""Analytic roofline / speed-of-light accounting for the bench suite.

The reference's whole methodology is self-timed measurement
(main.cpp:60-74, GaussDePyramid-pThread.h:310-326); it never models
WHERE the time should go. This module gives every workload an analytic
cost model (algorithmic flops and minimal device-memory traffic) and
divides it by one table of published device peaks, so a bench record can
carry

    sol_pct = 100 * floor_ms / measured_ms

Conventions:

* Flops are ALGORITHMIC (e.g. a blur counts 2*(2r+1) flops per output
  pixel — the taps the math needs), not what our blocked-band
  implementation issues. %SOL therefore measures distance from the
  problem's floor, not from our own schedule.
* Bytes are the MINIMAL traffic of a perfectly fused schedule: each
  input read once from device memory, each live output written once.
* The floor is max(memory, matmul, vector) — perfect overlap, i.e. a
  true speed of light.

Peaks come from :data:`PEAKS`, keyed by ``jax.Device.device_kind``; a
device that is not in the table is an error, never a default.
"""

from __future__ import annotations

import dataclasses
import math

from sift_parallel_optimization.config import PyramidConfig, num_octaves


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    f32_tflops: float        # float32 outside the tensor cores, TFLOP/s
    tf32_tflops: float       # TF32 tensor cores, dense, TFLOP/s
    bf16_tflops: float       # bf16 tensor cores, dense, TFLOP/s
    source: str


# Published peaks, keyed by the device_kind JAX reports.
PEAKS: dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(
        name="H100 SXM",
        hbm_gbps=3350.0,
        f32_tflops=67.0,
        tf32_tflops=495.0,
        bf16_tflops=989.0,
        source="NVIDIA H100 Tensor Core GPU datasheet, SXM5 column "
               "(dense rates, 700 W)",
    ),
}


def peaks_for(device_kind: str) -> Peaks:
    """Published peaks of ``device_kind``; raises for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Analytic cost of one workload (see module conventions)."""

    hbm_bytes: float = 0.0
    matmul_f32_flops: float = 0.0  # matmuls pinned to precision HIGHEST
    matmul_flops: float = 0.0      # matmuls at DEFAULT precision (TF32)
    vector_flops: float = 0.0      # elementwise / stencil flops
    note: str = ""

    def _times(self, peaks: Peaks) -> dict[str, float]:
        return {
            "hbm": self.hbm_bytes / (peaks.hbm_gbps * 1e9),
            "matmul": (
                self.matmul_f32_flops / (peaks.f32_tflops * 1e12)
                + self.matmul_flops / (peaks.tf32_tflops * 1e12)
            ),
            "vector": self.vector_flops / (peaks.f32_tflops * 1e12),
        }

    def floor_ms(self, peaks: Peaks) -> float:
        return 1e3 * max(self._times(peaks).values())

    def bound(self, peaks: Peaks) -> str:
        t = self._times(peaks)
        return max(t, key=t.get)

    def sol_pct(self, measured_ms: float, peaks: Peaks) -> float:
        if measured_ms <= 0:
            return 0.0
        return round(100.0 * self.floor_ms(peaks) / measured_ms, 1)

    def __add__(self, other: "CostModel") -> "CostModel":
        return CostModel(
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
            matmul_f32_flops=self.matmul_f32_flops + other.matmul_f32_flops,
            matmul_flops=self.matmul_flops + other.matmul_flops,
            vector_flops=self.vector_flops + other.vector_flops,
            note=self.note,
        )


def _octave_sizes(length: int, n_octaves: int | None = None) -> list[int]:
    total = num_octaves(length)
    n = total if n_octaves is None else min(n_octaves, total)
    return [length // (2**o) for o in range(n)]


def _taps(sigma: float) -> int:
    return 2 * max(1, int(math.ceil(3.0 * sigma))) + 1


def reference_pyramid_model(size: int, S: int) -> CostModel:
    """REFERENCE-mode window+DoG (the headline): pure elementwise.

    Per octave: read the base once, write S+3 output planes; one
    multiply (+ one subtract, folded into the window bank) per output
    element. The strided subsamples re-read the shrinking bases
    (negligible vs the planes).
    """
    bytes_ = 0.0
    flops = 0.0
    for n in _octave_sizes(size):
        bytes_ += 4.0 * n * n * (1 + (S + 3))
        flops += 1.0 * (S + 3) * n * n
    return CostModel(
        hbm_bytes=bytes_, vector_flops=flops,
        note=f"reference pyramid {size}^2 S={S}",
    )


def sift_pyramid_model(cfg: PyramidConfig) -> CostModel:
    """True Gaussian pyramid: separable blurs of every octave base.

    Algorithmic flops: 2 passes x 2*(2r+1) flops per pixel per scale
    (the taps); minimal bytes: read each octave base once, write the
    S+3 planes once. The blurs are matmuls pinned to precision HIGHEST,
    so they are charged at the float32 (non-tensor-core) rate.
    """
    from sift_parallel_optimization.core.pyramid_ref import (
        _octave_scale_sigmas,
    )

    rel = _octave_scale_sigmas(cfg)
    base_sigma = math.sqrt(
        max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12)
    )
    bytes_ = 0.0
    flops = 0.0
    for o, n in enumerate(_octave_sizes(cfg.length, cfg.n_octaves)):
        per_px = sum(2 * 2 * _taps(s) for s in rel)
        if o == 0:
            per_px += 2 * 2 * _taps(base_sigma)
        flops += per_px * n * n
        bytes_ += 4.0 * n * n * (1 + (cfg.S + 3))
    return CostModel(
        hbm_bytes=bytes_, matmul_f32_flops=flops,
        note=f"sift pyramid {cfg.length}^2 S={cfg.S}",
    )


def dense_score_model(cfg: PyramidConfig) -> CostModel:
    """Detection dense stage: DoG + 26-neighbor extrema + quadratic-fit
    ranking score + block-reduce tables.

    Minimal bytes: read the S+3 Gaussian planes once per octave (DoG,
    stencils, and the block tables all fuse); the tables are ~V/64
    floats (negligible). Stencil flops: ~60/voxel (min/max pools,
    gradients, Hessian, adjugate solve) on the (S, N-2, N-2) interior.
    """
    bytes_ = 0.0
    flops = 0.0
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        bytes_ += 4.0 * n * n * (cfg.S + 3)
        flops += 60.0 * cfg.S * max(n - 2, 0) ** 2
    return CostModel(
        hbm_bytes=bytes_, vector_flops=flops,
        note=f"dense score {cfg.length}^2",
    )


def refit_model(capacity: int, rounds: int = 2) -> CostModel:
    """Sparse candidate re-fit: 19-offset flat gathers per round, charged
    as one 4-byte read per gathered element."""
    return CostModel(
        hbm_bytes=4.0 * capacity * 19 * rounds,
        note=f"sparse refit K={capacity} x{rounds}",
    )


def descriptor_model(cfg: PyramidConfig, capacity: int) -> CostModel:
    """Orientation + descriptor stage.

    Dominant: the per-keypoint patch gather (rows x PATCH_COLS), the
    atlas build (read pyramid, write padded atlas) and the resample
    einsums, which are pinned to HIGHEST (float32 rate); the histogram
    votes run at DEFAULT precision (TF32 on the tensor cores).
    """
    import numpy as np

    from sift_parallel_optimization.models import descriptor as D

    item = float(np.dtype(D.ATLAS_DTYPE).itemsize)
    # Copies (patch gather, atlas pad) are charged one way: the written
    # patches are the floor, and a fused schedule never re-reads them.
    rows = D.patch_rows_for(D.max_patch_radius(cfg.S, cfg.sigma0))
    patch_bytes = capacity * rows * D.PATCH_COLS * item
    atlas_rows = 0.0
    pyr_bytes = 0.0
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        atlas_rows += (cfg.S + 3) * (2 * D.ROW_PAD + n)
        pyr_bytes += 4.0 * n * n * (cfg.S + 3)
    atlas_bytes = atlas_rows * (D.COL_PAD + cfg.length + 128) * item
    atlas_bytes = max(atlas_bytes, pyr_bytes)
    pyr_bytes = 0.0  # read side of the atlas copy, already charged
    # Resample: two hat einsums per grid (ori 18, desc 26).
    resample = 0.0
    for g in (D.ORI_GRID, D.DESC_GRID):
        resample += 2 * g * rows * D.PATCH_COLS
        resample += 2 * g * g * D.PATCH_COLS
    hist = 2 * (D.DESC_GRID - 2) ** 2 * (16 + 16 * 8)  # trilinear votes
    return CostModel(
        hbm_bytes=patch_bytes + atlas_bytes + pyr_bytes,
        matmul_f32_flops=capacity * resample,
        matmul_flops=capacity * hist,
        note=f"descriptors K={capacity}",
    )


def frontend_model(cfg: PyramidConfig, capacity: int) -> CostModel:
    """Full frontend floor: sum of the stage models (stages share no
    work, so floors add)."""
    m = (
        sift_pyramid_model(cfg)
        + dense_score_model(cfg)
        + refit_model(capacity)
        + descriptor_model(cfg, capacity)
    )
    return dataclasses.replace(
        m, note=f"frontend {cfg.length}^2 K={capacity}"
    )


def matching_model(k: int, dim: int = 128) -> CostModel:
    """Descriptor matching: one (K, D) x (D, K) similarity matmul plus
    ratio/mutual reductions."""
    return CostModel(
        hbm_bytes=2.0 * k * dim * 4 + 4.0 * k * k,
        matmul_flops=2.0 * k * k * dim,
        note=f"match {k}x{k}",
    )


def stage_models(
    cfg: PyramidConfig, capacity: int
) -> dict[str, CostModel]:
    """The frontend stage decomposition used by `cli bench -w stages`."""
    return {
        "pyramid": sift_pyramid_model(cfg),
        "dense_score": dense_score_model(cfg),
        "refit": refit_model(capacity),
        "descriptors": descriptor_model(cfg, capacity),
        "frontend": frontend_model(cfg, capacity),
    }


# ---------------------------------------------------------------------------
# Collective byte counts: per-device interconnect bytes of each sharded op,
# computed from shapes alone (algorithmic, independent of the link).
# ---------------------------------------------------------------------------


def ring_all_reduce_bytes(array_bytes: float, n: int) -> float:
    """Per-device interconnect bytes of a ring psum (reduce-scatter + all-gather)."""
    return 2.0 * array_bytes * (n - 1) / n if n > 1 else 0.0


def ring_reduce_scatter_bytes(array_bytes: float, n: int) -> float:
    return array_bytes * (n - 1) / n if n > 1 else 0.0


def ring_all_gather_bytes(array_bytes: float, n: int) -> float:
    return array_bytes * (n - 1) / n if n > 1 else 0.0


def sharded_pyramid_comm_bytes(cfg: PyramidConfig, n_spatial: int) -> float:
    """Per-device interconnect bytes per frame of the row-sharded SIFT pyramid.

    One ppermute halo exchange per sharded blur-bank call (max blur
    radius covers every scale — parallel/scale_space.sharded_blur_bank):
    each device sends/receives r rows in each direction. Octaves stop
    sharding when the local height cannot hold the halo (the can_shard
    rule in sharded_sift_gaussian_pyramid).
    """
    from sift_parallel_optimization.core.pyramid_ref import (
        _band_radius,
        _octave_scale_sigmas,
    )

    if n_spatial <= 1:
        return 0.0
    rel = _octave_scale_sigmas(cfg)
    base_sigma = math.sqrt(
        max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12)
    )
    max_r = max(_band_radius(s) for s in [base_sigma, *rel])
    total = 0.0
    first = True
    for n in _octave_sizes(cfg.length, cfg.n_octaves):
        if n % (2 * n_spatial) or n // n_spatial < max(2 * max_r, 8):
            break  # tail octaves run unsharded
        if first:  # base blur exchange at octave-0 size
            total += 2 * 2 * _band_radius(base_sigma) * n * 4.0
            first = False
        total += 2 * 2 * max_r * n * 4.0  # send+recv, up+down
    return total


def dp_frontend_comm_bytes() -> float:
    """Batch-sharded frontend: zero collectives inside the step (pure
    data parallelism; outputs stay sharded)."""
    return 0.0


def ba_cg_comm_bytes(
    n_cams: int, n_pts: int, n_dev: int,
    gn_iters: int = 10, cg_iters: int = 25,
) -> float:
    """Per-device interconnect bytes of the observation-sharded implicit-Schur CG
    BA (parallel/ba.distributed_ba_step_cg), per bundle_adjust call.

    Per GN step: one psum of (C,6,6)+(C,6), one psum_scatter of
    (P,3,3)+(P,3); per CG matvec: one psum_scatter + one all_gather of
    (P,3) and one psum of (C,6).
    """
    c_blocks = (n_cams * 36 + n_cams * 6) * 4.0
    p_blocks = (n_pts * 9 + n_pts * 3) * 4.0
    per_gn = (
        ring_all_reduce_bytes(c_blocks, n_dev)
        + ring_reduce_scatter_bytes(p_blocks, n_dev)
    )
    per_matvec = (
        ring_reduce_scatter_bytes(n_pts * 3 * 4.0, n_dev)
        + ring_all_gather_bytes(n_pts * 3 * 4.0, n_dev)
        + ring_all_reduce_bytes(n_cams * 6 * 4.0, n_dev)
    )
    return gn_iters * (per_gn + cg_iters * per_matvec)


def tracking_step_cost(
    window: int = 6,
    pts_per_frame: int = 128,
    desc_capacity: int = 256,
    ba_iters: int = 4,
    n_hyp: int = 128,
) -> CostModel:
    """Analytic cost of one odometry TRACKING step (the per-frame device
    work of run_odometry once the window is full: shift eviction +
    PnP/triangulation registration + amortized window BA).

    Every term is the ALGORITHM's requirement, not the schedule's:

    * shift — one read+write of the window map (cams, points,
      descriptors, observations).
    * register — the (2B, 128) x (P, 128) descriptor matmul, n_hyp
      minimal DLT solves + their hypothesis scoring over P points, the
      5-iteration best-pose refinement, and B two-view triangulations.
    * window BA x ba_iters — residuals/Jacobians over M = 3*B*W
      observations, the (C, P) Schur reduction, and the 6C x 6C solve.

    The resulting floor is tens of microseconds: the step is a chain of
    small dependent operations, so a measured time far above this floor
    reads as latency- or launch-bound, not resource-bound.
    """
    W, B = window, pts_per_frame
    C, P = W, W * B
    M = 3 * P
    # shift: map read+write (pt_desc dominates).
    map_bytes = (
        C * (3 + 3) * 4 + C
        + P * 3 * 4 + P + P * 128 * 4
        + M * (4 + 4 + 8 + 1)
    )
    hbm = 2.0 * map_bytes
    # register: descriptor match at default matmul precision
    mm_default = 2.0 * (2 * B) * P * 128
    hbm += (2 * B + P) * 128 * 4
    # PnP: hypothesis solves (12x12 normal build + LU solves + polar +
    # 3-iter 6-point refine ~ 3e4 flops each), scoring n_hyp x P
    # projections (~30 flops), best refine 5 x P (~60 flops/pt/iter),
    # B triangulations (~600 flops each).
    vpu = n_hyp * 3.0e4 + n_hyp * P * 30.0 + 5 * P * 60.0 + B * 600.0
    # window BA: per iter, residual+Jacobian (~570 vector flops/obs),
    # block outer products M x (36+9+18) MACs, Schur (6C)^2 x 3P matmul,
    # and the obs stream from HBM.
    vpu += ba_iters * M * 570.0
    mm_f32 = ba_iters * (
        2.0 * M * (36 + 9 + 18)
        + 2.0 * (6 * C) * (6 * C) * (3 * P)
        + 2.0 * (6 * C) ** 3 / 3.0
    )
    hbm += ba_iters * M * (4 + 4 + 8 + 1)
    return CostModel(
        hbm_bytes=hbm, matmul_f32_flops=mm_f32, matmul_flops=mm_default,
        vector_flops=vpu,
        note="tracking step: shift + register + amortized window BA",
    )


def loop_stage_cost(
    desc_capacity: int = 256,
    archive_slots: int = 8192,
    n_hyp: int = 128,
) -> CostModel:
    """Analytic cost of the per-frame LOOP stage of loop-closed odometry
    (models/odometry.make_steady_step: archive write + archive-PnP
    propose + device-side accept). Add to :func:`tracking_step_cost`'s
    model for the complete product path.

    * archive write — one descriptor block (B, 128) + positions to HBM;
    * propose — the (K, 128) x (A, 128) similarity matmul (default
      precision) + its memory stream, the top-2/mutual reductions (one
      vector pass over the K x A matrix), n_hyp DLT hypotheses + scoring over
      K points (same algebra as registration's PnP);
    * accept — O(cap) elementwise, negligible.
    """
    K, A = desc_capacity, archive_slots
    hbm = (K + A) * 128.0 * 4 + A * 3 * 4        # desc + positions reads
    hbm += 128 * (128 + 3 + 4 + 1) * 4.0          # evicted block write
    mm_default = 2.0 * K * A * 128
    vpu = 3.0 * K * A                             # top-2 + mutual passes
    vpu += n_hyp * 3.0e4 + n_hyp * K * 30.0       # DLT + scoring
    return CostModel(
        hbm_bytes=hbm, matmul_f32_flops=0.0, matmul_flops=mm_default,
        vector_flops=vpu,
        note="loop stage: archive write + archive-PnP propose + accept",
    )


def ring_matching_comm_bytes(
    n_frames: int, kp_per_frame: int, n_dev: int,
    desc_dtype_bytes: int = 4,
) -> float:
    """Per-device interconnect bytes of one ring pairwise-matching sweep
    (parallel/matching.ring_pairwise_match_counts).

    Each device forwards its traveling descriptor block + valid mask to
    its ring neighbor on every one of the n_dev ring steps (the final
    hop returns each block home; the useful hops are n_dev - 1 — same
    per-link bytes as a ring all-gather of the descriptor set). Compute
    per step is (F/D)^2 * K^2 * 128 MACs, so the schedule goes compute
    -bound as K grows: at F=64, K=512, D=8 the sweep moves ~33 MB/device
    against ~17 GFLOP/device of matmul work.
    """
    f_loc = -(-n_frames // n_dev)
    block = f_loc * kp_per_frame * (128.0 * desc_dtype_bytes + 1.0)
    return n_dev * block
