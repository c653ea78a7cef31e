"""Benchmark matrix: the reference's sweep harnesses, generalized.

The reference explored its parallelism space by hand: a thread-count sweep
(Timing_ThreadCount, GaussDePyramid-pThread.h:310-326), a commented-out
OpenMP chunk-size sweep (main.cpp:43-59, GaussDePyramid-MPI.h:208-261), and
editing #include lines to switch variants (main.cpp:5-13). Here the same
study is one function: a matrix over {workload} x {size} with
device-chained slope timing (utils/profiling.chained_slope_ms) and JSONL
records using BASELINE.md metric names.

Workloads:
  * pyramid  — REFERENCE-mode window+DoG (the reference's entire workload)
  * frontend — full SIFT frontend (pyramid+detect+orient+describe)
  * matching — descriptor matmul + ratio/mutual + RANSAC homography
  * ba       — Schur-complement bundle adjustment (10 GN iters)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sift_parallel_optimization.utils.profiling import (
    MetricsWriter,
    chained_slope_ms,
)


def _rand_img(size: int) -> jax.Array:
    return jnp.asarray(
        np.random.default_rng(0).random((size, size), np.float32)
    )


def bench_pyramid(
    writer: MetricsWriter, sizes=(256, 512, 1024), S: int = 2, **kw,
) -> None:
    from sift_parallel_optimization.core.pyramid_ref import (
        reference_dog_pyramid,
    )

    for size in sizes:
        img = _rand_img(size)

        def step(x):
            return sum(o.sum() for o in reference_dog_pyramid(x, S))

        ms = chained_slope_ms(step, img)
        writer.write(
            f"pyramid_dog_ms_per_frame_{size}", round(ms, 4), "ms",
            S=S, frames_per_s=round(1e3 / max(ms, 1e-6), 1),
        )


def bench_frontend(
    writer: MetricsWriter, sizes=(256, 512), max_keypoints: int = 512, **kw,
) -> None:
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )

    for size in sizes:
        cfg = sift_config(size)
        img = _rand_img(size)

        def step(x):
            f = extract_features(x, cfg, max_keypoints)
            return f.descriptors.sum() + f.keypoints.score.sum()

        ms = chained_slope_ms(step, img, chain_lo=30, chain_hi=150)
        writer.write(
            f"frontend_ms_per_frame_{size}", round(ms, 4), "ms",
            max_keypoints=max_keypoints,
            frames_per_s=round(1e3 / max(ms, 1e-6), 1),
        )

    # Dual-orientation frontend (the configuration the SfM/odometry ATE
    # gates actually run) — recorded so throughput claims describe the
    # product path, not only the single-orientation kernel path.
    for size in sizes:
        cfg = sift_config(size)
        img = _rand_img(size)

        def step2(x):
            f = extract_features(
                x, cfg, max_keypoints, dual_orientation=True
            )
            return f.descriptors.sum() + f.keypoints.score.sum()

        ms = chained_slope_ms(step2, img, chain_lo=30, chain_hi=150)
        writer.write(
            f"frontend_dual_ms_per_frame_{size}", round(ms, 4), "ms",
            max_keypoints=max_keypoints,
            frames_per_s=round(1e3 / max(ms, 1e-6), 1),
        )


def bench_stages(
    writer: MetricsWriter, size: int = 512, max_keypoints: int = 512, **kw,
) -> None:
    """Frontend STAGE decomposition.

    Stages are measured as deltas between nested cumulative programs
    (pyramid; +dense score; +extraction/refit; +descriptors) — the only
    decomposition that survives fusion, since a stage's producers fuse
    into it.
    """
    from sift_parallel_optimization.core.pyramid_ref import (
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models.detect import (
        _dense_score,
        detect_pyramid,
    )
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )

    cfg = sift_config(size)
    img = _rand_img(size)

    def pyr(x):
        return sum(o.sum() for o in sift_gaussian_pyramid(x, cfg))

    def score(x):
        gauss = sift_gaussian_pyramid(x, cfg)
        dogs = [g[1:] - g[:-1] for g in gauss]
        return sum(
            _dense_score(d, cfg, 0.04, 10.0, 1).sum() for d in dogs
        )

    def detect(x):
        gauss = sift_gaussian_pyramid(x, cfg)
        dogs = [g[1:] - g[:-1] for g in gauss]
        kp = detect_pyramid(dogs, cfg, max_keypoints=max_keypoints)
        return kp.score.sum() + kp.x.sum()

    def frontend(x):
        f = extract_features(x, cfg, max_keypoints)
        return f.descriptors.sum() + f.keypoints.score.sum()

    t = {}
    for name, fn in (
        ("pyramid", pyr), ("score", score),
        ("detect", detect), ("frontend", frontend),
    ):
        t[name] = chained_slope_ms(
            fn, img, min_hi_total_ms=60, median_of=3
        )

    stage_ms = {
        "pyramid": t["pyramid"],
        "dense_score": t["score"] - t["pyramid"],
        "refit": t["detect"] - t["score"],       # extraction + refit tail
        "descriptors": t["frontend"] - t["detect"],
        "frontend": t["frontend"],
    }
    for stage, ms in stage_ms.items():
        writer.write(
            f"stage_{stage}_ms_{size}", round(ms, 4), "ms",
            max_keypoints=max_keypoints,
        )


def bench_matching(writer: MetricsWriter, k: int = 512, **kw) -> None:
    from sift_parallel_optimization.models.matching import (
        match_descriptors,
        ransac_homography,
    )

    rng = np.random.default_rng(0)
    d1 = rng.normal(size=(k, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = jnp.asarray(np.roll(d1, 7, axis=0))
    d1 = jnp.asarray(d1)
    v = jnp.ones(k, bool)
    p1 = jnp.asarray(rng.uniform(0, 512, (k, 2)).astype(np.float32))
    p2 = p1 + 5.0
    key = jax.random.key(0)

    def match_step(x):
        m = match_descriptors(d1 + 1e-12 * x.sum(), d2, v, v)
        return m.similarity.sum()

    ms = chained_slope_ms(match_step, d1, chain_lo=30, chain_hi=200)
    writer.write(f"match_ms_{k}x{k}", round(ms, 4), "ms")

    def ransac_step(x):
        r = ransac_homography(key, p1 + 1e-12 * x.sum(), p2, v, 256)
        return r.model.sum() + r.n_inliers.astype(jnp.float32)

    ms = chained_slope_ms(ransac_step, p1, chain_lo=30, chain_hi=200)
    writer.write(f"ransac_homography_ms_{k}", round(ms, 4), "ms")


def bench_ba(
    writer: MetricsWriter, n_cams: int = 20, n_pts: int = 500,
    n_iters: int = 10, solvers=("dense", "cg"), **kw,
) -> None:
    from sift_parallel_optimization.models.ba import (
        BAState,
        Observations,
        bundle_adjust,
    )
    from sift_parallel_optimization.models.geometry import project

    K = jnp.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32))
    pts = pts.at[:, 2].add(8.0)
    rvecs = jnp.asarray(rng.normal(size=(n_cams, 3)).astype(np.float32) * 0.02)
    tvecs = jnp.asarray(
        np.stack(
            [np.linspace(-2, 2, n_cams), np.zeros(n_cams), np.zeros(n_cams)], 1
        ).astype(np.float32)
    )
    uv = jnp.concatenate(
        [project(pts, rvecs[i], tvecs[i], K)[0] for i in range(n_cams)]
    )
    obs = Observations(
        cam_idx=jnp.repeat(jnp.arange(n_cams), n_pts),
        pt_idx=jnp.tile(jnp.arange(n_pts), n_cams),
        uv=uv, valid=jnp.ones(n_cams * n_pts, bool),
    )
    state = BAState(
        rvecs=rvecs + 0.005, tvecs=tvecs + 0.01, points=pts + 0.02
    )

    for solver in solvers:
        def step(x, solver=solver):
            st = state._replace(points=state.points + 1e-12 * x.sum())
            out = bundle_adjust(st, obs, K, n_iters=n_iters, solver=solver)
            return out.points.sum() + out.tvecs.sum()

        ms = chained_slope_ms(step, pts, chain_lo=3, chain_hi=12, repeats=2)
        writer.write(
            f"ba_ms_{n_cams}cams_{n_pts}pts_{n_iters}iters", round(ms, 2),
            "ms", obs=n_cams * n_pts, solver=solver,
        )


def bench_stream(
    writer: MetricsWriter, size: int = 512, frames: int = 200,
    max_keypoints: int = 512, **kw,
) -> None:
    """End-to-end pipelined serving throughput (the `cli stream` flow):
    native C++ ring loader -> H2D -> frontend, results drained at the
    end. The scalar count fetches force every result, so the wall time
    covers the full pipeline including host frame generation."""
    import time

    import jax

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.utils import native

    if not native.available():
        return
    cfg = sift_config(size)
    fe = jax.jit(
        lambda x: extract_features(
            x, cfg, max_keypoints, dual_orientation=True
        )
    )
    with native.FrameLoader(size, n_buffers=4, n_threads=2, seed=0) as ld:
        _, frame = ld.next_frame()
        int(fe(jnp.asarray(frame)).keypoints.count())  # compile
        counts = []
        t0 = time.perf_counter()
        for _ in range(frames):
            _, frame = ld.next_frame()
            counts.append(fe(jnp.asarray(frame)).keypoints.count())
        n_kp = sum(int(c) for c in counts)  # drains the pipeline
        dt = time.perf_counter() - t0
    writer.write(
        f"stream_fps_{size}", round(frames / dt, 1), "frames/s",
        frames=frames, dual_orientation=True,
        ms_per_frame=round(1e3 * dt / frames, 3),
        keypoints_per_frame=round(n_kp / frames, 1),
    )


def bench_tracking(
    writer: MetricsWriter, size: int = 256, window: int = 6,
    pts_per_frame: int = 128, ba_iters: int = 4, **kw,
) -> None:
    """Steady-state odometry TRACKING step rate: shift-eviction +
    PnP/triangulation registration + window BA per frame, the per-frame
    device work of `run_odometry` once the window is full (BA defaults
    are every-2-frames x 8 iters; n_iters=4 here is the amortized
    per-frame equivalent). Chained on device like every kernel number,
    so the record is the per-frame device cost without host dispatch.
    """
    import functools

    from jax import lax

    from sift_parallel_optimization.models.ba import (
        bundle_adjust,
        resolve_solver,
    )
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.sfm import (
        empty_map,
        init_two_view,
        register_frame,
    )
    from sift_parallel_optimization.utils import native

    if not native.available():
        return
    cfg = sift_config(size)
    focal = float(size)
    K = jnp.array(
        [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
        jnp.float32,
    )
    fe = jax.jit(
        lambda x: extract_features(x, cfg, pts_per_frame * 2,
                                   dual_orientation=True)
    )
    rvs = np.stack([[0.0, 0.02 * i, 0.0] for i in range(3)], 0)
    tvs = np.stack([[-0.3 * i, 0.0, 0.03 * i] for i in range(3)], 0)
    feats = [
        fe(jnp.asarray(native.render_frame(
            size, rvs[i].astype(np.float32), tvs[i].astype(np.float32),
            focal, seed=2)))
        for i in range(3)
    ]
    key = jax.random.key(0)
    W, B = window, pts_per_frame
    m = empty_map(W, B, max_loops=0)
    m, used = init_two_view(key, feats[0], feats[1], K, m, B)
    m, used = register_frame(key, m, feats[2], feats[1], 2, K, used, B)
    solver = resolve_solver(W, W * B, "auto")

    # Round 4: the default odometry path carries anchor marginalization
    # (models/odometry.harvest_anchors -> ba anchors=...). Round 5: the
    # chain body IS the production fused steady-state step
    # (models/odometry.make_steady_step — the exact program
    # run_odometry scans), so this record measures the shipped code
    # path, not a bench replica: harvest + shift + register at slot
    # W-1 + anchored window BA per frame (loop closure off — the
    # archive/loop stage has its own cost, benched by the odometry
    # drivers).
    from sift_parallel_optimization.models.ba import empty_anchors
    from sift_parallel_optimization.models.odometry import (
        make_steady_step,
    )

    anchors0 = empty_anchors((W - 1) * B)
    feats_stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
    steady = make_steady_step(
        feats_stacked, K, key=key, window=W, pts_per_frame=B,
        n_frames=1 << 30, ba_every=1, ba_iters=ba_iters,
        ba_kwargs=dict(
            damping=1e-4, huber_delta=2.0, solver=solver,
            **({"max_obs_per_point": -(-W // 8) * 8}
               if solver == "cg" else {}),
        ),
        marginalize=True, loop_closure=False,
    )

    def chain(n):
        @jax.jit
        def run(m0, used0):
            # Constant frame index 2 (register vs feats[1], the same
            # pair every iteration) — the carry still advances, so no
            # work can be hoisted.
            idx = jnp.full(n, 2, jnp.int32)
            (mm, *_rest), _ = lax.scan(
                steady, (m0, used0, anchors0, None, None), idx
            )
            return mm.tvecs.sum() + mm.points.sum()

        float(run(m, used))  # compile + warm
        return run

    import time

    def total_ms(fn):
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            float(fn(m, used))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    lo, hi = 4, 16
    t_hi = total_ms(chain(hi))
    if t_hi < 60.0:  # stretch short chains, like chained_slope_ms
        scale = int(60.0 / max(t_hi, 1e-3)) + 1
        lo, hi = lo * scale, hi * scale
    lo_fn, hi_fn = chain(lo), chain(hi)
    ms = max((total_ms(hi_fn) - total_ms(lo_fn)) / (hi - lo), 1e-6)
    writer.write(
        f"tracking_ms_per_frame_{size}", round(ms, 3), "ms",
        window=W, pts_per_frame=B, ba_iters=ba_iters, solver=solver,
        frames_per_s=round(1e3 / ms, 1),
    )

    # The LOOP-CLOSED steady step (round 5): the complete product path —
    # archive write + anchor harvest + shift + register + anchored BA +
    # archive-PnP loop propose/accept against a FULL default ring (8192
    # archived landmarks: the matmul and RANSAC run at production size).
    from sift_parallel_optimization.models.odometry import (
        empty_archive,
        empty_loop_buffer,
    )

    A = 64 * B
    rngl = np.random.default_rng(1)
    d = rngl.normal(size=(A, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    arch0 = empty_archive(A)._replace(
        positions=jnp.asarray(
            rngl.normal(size=(A, 3)).astype(np.float32) + [0, 0, 5]
        ),
        desc=jnp.asarray(d),
        birth=jnp.zeros(A, jnp.int32),
        valid=jnp.ones(A, bool),
    )
    buf0 = empty_loop_buffer(64)
    steady_lc = make_steady_step(
        feats_stacked, K, key=key, window=W, pts_per_frame=B,
        n_frames=1 << 30, ba_every=1, ba_iters=ba_iters,
        ba_kwargs=dict(
            damping=1e-4, huber_delta=2.0, solver=solver,
            **({"max_obs_per_point": -(-W // 8) * 8}
               if solver == "cg" else {}),
        ),
        marginalize=True, loop_closure=True, loop_min_gap=W + 1,
    )

    def chain_lc(n):
        @jax.jit
        def run(m0, used0):
            # Constant frame index W+1 (> W, so the loop stage runs
            # every iteration — the worst case; feature gathers clamp
            # to the last rendered frame). The final consume MUST touch
            # the loop buffer and archive or XLA dead-code-eliminates
            # the whole loop stage (measured: "loop overhead" -0.004 ms
            # before this term).
            idx = jnp.full(n, W + 1, jnp.int32)
            (mm, _u, _a, arch_f, buf_f), _ = lax.scan(
                steady_lc, (m0, used0, anchors0, arch0, buf0), idx
            )
            return (
                mm.tvecs.sum() + mm.points.sum()
                + buf_f.tvecs.sum() + buf_f.count
                + arch_f.positions.sum()
            )

        float(run(m, used))
        return run

    def total_lc(fn):
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            float(fn(m, used))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    lo, hi = 4, 16
    t_hi = total_lc(chain_lc(hi))
    if t_hi < 60.0:
        scale = int(60.0 / max(t_hi, 1e-3)) + 1
        lo, hi = lo * scale, hi * scale
    ms_lc = max(
        (total_lc(chain_lc(hi)) - total_lc(chain_lc(lo))) / (hi - lo),
        1e-6,
    )
    writer.write(
        f"tracking_loop_ms_per_frame_{size}", round(ms_lc, 3), "ms",
        window=W, pts_per_frame=B, ba_iters=ba_iters, solver=solver,
        archive_slots=A, frames_per_s=round(1e3 / ms_lc, 1),
        loop_overhead_ms=round(ms_lc - ms, 3),
    )


def bench_matrix(writer: MetricsWriter, size: int = 512, **kw) -> None:
    """The parallelism-KNOB sweep — the reference's schedule/chunk study
    (OpenMP static/dynamic/guided x chunk_size, GaussDePyramid-OpenMP.h:
    220-402, main.cpp:43-59; pthread Timing_ThreadCount,
    GaussDePyramid-pThread.h:310-326), generalized to this engine's
    knobs:

      * compute dtype (f32 vs bf16) on the SIFT Gaussian pyramid — the
        SIMD-width analogue;
      * frame batch size on the vmapped frontend (tail-batch efficiency);
      * mesh shape (data x spatial factorizations) on the sharded SIFT
        pyramid, when >1 device is visible.

    Every cell is one JSONL record; use `cli bench --workloads matrix`.
    """
    from sift_parallel_optimization.core.pyramid_ref import (
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )

    img = _rand_img(size)

    # --- dtype sweep on the SIFT pyramid (speed vs accuracy).
    for dtype_name in ("float32", "bfloat16"):
        cfg = sift_config(size, dtype=jnp.dtype(dtype_name))

        def step(x):
            return sum(
                o.astype(jnp.float32).sum()
                for o in sift_gaussian_pyramid(x, cfg)
            )

        ms = chained_slope_ms(step, img)
        writer.write(
            f"matrix_sift_pyramid_ms_{size}", round(ms, 4), "ms",
            dtype=dtype_name,
        )

    # --- blur matmul precision sweep: HIGHEST (full f32, geometry-grade)
    # vs HIGH (see PyramidConfig.blur_precision).
    for prec_name in ("highest", "high"):
        cfg = sift_config(size, blur_precision=prec_name)

        def step(x):
            return sum(o.sum() for o in sift_gaussian_pyramid(x, cfg))

        ms = chained_slope_ms(step, img)
        writer.write(
            f"matrix_sift_pyramid_ms_{size}", round(ms, 4), "ms",
            blur_precision=prec_name,
        )

    # --- frame-batch sweep on the frontend (per-frame cost vs B), for
    # BOTH batching strategies: plain vmap (loses — batched top-k/gather
    # lowerings + relayout copies) and the production batched path
    # (vmapped pyramid + per-frame unrolled sparse stages,
    # parallel/frontend.py).
    from sift_parallel_optimization.parallel.frontend import (
        batched_extract_features,
    )

    bsize = min(size, 256)
    cfg = sift_config(bsize)
    paths = {
        "vmap": lambda x: jax.vmap(
            lambda im: extract_features(im, cfg, 256)
        )(x),
        "batched": lambda x: batched_extract_features(x, cfg, 256),
    }
    for batch in (1, 2, 4, 8):
        frames = jnp.asarray(
            np.random.default_rng(1).random(
                (batch, bsize, bsize), np.float32
            )
        )
        for path_name, path_fn in paths.items():

            def step(x, fn=path_fn):
                f = fn(x)
                return f.descriptors.sum() + f.keypoints.score.sum()

            ms = chained_slope_ms(step, frames, chain_lo=10, chain_hi=40)
            writer.write(
                f"matrix_frontend_batched_ms_per_frame_{bsize}",
                round(ms / batch, 4), "ms", batch=batch, path=path_name,
            )

    # --- mesh-shape sweep (data x spatial factorizations of the device set).
    n_dev = len(jax.devices())
    if n_dev > 1:
        from sift_parallel_optimization.parallel.mesh import make_mesh
        from sift_parallel_optimization.parallel.scale_space import (
            sharded_sift_gaussian_pyramid,
        )

        shapes = [
            (d, n_dev // d)
            for d in (1, 2, 4, 8, 16)
            if d <= n_dev and n_dev % d == 0
        ]
        scfg = sift_config(size)
        for n_data, n_spatial in shapes:
            mesh = make_mesh(n_data=n_data, n_spatial=n_spatial)

            def step(x):
                return sum(
                    o.sum()
                    for o in sharded_sift_gaussian_pyramid(x, scfg, mesh)
                )

            ms = chained_slope_ms(step, img)
            writer.write(
                f"matrix_mesh_shape_pyramid_ms_{size}", round(ms, 4), "ms",
                mesh=f"{n_data}x{n_spatial}",
            )


def run_suite(
    writer: MetricsWriter,
    workloads=(
        "pyramid", "frontend", "stages", "stream", "tracking", "matching",
        "ba", "matrix", "scaling",
    ),
    **kw,
) -> None:
    if "pyramid" in workloads:
        bench_pyramid(writer, **kw)
    if "frontend" in workloads:
        bench_frontend(writer, **kw)
    if "stages" in workloads:
        bench_stages(writer, **kw)
    if "stream" in workloads:
        bench_stream(writer, **kw)
    if "tracking" in workloads:
        bench_tracking(writer, **kw)
        # First 512^2 tracking record (VERDICT round 3: the product path
        # had no number above 256^2 — the frame size changes only the
        # frontend, but the registration PnP sees 2x the pixel spread).
        bench_tracking(writer, size=512, **{
            k: v for k, v in kw.items() if k != "size"
        })
    if "matching" in workloads:
        bench_matching(writer, **kw)
    if "ba" in workloads:
        bench_ba(writer, **kw)
    if "matrix" in workloads:
        bench_matrix(writer, **kw)
    if "scaling" in workloads:
        # Virtual-CPU-mesh sweep (Timing_ThreadCount analogue). NOTE: XLA's
        # CPU backend multithreads within ONE device, so virtual-device DP
        # shows poor efficiency on CPU — the sweep is the harness that runs
        # unchanged on a real multi-chip mesh.
        from sift_parallel_optimization.bench.scaling import bench_scaling

        bench_scaling(writer, **kw)
