"""Command-line entry point (replaces the reference's #include-toggling).

The reference selected variants by commenting #include lines and editing
globals, then recompiling (main.cpp:5-19, SURVEY.md section 5 config row).
Here: one CLI over the installed package.

  python -m sift_parallel_optimization.cli bench --workloads pyramid
  python -m sift_parallel_optimization.cli features --image in.pgm
  python -m sift_parallel_optimization.cli pyramid --size 512 --dump-dir /tmp/oct
  python -m sift_parallel_optimization.cli sfm --frames 8 --size 256
"""

from __future__ import annotations

import argparse
import sys


def _cmd_bench(args) -> int:
    from sift_parallel_optimization.bench.suite import run_suite
    from sift_parallel_optimization.utils.profiling import MetricsWriter

    with MetricsWriter(args.out) as w:
        run_suite(w, workloads=args.workloads.split(","))
    return 0


def _load_image(args):
    import jax.numpy as jnp

    from sift_parallel_optimization.utils import native

    if args.image:
        img = native.read_pgm(args.image)
        # Largest centered square crop.
        side = min(img.shape)
        y0 = (img.shape[0] - side) // 2
        x0 = (img.shape[1] - side) // 2
        return jnp.asarray(img[y0:y0 + side, x0:x0 + side])
    return jnp.asarray(native.synth_frame(args.size, 0, seed=args.seed))


def _cmd_pyramid(args) -> int:
    import jax
    import numpy as np

    img = _load_image(args)
    if args.mode == "reference":
        # Production path: the fused-jnp pipeline (works on every backend
        # and is the fastest variant — BASELINE.md).
        from sift_parallel_optimization.core.pyramid_ref import (
            reference_dog_pyramid,
        )

        out = jax.jit(
            lambda x: reference_dog_pyramid(x, args.S)
        )(img)
    else:
        from sift_parallel_optimization.config import (
            PyramidConfig,
            ScaleSpaceMode,
        )
        from sift_parallel_optimization.core.pyramid_ref import (
            sift_dog_pyramid,
        )

        cfg = PyramidConfig(
            length=img.shape[0], S=args.S, mode=ScaleSpaceMode.SIFT
        )
        out = jax.jit(lambda x: sift_dog_pyramid(x, cfg))(img)
    for o, planes in enumerate(out):
        print(f"octave {o}: shape={tuple(planes.shape)} "
              f"mean={float(planes.mean()):+.5f} std={float(planes.std()):.5f}")
    if args.dump_dir:
        # The reference's output() dumped scale 0 of each octave
        # (GuassDePyramid.h:89-104); we write PGMs instead of stdout walls.
        import os

        from sift_parallel_optimization.utils import native

        os.makedirs(args.dump_dir, exist_ok=True)
        for o, planes in enumerate(out):
            p = np.asarray(planes[0])
            p = (p - p.min()) / max(p.max() - p.min(), 1e-9)
            native.write_pgm(f"{args.dump_dir}/octave{o}.pgm", p)
        print(f"dumped {len(out)} octaves to {args.dump_dir}")
    return 0


def _cmd_features(args) -> int:
    import jax

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )

    img = _load_image(args)
    cfg = sift_config(img.shape[0])
    feats = jax.jit(
        lambda x: extract_features(x, cfg, args.max_keypoints)
    )(img)
    kp = feats.keypoints
    n = int(kp.count())
    print(f"{n} keypoints (capacity {kp.capacity})")
    import numpy as np

    v = np.asarray(kp.valid)
    if n:
        print(f"  sigma range: {np.asarray(kp.sigma)[v].min():.2f}"
              f" .. {np.asarray(kp.sigma)[v].max():.2f}")
        print(f"  octaves used: {sorted(set(np.asarray(kp.octave)[v].tolist()))}")
    return 0


def _save_traj(args, rvecs, tvecs, timestamps) -> None:
    """Export the estimated trajectory (``--save-traj``, TUM or KITTI)."""
    if not getattr(args, "save_traj", None):
        return
    from sift_parallel_optimization.utils.trajectory import (
        save_kitti,
        save_tum,
    )

    if args.traj_format == "kitti":
        save_kitti(args.save_traj, rvecs, tvecs)
    else:
        save_tum(args.save_traj, timestamps, rvecs, tvecs)
    print(f"trajectory written to {args.save_traj} ({args.traj_format})")


def _cmd_sfm(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.archive_policy != "fifo" and not (
        args.window and args.loop_closure
    ):
        # Fail loudly like the in-library ValueError paths: the policy
        # only exists inside the loop-closure archive (its help text
        # says "with --loop-closure"), and silently ignoring it would
        # let a typo'd invocation run a different configuration.
        print(
            "--archive-policy requires --window and --loop-closure "
            "(the archive ring only exists in loop-closed odometry)"
        )
        return 2

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.sfm import run_sfm
    from sift_parallel_optimization.models.ba import rms_error
    from sift_parallel_optimization.utils import native
    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    if args.image_dir:
        # Real-data mode: a directory of PGM/PPM/PNG frames (sorted by
        # name; TUM-style sequences name frames by timestamp so sorting
        # IS temporal order).
        import pathlib

        root = pathlib.Path(args.image_dir)
        paths = sorted(
            p for ext in ("*.pgm", "*.ppm", "*.png") for p in root.glob(ext)
        )
        if len(paths) < 2:
            print(f"need >= 2 .pgm/.ppm/.png frames in {args.image_dir}")
            return 1
        paths = paths[: args.frames] if args.frames else paths
        raw = [native.imread(p) for p in paths]
        # Center-crop every frame to the GLOBAL min (height, width) so
        # all frames share one shape (one compiled frontend) and the
        # optical center stays at K's principal point. Non-square frames
        # are supported natively — no square crop.
        gh = min(im.shape[0] for im in raw)
        gw = min(im.shape[1] for im in raw)
        imgs = []
        for im in raw:
            y0 = (im.shape[0] - gh) // 2
            x0 = (im.shape[1] - gw) // 2
            imgs.append(im[y0:y0 + gh, x0:x0 + gw])
        size = min(gh, gw)
        focal = args.focal or float(size)
        cfg = sift_config(size)
        K = jnp.array(
            [[focal, 0.0, gw / 2], [0.0, focal, gh / 2], [0.0, 0.0, 1.0]]
        )
        fe = jax.jit(
            lambda x: extract_features(x, cfg, 256, dual_orientation=True)
        )
        feats = [fe(jnp.asarray(im)) for im in imgs]
        if args.window:
            from sift_parallel_optimization.models.odometry import (
                run_odometry,
            )

            traj, m = run_odometry(
                jax.random.key(args.seed), feats, K, window=args.window,
                loop_closure=args.loop_closure,
                archive_policy=args.archive_policy,
                marginalize=not args.no_marginalize,
            )
            est_rvecs, est_tvecs = traj.rvecs, traj.tvecs
            print(f"window odometry (W={args.window}"
                  f"{', loop closure' if args.loop_closure else ''}): "
                  f"{len(imgs)} frames, "
                  f"{int(m.pt_valid.sum())} live landmarks")
        else:
            m = run_sfm(jax.random.key(args.seed), feats, K,
                        pair_selection=args.pair_selection)
            est_rvecs, est_tvecs = m.rvecs, m.tvecs
            print(f"cameras: {int(m.cam_valid.sum())}/{len(imgs)}  "
                  f"landmarks: {int(m.pt_valid.sum())}  "
                  f"observations: {int(m.obs.valid.sum())}")
        print(f"reprojection RMS: "
              f"{float(rms_error(m.ba_state(), m.obs, K)):.3f} px")
        c = np.asarray(est_tvecs)
        print(f"trajectory extent: {np.ptp(c, axis=0).round(3).tolist()}")
        frame_ts = []
        for i, p in enumerate(paths):
            try:
                frame_ts.append(float(p.stem))
            except ValueError:
                frame_ts.append(float(i))
        _save_traj(args, est_rvecs, est_tvecs, frame_ts)
        if args.groundtruth:
            # Associate frames with ground-truth poses, Sim(3)-align,
            # report ATE. TUM associates by timestamp (frames named by
            # timestamp); KITTI is frame-indexed.
            from sift_parallel_optimization.utils.trajectory import (
                associate,
                load_kitti,
                load_tum,
            )

            if args.gt_format == "kitti":
                gt_centers, _ = load_kitti(args.groundtruth)
                n = min(len(gt_centers), len(paths))
                ia = ib = np.arange(n)
            else:
                gt_ts, gt_centers, _ = load_tum(args.groundtruth)
                ia, ib = associate(frame_ts, gt_ts, max_dt=args.max_dt)
            if len(ia) < 3:
                print(f"only {len(ia)} frame<->gt associations; no ATE")
                return 1
            est = np.asarray(camera_centers(est_rvecs, est_tvecs))[ia]
            gt = gt_centers[ib]
            ate = float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
            span = float(np.linalg.norm(np.ptp(gt, axis=0)))
            print(f"ATE vs {args.groundtruth} over {len(ia)} poses: "
                  f"{ate:.4f} ({100 * ate / max(span, 1e-9):.2f}% of "
                  f"span {span:.3f})")
        return 0

    size = args.size
    focal = float(size)
    cfg = sift_config(size)
    K = jnp.array(
        [[focal, 0.0, size / 2], [0.0, focal, size / 2], [0.0, 0.0, 1.0]]
    )
    # Ground-truth trajectory through the native 3-D blob cloud: sideways
    # translation + slight yaw (real parallax).
    gt_rvecs = np.stack(
        [[0.0, 0.03 * i, 0.0] for i in range(args.frames)]
    ).astype(np.float32)
    gt_tvecs = np.stack(
        [[-0.35 * i, 0.0, 0.04 * i] for i in range(args.frames)]
    ).astype(np.float32)

    fe = jax.jit(
        lambda x: extract_features(x, cfg, 256, dual_orientation=True)
    )
    feats = []
    for i in range(args.frames):
        img = native.render_frame(
            size, gt_rvecs[i], gt_tvecs[i], focal, seed=args.seed
        )
        feats.append(fe(jnp.asarray(img)))
    if args.window:
        from sift_parallel_optimization.models.odometry import (
            run_odometry,
        )

        traj, m = run_odometry(
            jax.random.key(args.seed), feats, K, window=args.window,
            loop_closure=args.loop_closure,
            archive_policy=args.archive_policy,
            marginalize=not args.no_marginalize,
        )
        est_rvecs, est_tvecs = traj.rvecs, traj.tvecs
        print(f"window odometry (W={args.window}"
              f"{', loop closure' if args.loop_closure else ''}): "
              f"{args.frames} frames, "
              f"{int(m.pt_valid.sum())} live landmarks")
    else:
        m = run_sfm(jax.random.key(args.seed), feats, K,
                    pair_selection=args.pair_selection)
        est_rvecs, est_tvecs = m.rvecs, m.tvecs
        print(f"cameras: {int(m.cam_valid.sum())}/{args.frames}  "
              f"landmarks: {int(m.pt_valid.sum())}  "
              f"observations: {int(m.obs.valid.sum())}")
    print(f"reprojection RMS: {float(rms_error(m.ba_state(), m.obs, K)):.3f} px")
    _save_traj(args, est_rvecs, est_tvecs, list(range(args.frames)))
    est = camera_centers(est_rvecs, est_tvecs)
    if args.groundtruth:
        # External ground truth against the rendered run (frame-indexed
        # for KITTI, timestamp = frame index for TUM).
        from sift_parallel_optimization.utils.trajectory import (
            associate,
            load_kitti,
            load_tum,
        )

        if args.gt_format == "kitti":
            gt_centers, _ = load_kitti(args.groundtruth)
            n = min(len(gt_centers), args.frames)
            ia = ib = np.arange(n)
        else:
            gt_ts, gt_centers, _ = load_tum(args.groundtruth)
            ia, ib = associate(
                [float(i) for i in range(args.frames)], gt_ts,
                max_dt=args.max_dt,
            )
        if len(ia) < 3:
            print(f"only {len(ia)} frame<->gt associations; no ATE")
            return 1
        ate = float(ate_rmse(
            jnp.asarray(np.asarray(est)[ia]), jnp.asarray(gt_centers[ib])
        ))
        span = float(np.linalg.norm(np.ptp(gt_centers[ib], axis=0)))
        print(f"ATE vs {args.groundtruth} over {len(ia)} poses: "
              f"{ate:.4f} ({100 * ate / max(span, 1e-9):.2f}% of "
              f"span {span:.3f})")
        return 0
    gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
    ate = float(ate_rmse(est, gt))
    span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
    print(f"ATE (Sim3-aligned): {ate:.4f}  (trajectory span {span:.2f})")
    return 0


def _cmd_stream(args) -> int:
    """Continuous serving loop: native prefetch loader -> device frontend.

    The host-side C++ ring loader (native/sift_host.cpp) generates frames
    on worker threads while the device processes the previous one —
    end-to-end pipeline throughput, not kernel time.
    """
    import time

    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.utils import native

    cfg = sift_config(args.size)
    dual = bool(args.window)
    fe = jax.jit(
        lambda x: extract_features(
            x, cfg, args.max_keypoints, dual_orientation=dual
        )
    )
    stream = None
    if args.window:
        # ONLINE odometry on the live stream: loader -> frontend ->
        # OdometryStream.push, one fused device call per steady frame,
        # no per-frame host reads (poses stay lazy device arrays).
        from sift_parallel_optimization.models.odometry import (
            OdometryStream,
        )

        focal = float(args.size)
        K = jnp.array(
            [[focal, 0.0, args.size / 2],
             [0.0, focal, args.size / 2],
             [0.0, 0.0, 1.0]]
        )
        stream = OdometryStream(
            jax.random.key(args.seed), K, window=args.window,
            loop_closure=args.loop_closure,
        )
    with native.FrameLoader(
        args.size, n_buffers=4, n_threads=2, seed=args.seed
    ) as ld:
        # Warm up (compile).
        _, frame = ld.next_frame()
        feats = fe(jnp.asarray(frame))
        int(feats.keypoints.count())

        # Pipelined serving: dispatch is async, results are fetched at the
        # end, so host frame generation, H2D and device compute overlap.
        counts = []
        t0 = time.perf_counter()
        for _ in range(args.frames):
            _, frame = ld.next_frame()
            feats = fe(jnp.asarray(frame))
            counts.append(feats.keypoints.count())
            if stream is not None:
                stream.push(feats)
        n_kp = sum(int(c) for c in counts)  # drains the pipeline
        dt = time.perf_counter() - t0
    fps = args.frames / dt
    print(
        f"{args.frames} frames in {dt:.2f}s -> {fps:.1f} fps "
        f"({1e3 / fps:.2f} ms/frame end-to-end pipelined); "
        f"{n_kp / args.frames:.0f} keypoints/frame"
    )
    if stream is not None:
        import numpy as np

        traj, m, info = stream.finish()
        c = np.asarray(traj.tvecs)
        print(
            f"online odometry (W={args.window}"
            f"{', loop closure' if args.loop_closure else ''}): "
            f"{traj.rvecs.shape[0]} poses, "
            f"{len(info['loop_frames'])} loops, "
            f"extent {np.ptp(c, axis=0).round(3).tolist()}"
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sift_parallel_optimization")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="run the benchmark matrix")
    b.add_argument(
        "--workloads",
        default="pyramid,frontend,stages,stream,tracking,matching,ba,matrix,scaling",
    )
    b.add_argument("--out", default=None, help="JSONL path (default stdout)")
    b.set_defaults(fn=_cmd_bench)

    for name, fn in (("pyramid", _cmd_pyramid), ("features", _cmd_features)):
        c = sub.add_parser(name)
        c.add_argument("--image", default=None, help="input PGM")
        c.add_argument("--size", type=int, default=512)
        c.add_argument("--seed", type=int, default=0)
        if name == "pyramid":
            c.add_argument("--S", type=int, default=2)
            c.add_argument("--mode", choices=("reference", "sift"),
                           default="reference")
            c.add_argument("--dump-dir", default=None)
        else:
            c.add_argument("--max-keypoints", type=int, default=512)
        c.set_defaults(fn=fn)

    s = sub.add_parser("sfm", help="SfM on rendered or real PGM sequences")
    s.add_argument("--frames", type=int, default=6)
    s.add_argument("--size", type=int, default=256)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--image-dir", default=None,
                   help="directory of .pgm frames (real-data mode)")
    s.add_argument("--focal", type=float, default=None,
                   help="focal length in px (default: image side)")
    s.add_argument("--groundtruth", default=None,
                   help="trajectory file to gate ATE against")
    s.add_argument("--gt-format", choices=("tum", "kitti"), default="tum",
                   help="ground-truth format: TUM (timestamped quats) or "
                        "KITTI (frame-indexed 3x4 poses)")
    s.add_argument("--window", type=int, default=0,
                   help="sliding-window odometry with this window size "
                        "(0 = full incremental SfM; O(window) memory for "
                        "long sequences)")
    s.add_argument("--loop-closure", action="store_true",
                   help="with --window: archive evicted landmarks and "
                        "correct revisits via pose-graph optimization")
    s.add_argument("--archive-policy", choices=("fifo", "coverage"),
                   default="fifo",
                   help="with --loop-closure: ring-overwrite rule — "
                        "'fifo' (by age) or 'coverage' (overwrite the "
                        "spatially most redundant block; place memory "
                        "survives long revisit periods on small rings)")
    s.add_argument("--pair-selection", choices=("sequential", "covisibility"),
                   default="sequential",
                   help="full-SfM registration order: 'sequential' "
                        "(frame i vs i-1, temporally ordered captures) "
                        "or 'covisibility' (pairwise match-count table "
                        "-> maximum-covisibility spanning-tree order — "
                        "reconstructs shuffled/unordered photo sets)")
    s.add_argument("--no-marginalize", action="store_true",
                   help="with --window: disable anchor marginalization "
                        "(fixed-landmark factors for evicted blocks; on "
                        "by default — the ablation knob for drift "
                        "studies)")
    s.add_argument("--save-traj", default=None,
                   help="write the estimated trajectory to this path")
    s.add_argument("--traj-format", choices=("tum", "kitti"), default="tum")
    s.add_argument("--max-dt", type=float, default=0.02,
                   help="max timestamp gap for frame<->gt association (s)")
    s.set_defaults(fn=_cmd_sfm)

    st = sub.add_parser("stream", help="continuous frontend serving loop")
    st.add_argument("--frames", type=int, default=200)
    st.add_argument("--size", type=int, default=512)
    st.add_argument("--max-keypoints", type=int, default=512)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--window", type=int, default=0,
                    help="> 0: run ONLINE sliding-window odometry on the "
                         "stream (models/odometry.OdometryStream — one "
                         "fused device call per frame) and report the "
                         "live trajectory; 0 = frontend-only serving")
    st.add_argument("--loop-closure", action="store_true",
                    help="with --window: archive-ring loop closure + "
                         "end-of-stream pose-graph correction")
    st.set_defaults(fn=_cmd_stream)

    args = p.parse_args(argv)
    from sift_parallel_optimization.utils.runtime import (
        configure_compile_cache,
    )

    configure_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
