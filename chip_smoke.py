"""Bring-up check of the SIFT -> odometry main path on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --long        # the same, plus the 500-frame run
    python chip_smoke.py --four-cards  # only the sharded phases, 4 cards

Every phase drives the library through its public entry points at the
sizes users run, prints each check with its measured value and its
tolerance, and prints its wall time (compile included) beside the card's
name and power limit. A failed check or an exception fails the phase, and
any failed phase fails the run. The last line of stdout is one JSON
object, ``{"ok": ..., "device": {"platform", "kind", "count"}}``; the
exit code is 0 only when every phase passed. Without a GPU the device
phase fails and nothing else runs.

One process holds the card for the whole run (the streaming CLI is
called in-process for that reason). CPU-backend references run in the
same process on ``jax.devices("cpu")``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class Run:
    """Check bookkeeping: one failure anywhere fails the run."""

    def __init__(self) -> None:
        self.failures: list[str] = []
        self.card = "unknown card"

    def check(self, name: str, ok: bool, detail: str) -> bool:
        print(f"  {'PASS' if ok else 'FAIL'}  {name}: {detail}", flush=True)
        if not ok:
            self.failures.append(name)
        return bool(ok)

    def phase(self, name: str, fn, *args, **kwargs) -> bool:
        print(f"== {name}", flush=True)
        before = len(self.failures)
        t0 = time.perf_counter()
        try:
            fn(self, *args, **kwargs)
        except Exception:  # recorded as a failure of this phase
            traceback.print_exc(file=sys.stdout)
            self.failures.append(f"{name}: exception")
        ok = len(self.failures) == before
        print(
            f"== {name}: {'PASS' if ok else 'FAIL'} in "
            f"{time.perf_counter() - t0:.1f} s wall, compile included "
            f"[{self.card}]",
            flush=True,
        )
        return ok


def _camera_k(size: int):
    import jax.numpy as jnp

    f = float(size)
    return jnp.array(
        [[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]],
        jnp.float32,
    )


def _revisit_poses(n: int, period: int):
    """Triangle-wave out-and-back trajectory (tests/test_long_sequence)."""
    half = period // 2
    ks = [
        (i % period) if (i % period) <= half else period - (i % period)
        for i in range(n)
    ]
    rv = np.array([[0.0, 0.025 * k, 0.002 * k] for k in ks], np.float32)
    tv = np.array([[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks], np.float32)
    return rv, tv


def _span_and_ate(rvecs, tvecs, gt_rvecs, gt_tvecs):
    import jax.numpy as jnp

    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
    span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
    ate = float(ate_rmse(camera_centers(rvecs, tvecs), gt))
    return span, ate


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------


def phase_device(run: Run, n_cards: int) -> None:
    import jax

    from sift_parallel_optimization.utils.runtime import (
        gpu_name_and_power_limit,
    )

    devs = jax.devices()
    print(f"  jax {jax.__version__}; devices: {devs}")
    on_gpu = devs[0].platform == "gpu"
    run.check("platform is gpu", on_gpu, f"platform={devs[0].platform}")
    if not on_gpu:
        return
    run.card = " / ".join(gpu_name_and_power_limit().splitlines())
    print(f"  nvidia-smi name, power.limit: {run.card}")
    run.check(f"{n_cards} card(s) visible", len(devs) == n_cards,
              f"count={len(devs)}")


# ---------------------------------------------------------------------------
# Phase 2: pyramids against float64 NumPy
# ---------------------------------------------------------------------------


def _np_sift_pyramid(img: np.ndarray, cfg) -> list[np.ndarray]:
    """Float64 cascade of the SIFT Gaussian pyramid: separable blurs with
    the library's edge-clamped taps, then every-other-pixel subsampling
    of scale S for the next octave's base."""
    import math

    from sift_parallel_optimization.core.pyramid_ref import (
        _blur_matrix_np,
        _octave_scale_sigmas,
    )

    def blur(x, sigma):
        bh = _blur_matrix_np(x.shape[0], sigma).astype(np.float64)
        bw = _blur_matrix_np(x.shape[1], sigma).astype(np.float64)
        return bh.T @ x @ bw

    base_sigma = math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
    x = blur(img.astype(np.float64), base_sigma)
    out = []
    for _ in range(cfg.n_octaves):
        planes = [x] + [blur(x, s) for s in _octave_scale_sigmas(cfg)]
        out.append(np.stack(planes))
        x = planes[cfg.S][::2, ::2]
    return out


def phase_pyramid(run: Run, size: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.core.numpy_golden import (
        golden_dog_pyramid,
    )
    from sift_parallel_optimization.core.pyramid_ref import (
        reference_dog_pyramid,
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models.frontend import sift_config

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(size, size)).astype(np.float32)
    ours = jax.jit(lambda x: reference_dog_pyramid(x, 2))(jnp.asarray(img))
    golden = golden_dog_pyramid(img, 2)
    maxrel = max(
        float(np.max(np.abs(np.asarray(u, np.float64) - g)
                     / (np.abs(g) + 1e-3)))
        for u, g in zip(ours, golden)
    )
    run.check(
        f"REFERENCE DoG pyramid {size}^2 S=2 vs NumPy golden",
        len(ours) == len(golden) and maxrel < 5e-3,
        f"max rel err {maxrel:.3e} (tolerance 5e-3: float32 windowed "
        "planes differenced, relative to |golden| + 1e-3)",
    )

    cfg = sift_config(size)
    img01 = rng.random((size, size)).astype(np.float32)
    gauss = jax.jit(lambda x: sift_gaussian_pyramid(x, cfg))(
        jnp.asarray(img01)
    )
    ref = _np_sift_pyramid(img01, cfg)
    maxabs = max(
        float(np.max(np.abs(np.asarray(g, np.float64) - r)))
        for g, r in zip(gauss, ref)
    )
    run.check(
        f"SIFT Gaussian pyramid {size}^2 S={cfg.S} vs float64 NumPy",
        len(gauss) == len(ref) and maxabs < 1e-4,
        f"max abs err {maxabs:.3e} on a [0, 1] image (tolerance 1e-4: "
        "float32 blurs pinned to HIGHEST err ~1e-6; TF32 would give ~1e-3)",
    )


# ---------------------------------------------------------------------------
# Phase 3: frontend
# ---------------------------------------------------------------------------


def _keyset(kp) -> set:
    v = np.asarray(kp.valid)
    return set(zip(
        np.round(np.asarray(kp.x)[v], 2),
        np.round(np.asarray(kp.y)[v], 2),
        np.round(np.asarray(kp.sigma)[v], 2),
    ))


def _match_features(fa, fb, k: int):
    """Pair primary-slot keypoints of two extractions by octave and
    position (0.1 px); returns (n_a, n_b, descriptor cosines of pairs)."""
    def prim(f):
        kp = f.keypoints
        v = np.asarray(kp.valid)[:k]
        return (
            np.asarray(kp.x)[:k][v], np.asarray(kp.y)[:k][v],
            np.asarray(kp.octave)[:k][v], np.asarray(f.descriptors)[:k][v],
        )

    xa, ya, oa, da = prim(fa)
    xb, yb, ob, db = prim(fb)
    sims = []
    for i in range(len(xa)):
        d2 = (xb - xa[i]) ** 2 + (yb - ya[i]) ** 2
        d2 = np.where(ob == oa[i], d2, np.inf)
        if d2.size and d2.min() < 0.01:
            sims.append(float(da[i] @ db[int(d2.argmin())]))
    return len(xa), len(xb), np.asarray(sims)


def phase_frontend(run: Run, size: int = 512, k: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.core.pyramid_ref import (
        sift_dog_pyramid,
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models import descriptor as D
    from sift_parallel_optimization.models.detect import detect_pyramid
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.utils import native

    cfg = sift_config(size)
    z = np.zeros(3, np.float32)
    frame = native.render_frame(size, z, z, float(size), seed=0)
    fe = jax.jit(lambda x: extract_features(x, cfg, k, dual_orientation=True))
    f_dev = fe(jnp.asarray(frame))
    f_cpu = fe(jax.device_put(frame, jax.devices("cpu")[0]))

    n_dev, n_cpu, sims = _match_features(f_dev, f_cpu, k)
    band = max(3, int(0.02 * n_cpu))
    run.check(
        "keypoint count within the CPU band",
        n_cpu > 0 and abs(n_dev - n_cpu) <= band,
        f"device {n_dev}, CPU {n_cpu} (tolerance +-{band}: 2% or 3)",
    )
    overlap = len(sims) / max(n_dev, n_cpu, 1)
    run.check(
        "keypoint-set overlap with the CPU", overlap >= 0.97,
        f"{len(sims)}/{max(n_dev, n_cpu)} = {overlap:.4f} matched within "
        "0.1 px (tolerance >= 0.97: summation order moves near-threshold "
        "candidates)",
    )
    med = float(np.median(sims)) if len(sims) else 0.0
    good = float(np.mean(sims >= 0.9)) if len(sims) else 0.0
    run.check(
        "descriptors agree with the CPU", med >= 0.999 and good >= 0.95,
        f"median cosine {med:.5f} (>= 0.999), share >= 0.9 {good:.4f} "
        "(>= 0.95: default-precision histogram votes run in TF32 on the "
        "card, float32 on the CPU, and a near-tied orientation peak may "
        "flip)",
    )
    desc = np.asarray(f_dev.descriptors)[np.asarray(f_dev.keypoints.valid)]
    norms = np.linalg.norm(desc, axis=1)
    run.check(
        "descriptor norms == 1",
        desc.shape[0] > 0 and bool(np.allclose(norms, 1.0, atol=1e-3)),
        f"min {norms.min():.5f} max {norms.max():.5f} (atol 1e-3)",
    )

    # The descriptor stage's patch gather at its real width, against
    # NumPy slicing of the same atlas on the host.
    gauss = jax.jit(lambda x: sift_gaussian_pyramid(x, cfg))(
        jnp.asarray(frame)
    )
    atlas = jax.jit(lambda g: D.build_atlas(g)[0])(gauss)
    rows = D.patch_rows_for(D.max_patch_radius(cfg.S, cfg.sigma0))
    cols = D.PATCH_COLS
    r_max, c_max = atlas.shape[0] - rows, atlas.shape[1] - cols
    rng = np.random.default_rng(1)
    ys = rng.integers(0, r_max + 1, k).astype(np.int32)
    xs = (rng.integers(0, c_max // 128 + 1, k) * 128).astype(np.int32)
    patches = jax.jit(
        lambda a, y, x: D.extract_atlas_patches(a, y, x, rows, cols)
    )(atlas, jnp.asarray(ys), jnp.asarray(xs))
    a_np = np.asarray(atlas)
    ref = np.stack(
        [a_np[y:y + rows, x:x + cols] for y, x in zip(ys, xs)]
    )
    run.check(
        f"patch gather ({k} x {rows} x {cols}) == NumPy slicing",
        bool(np.array_equal(np.asarray(patches), ref)),
        "bit for bit",
    )

    dogs = jax.jit(lambda x: sift_dog_pyramid(x, cfg))(jnp.asarray(frame))
    kp_exact = jax.jit(
        lambda d: detect_pyramid(d, cfg, k, use_approx_topk=False)
    )(dogs)
    kp_approx = jax.jit(
        lambda d: detect_pyramid(d, cfg, k, use_approx_topk=True)
    )(dogs)
    se, sa = _keyset(kp_exact), _keyset(kp_approx)
    recall = len(se & sa) / max(len(se), 1)
    run.check(
        "approximate vs exact top-k recall", len(se) > 0 and recall >= 0.99,
        f"{len(se & sa)}/{len(se)} = {recall:.4f} (tolerance >= 0.99)",
    )


# ---------------------------------------------------------------------------
# Phase 4: online odometry
# ---------------------------------------------------------------------------


def phase_revisit_gate(run: Run, size: int = 256, n: int = 18) -> None:
    """The 18-frame out-and-back revisit gate, four ablations."""
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.odometry import run_odometry
    from sift_parallel_optimization.utils import native

    cfg = sift_config(size)
    K = _camera_k(size)
    ks = [i if i <= n // 2 else n - 1 - i for i in range(n)]
    gt_r = np.array([[0.0, 0.025 * k, 0.002 * k] for k in ks], np.float32)
    gt_t = np.array([[-0.25 * k, 0.012 * k, 0.035 * k] for k in ks],
                    np.float32)
    fe = jax.jit(lambda x: extract_features(x, cfg, 256,
                                            dual_orientation=True))
    feats = [
        fe(jnp.asarray(native.render_frame(size, gt_r[i], gt_t[i],
                                           float(size), seed=3)))
        for i in range(n)
    ]
    ates = {}
    span = 0.0
    for marg, lc in ((True, False), (True, True), (False, False),
                     (False, True)):
        traj, _ = run_odometry(
            jax.random.key(1), feats, K, window=6,
            loop_closure=lc, marginalize=marg,
        )
        span, ates[(marg, lc)] = _span_and_ate(
            traj.rvecs, traj.tvecs, gt_r, gt_t
        )
        print(f"  marginalize={marg} loop_closure={lc}: ATE "
              f"{ates[(marg, lc)]:.4f} "
              f"({100 * ates[(marg, lc)] / span:.2f}% of span {span:.3f})")
    for key, name in (
        ((True, False), "anchored windowed-only"),
        ((True, True), "anchored loop-closed"),
        ((False, False), "ablation: no anchors"),
        ((False, True), "ablation: no anchors, loop-closed"),
    ):
        run.check(f"{name} ATE < 5% of span", ates[key] < 0.05 * span,
                  f"{100 * ates[key] / span:.2f}%")
    run.check(
        "loop closure no degradation (<= 1.1x)",
        ates[(True, True)] <= ates[(True, False)] * 1.1,
        f"{ates[(True, True)]:.4f} vs {ates[(True, False)]:.4f}",
    )
    run.check(
        "anchors never hurt (<= 1.1x)",
        ates[(True, False)] <= ates[(False, False)] * 1.1,
        f"{ates[(True, False)]:.4f} vs {ates[(False, False)]:.4f}",
    )


def phase_stream_sequence(
    run: Run, size: int = 512, n: int = 120, period: int = 40,
    k: int = 512,
) -> None:
    """Out-and-back sequence pushed frame by frame through the online
    odometry stream (W=6, loop closure on)."""
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.odometry import OdometryStream
    from sift_parallel_optimization.utils import native

    cfg = sift_config(size)
    K = _camera_k(size)
    gt_r, gt_t = _revisit_poses(n, period)
    fe = jax.jit(lambda x: extract_features(x, cfg, k, dual_orientation=True))
    stream = OdometryStream(jax.random.key(1), K, window=6,
                            loop_closure=True)
    t0 = time.perf_counter()
    for i in range(n):
        img = native.render_frame(size, gt_r[i], gt_t[i], float(size), seed=3)
        stream.push(fe(jnp.asarray(img)))
    traj, _, info = stream.finish()
    span, ate = _span_and_ate(traj.rvecs, traj.tvecs, gt_r, gt_t)
    print(f"  {n} frames {size}^2 in {time.perf_counter() - t0:.1f} s "
          f"(render + frontend + stream, compile included)")
    run.check(f"{n}-frame ATE < 5% of span", ate < 0.05 * span,
              f"{ate:.4f} = {100 * ate / span:.2f}% of span {span:.3f}")
    run.check(">= 1 accepted loop", len(info["loop_frames"]) >= 1,
              f"{len(info['loop_frames'])} loops at {info['loop_frames']}")
    run.check("no dropped loops", info["loops_dropped"] == 0,
              f"n_dropped={info['loops_dropped']}")


# ---------------------------------------------------------------------------
# Phase 5: streaming CLI, in-process
# ---------------------------------------------------------------------------


def phase_cli_stream(run: Run, frames: int = 200, size: int = 512) -> None:
    from sift_parallel_optimization import cli

    rc = cli.main(["stream", "--frames", str(frames), "--size", str(size),
                   "--window", "6", "--loop-closure"])
    run.check("cli stream exit code", rc == 0, f"rc={rc}")


# ---------------------------------------------------------------------------
# Phase 6: SfM
# ---------------------------------------------------------------------------


def phase_sfm(run: Run, size: int = 256, n: int = 5) -> None:
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.ba import rms_error
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.sfm import run_sfm
    from sift_parallel_optimization.utils import native

    gt_r = np.array([[0.0, 0.03 * i, 0.0] for i in range(n)], np.float32)
    gt_t = np.array([[-0.35 * i, 0.0, 0.04 * i] for i in range(n)],
                    np.float32)
    K = _camera_k(size)
    cfg = sift_config(size)
    fe = jax.jit(lambda x: extract_features(x, cfg, 256))
    feats = [
        fe(jnp.asarray(native.render_frame(size, gt_r[i], gt_t[i],
                                           float(size), seed=0)))
        for i in range(n)
    ]
    m = run_sfm(jax.random.key(0), feats, K)
    rms = float(rms_error(m.ba_state(), m.obs, K))
    span, ate = _span_and_ate(m.rvecs, m.tvecs, gt_r, gt_t)
    run.check("SfM reprojection RMS < 1 px", rms < 1.0, f"{rms:.4f} px")
    run.check("SfM ATE < 5% of span", ate < 0.05 * span,
              f"{ate:.4f} = {100 * ate / span:.2f}% of span {span:.3f}")


# ---------------------------------------------------------------------------
# Phase 7: back end at size
# ---------------------------------------------------------------------------

BA_NOISE_PX = 0.5


def ba_problem(n_cams: int = 50, n_pts: int = 2000, seed: int = 0):
    """Every camera sees every point (n_cams * n_pts observations) with
    Gaussian pixel noise of BA_NOISE_PX; returns (initial state, obs, K,
    expected final RMS)."""
    import jax.numpy as jnp

    from sift_parallel_optimization.models.ba import BAState, Observations
    from sift_parallel_optimization.models.geometry import project

    rng = np.random.default_rng(seed)
    K = jnp.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    pts = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 10.0
    th = np.linspace(-0.3, 0.3, n_cams)
    rv = np.stack([np.zeros(n_cams), th, np.zeros(n_cams)], 1)
    tv = np.stack([np.linspace(-2, 2, n_cams), np.zeros(n_cams),
                   np.zeros(n_cams)], 1)
    rv, tv = rv.astype(np.float32), tv.astype(np.float32)
    uv = np.concatenate([
        np.asarray(project(jnp.asarray(pts), jnp.asarray(rv[i]),
                           jnp.asarray(tv[i]), K)[0])
        for i in range(n_cams)
    ])
    uv = uv + rng.normal(0.0, BA_NOISE_PX, uv.shape).astype(np.float32)
    obs = Observations(
        cam_idx=jnp.repeat(jnp.arange(n_cams, dtype=jnp.int32), n_pts),
        pt_idx=jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), n_cams),
        uv=jnp.asarray(uv), valid=jnp.ones(n_cams * n_pts, bool),
    )
    init = BAState(
        rvecs=jnp.asarray(rv + rng.normal(0, 0.002, rv.shape).astype(
            np.float32)).at[0].set(rv[0]),
        tvecs=jnp.asarray(tv + rng.normal(0, 0.01, tv.shape).astype(
            np.float32)).at[0].set(tv[0]),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(
            np.float32)),
    )
    # rms_error is per observation (2-vector): noise * sqrt(2) at the
    # truth, times sqrt(1 - params / residuals) at the least-squares fit.
    dof = 1.0 - (6 * (n_cams - 1) + 3 * n_pts) / (2.0 * n_cams * n_pts)
    return init, obs, K, BA_NOISE_PX * float(np.sqrt(2.0 * dof))


BA_KW = dict(n_iters=10, damping=1e-4, solver="cg")


def phase_backend(run: Run, n_cams: int = 50, n_pts: int = 2000,
                  n_nodes: int = 1000) -> None:
    import jax

    from sift_parallel_optimization.models.ba import bundle_adjust, rms_error

    cpu = jax.devices("cpu")[0]
    init, obs, K, expect = ba_problem(n_cams, n_pts)
    ba = jax.jit(lambda s, o, k: bundle_adjust(s, o, k, **BA_KW))
    out = ba(init, obs, K)
    rms = float(rms_error(out, obs, K))
    init_c, obs_c, K_c = jax.device_put((init, obs, K), cpu)
    out_c = ba(init_c, obs_c, K_c)
    rms_c = float(rms_error(out_c, obs_c, K_c))
    run.check(
        f"CG BA {n_cams} cams / {n_pts} pts / {n_cams * n_pts} obs: "
        "RMS at the noise level",
        abs(rms - expect) <= 0.03 * expect,
        f"{rms:.4f} px vs expected {expect:.4f} px (noise "
        f"{BA_NOISE_PX} px; tolerance 3%)",
    )
    run.check(
        "CG BA RMS matches the CPU backend",
        abs(rms - rms_c) <= 0.01 * rms_c,
        f"device {rms:.5f} px, CPU {rms_c:.5f} px (tolerance 1%)",
    )
    dt = float(np.max(np.abs(np.asarray(out.tvecs) - np.asarray(out_c.tvecs))))
    run.check("CG BA poses match the CPU backend", dt <= 1e-2,
              f"max |dt| {dt:.2e} in a 4-unit scene (tolerance 1e-2)")

    p0, edges, gt, ramp = sim3_chain_problem(n_nodes)
    pgo = jax.jit(lambda p, e: sim3_chain_solve(p, e, n_nodes))
    out = pgo(p0, edges)
    out_c = pgo(*jax.device_put((p0, edges), cpu))
    ate0, ate1, ls = _sim3_report(p0, out, gt)
    _, ate1_c, ls_c = _sim3_report(p0, out_c, gt)
    run.check(
        f"Sim(3) chain PGO {n_nodes} nodes shrinks the ATE",
        ate1 < 0.15 * ate0, f"{ate0:.4f} -> {ate1:.4f} (tolerance < 0.15x)",
    )
    corr = float(np.corrcoef(ls, ramp)[0, 1])
    run.check("Sim(3) log-scale recovers the ramp",
              abs(ls[-1] - ramp[-1]) < 0.15 and corr > 0.95,
              f"end {ls[-1]:.4f} vs {ramp[-1]:.4f}, corr {corr:.4f}")
    dls = float(np.max(np.abs(ls - ls_c)))
    run.check(
        "Sim(3) chain PGO matches the CPU backend",
        abs(ate1 - ate1_c) <= 0.02 * max(ate1_c, 1e-3) + 1e-4 and dls < 1e-2,
        f"ATE device {ate1:.5f} CPU {ate1_c:.5f}, max |d log_s| {dls:.2e} "
        "(tolerance 2% + 1e-4 and 1e-2)",
    )


def sim3_chain_problem(n: int = 1000):
    """Loopy planar path with a multiplicative scale ramp (to 1.5x) in its
    odometry edges and metric loop edges every 100 nodes
    (tests/test_pose_graph_sim3 thousand-node case)."""
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.geometry import (
        rodrigues,
        rotation_log,
    )
    from sift_parallel_optimization.models.pose_graph import relative_pose
    from sift_parallel_optimization.models.pose_graph_sim3 import (
        Sim3Edges,
        se3_to_sim3_poses,
    )

    rng = np.random.default_rng(3)
    th = np.linspace(0, 10 * np.pi, n)
    gt_t = np.stack([np.cos(th), np.sin(th), 0.05 * rng.normal(size=n)],
                    1).astype(np.float32)
    gt_r = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    rel_r, rel_t = jax.vmap(relative_pose)(
        gt_r[:-1], gt_t[:-1], gt_r[1:], gt_t[1:]
    )
    rel_R = np.asarray(rodrigues(rel_r), np.float64)
    rel_t = np.asarray(rel_t, np.float64)
    per_edge = float(np.exp(np.log(1.5) / (n - 1)))
    Rs = [np.asarray(rodrigues(jnp.asarray(gt_r[0])), np.float64)]
    ts = [gt_t[0].astype(np.float64)]
    s = 1.0
    for i in range(n - 1):
        s *= per_edge
        ts.append(rel_R[i] @ ts[-1] + s * rel_t[i])
        Rs.append(rel_R[i] @ Rs[-1])
    est_r = jax.vmap(rotation_log)(jnp.asarray(np.stack(Rs), jnp.float32))
    est_t = jnp.asarray(np.stack(ts), jnp.float32)
    rr_chain, rt_chain = jax.vmap(relative_pose)(
        est_r[:-1], est_t[:-1], est_r[1:], est_t[1:]
    )
    loop_i = np.asarray(list(range(0, n - 200, 100)) + [n - 201], np.int32)
    loop_j = loop_i + 200
    rr_loop, rt_loop = jax.vmap(relative_pose)(
        gt_r[loop_i], gt_t[loop_i], gt_r[loop_j], gt_t[loop_j]
    )
    m = len(loop_i)
    edges = Sim3Edges(
        i=jnp.asarray(np.concatenate([np.arange(n - 1), loop_i]), jnp.int32),
        j=jnp.asarray(np.concatenate([np.arange(1, n), loop_j]), jnp.int32),
        rel_rvec=jnp.concatenate([rr_chain, rr_loop]),
        rel_tvec=jnp.concatenate([rt_chain, rt_loop]),
        rel_log_s=jnp.zeros(n - 1 + m, jnp.float32),
        weight=jnp.asarray(np.concatenate(
            [np.ones(n - 1), np.full(m, 8.0)]), jnp.float32),
        metric=jnp.asarray(np.concatenate(
            [np.zeros(n - 1), np.ones(m)]), jnp.float32),
    )
    ramp = np.log(1.5) * np.arange(n) / (n - 1)
    return se3_to_sim3_poses(est_r, est_t), edges, (gt_r, gt_t), ramp


def sim3_chain_solve(p0, edges, n: int):
    from sift_parallel_optimization.models.pose_graph_sim3 import (
        chain_damping,
        optimize_sim3_graph,
    )

    n_loops = edges.i.shape[0] - (n - 1)
    return optimize_sim3_graph(
        p0, edges, n_iters=12, damping=chain_damping(n, 1e-4),
        offchain_cap=n_loops,
    )


def _sim3_report(p0, out, gt):
    import jax.numpy as jnp

    from sift_parallel_optimization.models.pose_graph_sim3 import (
        sim3_to_se3_poses,
    )
    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    gt_c = camera_centers(jnp.asarray(gt[0]), jnp.asarray(gt[1]))
    r0, t0 = sim3_to_se3_poses(p0)
    r1, t1 = sim3_to_se3_poses(out)
    ate0 = float(ate_rmse(camera_centers(r0, t0), gt_c, with_scale=False))
    ate1 = float(ate_rmse(camera_centers(r1, t1), gt_c, with_scale=False))
    return ate0, ate1, np.asarray(out.log_s, np.float64)


# ---------------------------------------------------------------------------
# --long: 500-frame endurance
# ---------------------------------------------------------------------------


def phase_endurance(run: Run, size: int = 256, n: int = 500,
                    period: int = 40) -> None:
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.models.odometry import run_odometry
    from sift_parallel_optimization.utils import native

    cfg = sift_config(size)
    K = _camera_k(size)
    gt_r, gt_t = _revisit_poses(n, period)
    fe = jax.jit(lambda x: extract_features(x, cfg, 256,
                                            dual_orientation=True))
    feats = [
        fe(jnp.asarray(native.render_frame(size, gt_r[i], gt_t[i],
                                           float(size), seed=3)))
        for i in range(n)
    ]
    traj, m, info = run_odometry(
        jax.random.key(1), feats, K, window=6, loop_closure=True,
        archive_policy="coverage", return_info=True,
    )
    span, ate = _span_and_ate(traj.rvecs, traj.tvecs, gt_r, gt_t)
    run.check(f"{n}-frame ATE < 5% of span", ate < 0.05 * span,
              f"{ate:.4f} = {100 * ate / span:.2f}% of span {span:.3f}")
    run.check("loops accepted, none dropped",
              len(info["loop_frames"]) >= 10 and info["loops_dropped"] == 0,
              f"{len(info['loop_frames'])} loops, "
              f"{info['loops_dropped']} dropped")
    run.check("map capacity stays O(window)", m.rvecs.shape[0] == 6,
              f"{m.rvecs.shape[0]} cameras")


# ---------------------------------------------------------------------------
# --four-cards: the sharded paths
# ---------------------------------------------------------------------------


def phase_sharded_frontend(run: Run, n_dev: int = 4, batch: int = 16,
                           size: int = 512, k: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.parallel.frontend import (
        batched_extract_features,
    )
    from sift_parallel_optimization.parallel.mesh import make_mesh
    from sift_parallel_optimization.utils import native

    cfg = sift_config(size)
    rv, tv = _revisit_poses(batch, 40)
    frames = jnp.asarray(np.stack([
        native.render_frame(size, rv[i], tv[i], float(size), seed=3)
        for i in range(batch)
    ]))
    mesh = make_mesh(n_data=n_dev, n_spatial=1)
    sharded = jax.jit(
        lambda x: batched_extract_features(x, cfg, k, mesh)
    )(frames)
    one = jax.jit(jax.vmap(lambda x: extract_features(x, cfg, k)))(
        jax.device_put(frames, jax.devices()[0])
    )
    same_kp = all(
        bool(np.array_equal(np.asarray(a), np.asarray(b)))
        for a, b in zip(
            (sharded.keypoints.valid, sharded.keypoints.octave),
            (one.keypoints.valid, one.keypoints.octave),
        )
    )
    dxy = float(np.max(np.abs(
        np.asarray(sharded.keypoints.x) - np.asarray(one.keypoints.x))))
    v = np.asarray(one.keypoints.valid)
    sims = np.sum(
        np.asarray(sharded.descriptors) * np.asarray(one.descriptors), -1
    )[v]
    run.check(
        f"sharded frontend ({n_dev} cards, {batch} frames) keypoints == "
        "one card", same_kp and dxy < 1e-3,
        f"valid/octave equal: {same_kp}, max |dx| {dxy:.2e} (tolerance 1e-3)",
    )
    run.check(
        "sharded frontend descriptors match one card",
        float(np.median(sims)) >= 0.999,
        f"median cosine {float(np.median(sims)):.5f} over {v.sum()} "
        "keypoints (tolerance >= 0.999)",
    )


def phase_sharded_ba(run: Run, n_dev: int = 4, n_cams: int = 50,
                     n_pts: int = 2000) -> None:
    import jax

    from sift_parallel_optimization.models.ba import bundle_adjust, rms_error
    from sift_parallel_optimization.parallel.ba import (
        distributed_bundle_adjust,
    )
    from sift_parallel_optimization.parallel.mesh import make_mesh

    init, obs, K, expect = ba_problem(n_cams, n_pts)
    mesh = make_mesh(n_data=n_dev, n_spatial=1)
    dist = jax.jit(
        lambda s, o: distributed_bundle_adjust(s, o, K, mesh, **BA_KW)
    )(init, obs)
    one = jax.jit(lambda s, o: bundle_adjust(s, o, K, **BA_KW))(
        *jax.device_put((init, obs), jax.devices()[0])
    )
    rms_d, rms_1 = float(rms_error(dist, obs, K)), float(rms_error(one, obs, K))
    run.check(
        f"distributed CG BA ({n_dev} cards) RMS matches one card",
        abs(rms_d - rms_1) <= 0.01 * rms_1
        and abs(rms_d - expect) <= 0.03 * expect,
        f"{rms_d:.5f} vs {rms_1:.5f} px, expected {expect:.4f} "
        "(tolerances 1% and 3%)",
    )
    dt = float(np.max(np.abs(np.asarray(dist.tvecs) - np.asarray(one.tvecs))))
    run.check("distributed CG BA poses match one card", dt <= 1e-2,
              f"max |dt| {dt:.2e} (tolerance 1e-2)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--long", action="store_true",
                   help="also run the 500-frame endurance sequence")
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded phases on a 4-card mesh")
    args = p.parse_args(argv)

    import jax

    from sift_parallel_optimization.utils.runtime import (
        configure_compile_cache,
    )

    configure_compile_cache()
    run = Run()
    n_cards = 4 if args.four_cards else 1
    if run.phase("1 device", phase_device, n_cards):
        if args.four_cards:
            run.phase("4a sharded frontend", phase_sharded_frontend)
            run.phase("4b sharded CG BA", phase_sharded_ba)
        else:
            run.phase("2 pyramid", phase_pyramid)
            run.phase("3 frontend", phase_frontend)
            run.phase("4a revisit gate (18 frames, 256^2)",
                      phase_revisit_gate)
            run.phase("4b online odometry (120 frames, 512^2)",
                      phase_stream_sequence)
            run.phase("5 streaming CLI", phase_cli_stream)
            run.phase("6 SfM", phase_sfm)
            run.phase("7 back end at size", phase_backend)
            if args.long:
                run.phase("8 endurance (500 frames)", phase_endurance)
    ok = not run.failures
    if run.failures:
        print(f"failed: {run.failures}")
    try:
        d = jax.devices()
        dev = {"platform": d[0].platform, "kind": d[0].device_kind,
               "count": len(d)}
    except RuntimeError:
        dev = {"platform": None, "kind": None, "count": 0}
    print(json.dumps({"ok": ok, "device": dev}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
