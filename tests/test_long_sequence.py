"""At-length evidence for the "sequences of ANY length" claim.

Round 3 claimed long-sequence capability with an 18-frame gate, a
unit-tested ring wrap, and a docstring about a 40-frame two-cycle
measurement. This file measures the claim (the discipline of the
reference's repeat-until-time harness, /root/reference/main.cpp:60-74):

* 120-frame THREE-cycle revisit: the archive ring wraps in anger (the
  sequence evicts ~14x the ring's block capacity), >= 3 loops are
  accepted by the device-side buffer, the Sim(3) PGO corrects the
  full trajectory to <= 5% of span and >= 1.8x better than windowed
  -only, and the window map's capacities stay O(window).
* 40-frame two-cycle regression: the configuration the Sim(3) module's
  docstring cites (models/odometry.py landmark_sim3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.odometry import run_odometry


def _render_cycles(size, n_frames, period):
    """Triangle-wave revisit trajectory: out to apex at period/2, back,
    repeat — every cycle after the first revisits archived places."""
    from sift_parallel_optimization.models.frontend import (
        extract_features,
        sift_config,
    )
    from sift_parallel_optimization.utils import native

    if not native.available():
        pytest.skip("native renderer unavailable")
    focal = float(size)
    cfg = sift_config(size)
    K = jnp.array(
        [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
        jnp.float32,
    )
    half = period // 2
    ks = [
        (i % period) if (i % period) <= half else period - (i % period)
        for i in range(n_frames)
    ]
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
        for i in range(n_frames)
    ]
    return feats, K, gt_rvecs, gt_tvecs


def _ates(feats, K, gt_rvecs, gt_tvecs, window, **loop_kw):
    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
    span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
    out = {}
    for lc in (False, True):
        traj, m, info = run_odometry(
            jax.random.key(1), feats, K, window=window,
            loop_closure=lc, return_info=True, **loop_kw,
        )
        est = camera_centers(traj.rvecs, traj.tvecs)
        out[lc] = float(ate_rmse(est, gt))
    return out, span, m, info


@pytest.mark.slow
def test_120_frame_three_cycle_revisit():
    n, period, window = 120, 40, 6
    feats, K, gt_rvecs, gt_tvecs = _render_cycles(256, n, period)
    # The default 64-block archive wraps ~1.8x over 114 evictions — the
    # ring is exercised in anger while still REMEMBERING a full cycle.
    # An 8-block FIFO ring recalls only the last 8 evicted frames, so
    # its loops are short-range trail constraints (measured this config:
    # 5 loops, 2.14% of span — barely under windowed-only's 2.33%).
    # DEFAULT knobs throughout (round 5): max_loops auto-sizes from the
    # sequence's structural acceptance bound, so nothing saturates.
    ates, span, m, info = _ates(feats, K, gt_rvecs, gt_tvecs, window)
    # O(window) memory: capacities track window, never n.
    assert m.rvecs.shape[0] == window
    assert m.points.shape[0] == window * 128
    assert m.obs.uv.shape[0] == 3 * window * 128
    # >= 3 loops accepted across the revisit cycles, none dropped.
    assert len(info["loop_frames"]) >= 3, info
    assert info["loops_dropped"] == 0, info
    # Accuracy: global 5% gate + >= 1.8x improvement over windowed-only.
    assert ates[True] < 0.05 * span, (ates, span)
    assert ates[True] * 1.8 < ates[False], (ates, span)
    # Age-stratified coverage eviction (archive_policy="coverage") must
    # make the same 8x-UNDERSIZED ring match the full-size ring: old
    # place memory survives any revisit period, so full-cycle loops
    # (gap ~40-100 frames) are still proposed. Measured: 10 loops,
    # 0.61% of span vs the full ring's 0.54% and FIFO-8's 2.14%.
    traj_c, _m, info_c = run_odometry(
        jax.random.key(1), feats, K, window=window, loop_closure=True,
        archive_size=8 * 128, archive_policy="coverage",
        return_info=True,
    )
    assert info_c["loops_dropped"] == 0, info_c
    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
    ate_c = float(ate_rmse(camera_centers(traj_c.rvecs, traj_c.tvecs), gt))
    assert len(info_c["loop_frames"]) >= 6, info_c
    assert ate_c < 0.012 * span, (ate_c, span)


@pytest.mark.slow
def test_500_frame_endurance(tmp_path):
    """Round-5 endurance gate: 500 frames (12.5 revisit cycles), DEFAULT
    knobs + coverage archive policy + checkpointing every 100 frames.

    What it proves at length: (a) memory stays O(window) — the map's
    capacities at the end are identical to a 20-frame run's; (b) the
    auto-sized loop buffer never drops an accepted-quality closure;
    (c) the Sim(3) chain-solver correction holds the GLOBAL 5%-of-span
    gate at 500 nodes (the dense path would need a ~12 GB cross
    tensor); (d) the chunked steady-state scan + checkpoint writer
    compose (5 checkpoints land)."""
    n, period, window = 500, 40, 6
    feats, K, gt_rvecs, gt_tvecs = _render_cycles(256, n, period)
    from sift_parallel_optimization.utils.trajectory import (
        ate_rmse,
        camera_centers,
    )

    traj, m, info = run_odometry(
        jax.random.key(1), feats, K, window=window, loop_closure=True,
        archive_policy="coverage", return_info=True,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=100,
    )
    # O(window) memory at 500 frames.
    assert m.rvecs.shape[0] == window
    assert m.points.shape[0] == window * 128
    assert m.obs.uv.shape[0] == 3 * window * 128
    # Defaults never drop closures; plenty are found across 12 cycles.
    assert info["loops_dropped"] == 0, info
    assert len(info["loop_frames"]) >= 10, info
    # Global accuracy gate at length.
    gt = camera_centers(jnp.asarray(gt_rvecs), jnp.asarray(gt_tvecs))
    span = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
    ate = float(ate_rmse(camera_centers(traj.rvecs, traj.tvecs), gt))
    assert ate < 0.05 * span, (ate, span)
    assert traj.rvecs.shape[0] == n
    # Checkpoints actually landed at the chunk boundaries.
    import os

    steps = sorted(
        int(d.name[5:]) for d in (tmp_path / "ckpt").iterdir()
        if d.name.startswith("step_") and d.name[5:].isdigit()
    )
    assert steps and steps[-1] >= 400, steps


@pytest.mark.slow
def test_40_frame_two_cycle_regression():
    """The configuration models/odometry.py's Sim(3) docstring cites."""
    n, period, window = 40, 20, 6
    feats, K, gt_rvecs, gt_tvecs = _render_cycles(256, n, period)
    ates, span, m, info = _ates(feats, K, gt_rvecs, gt_tvecs, window)
    assert info["loops_dropped"] == 0, info
    assert len(info["loop_frames"]) >= 2, info
    assert ates[True] < 0.05 * span, (ates, span)
    assert ates[True] * 1.5 < ates[False], (ates, span)
