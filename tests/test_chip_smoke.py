"""chip_smoke.py on the CPU: it must refuse to run, and its references
(the float64 pyramid cascade, the BA noise-floor model) must agree with
the library where the CPU can check them."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_np_sift_pyramid_matches_library():
    from sift_parallel_optimization.core.pyramid_ref import (
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models.frontend import sift_config

    cfg = sift_config(64)
    img = np.random.default_rng(0).random((64, 64)).astype(np.float32)
    ours = sift_gaussian_pyramid(jnp.asarray(img), cfg)
    ref = chip_smoke._np_sift_pyramid(img, cfg)
    assert len(ours) == len(ref)
    for g, r in zip(ours, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(np.asarray(g), r, atol=1e-5)


def test_ba_problem_converges_to_noise_floor():
    from sift_parallel_optimization.models.ba import bundle_adjust, rms_error

    init, obs, K, expect = chip_smoke.ba_problem(6, 120)
    out = jax.jit(
        lambda s, o: bundle_adjust(s, o, K, **chip_smoke.BA_KW)
    )(init, obs)
    rms = float(rms_error(out, obs, K))
    assert float(rms_error(init, obs, K)) > 2 * expect
    assert abs(rms - expect) <= 0.03 * expect, (rms, expect)


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the bring-up script fails its device phase, runs
    nothing else, and ends with an ``"ok": false`` JSON line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"
    assert "== 2 pyramid" not in out.stdout
