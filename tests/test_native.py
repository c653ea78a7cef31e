"""Tests for the native host runtime (C++ via ctypes)."""

import numpy as np
import pytest

from sift_parallel_optimization.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build failed: {native.build_error()}"
)


def test_pgm_roundtrip(tmp_path, rng):
    img = rng.random((37, 53)).astype(np.float32)
    p = tmp_path / "t.pgm"
    native.write_pgm(p, img)
    back = native.read_pgm(p)
    assert back.shape == (37, 53)
    np.testing.assert_allclose(back, img, atol=1.0 / 255 + 1e-6)


def test_synth_frame_deterministic():
    a = native.synth_frame(128, 3, seed=7)
    b = native.synth_frame(128, 3, seed=7)
    c = native.synth_frame(128, 4, seed=7)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0.01  # frames differ
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert a.std() > 0.02  # has actual content


def test_synth_frames_overlap():
    # Consecutive frames drift by ~0.9 px: shifted content should correlate.
    a = native.synth_frame(128, 10, seed=1)
    b = native.synth_frame(128, 11, seed=1)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr > 0.5


def test_loader_streams_all_frames():
    with native.FrameLoader(64, n_buffers=4, n_threads=2, seed=5) as ld:
        seen = {}
        for _ in range(12):
            idx, frame = ld.next_frame()
            assert frame.shape == (64, 64)
            seen[idx] = frame
    # All indices 0..11 produced exactly once (order may vary).
    assert sorted(seen) == list(range(12))
    # Loader frames match direct synthesis.
    np.testing.assert_array_equal(seen[3], native.synth_frame(64, 3, seed=5))


def test_now_ms_monotone():
    t0 = native.now_ms()
    t1 = native.now_ms()
    assert t1 >= t0
