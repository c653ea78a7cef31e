"""CLI smoke tests (run on the CPU mesh via conftest)."""

import json

import numpy as np
import pytest

from sift_parallel_optimization.cli import main
from sift_parallel_optimization.utils import native


def test_features_synthetic(capsys):
    assert main(["features", "--size", "64", "--max-keypoints", "64"]) == 0
    out = capsys.readouterr().out
    assert "keypoints (capacity 64)" in out


def test_pyramid_dump(tmp_path, capsys):
    rc = main([
        "pyramid", "--size", "64", "--S", "2",
        "--dump-dir", str(tmp_path / "oct"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "octave 0" in out
    assert (tmp_path / "oct" / "octave0.pgm").exists()


@pytest.mark.skipif(not native.available(), reason="native lib required")
def test_features_from_pgm(tmp_path, capsys, rng):
    img = rng.random((64, 64)).astype(np.float32)
    p = tmp_path / "in.pgm"
    native.write_pgm(p, img)
    assert main(["features", "--image", str(p), "--max-keypoints", "32"]) == 0


def test_sfm_archive_policy_flag_validated():
    # argparse rejects unknown policies before any compute; the valid
    # choices reach run_odometry(archive_policy=...) (wiring tested at
    # the library level in tests/test_odometry.py /
    # tests/test_long_sequence.py).
    with pytest.raises(SystemExit):
        main([
            "sfm", "--window", "4", "--loop-closure",
            "--archive-policy", "bogus",
        ])


def test_bench_matching_writes_jsonl(tmp_path):
    out = tmp_path / "m.jsonl"
    rc = main([
        "bench", "--workloads", "matching", "--out", str(out),
    ])
    assert rc == 0
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert any(r["metric"].startswith("match_ms") for r in lines)


def test_cli_pair_selection_flag(tmp_path):
    """--pair-selection covisibility runs the table-driven SfM driver
    end-to-end through the CLI (rendered frames, tiny)."""
    from sift_parallel_optimization.utils import native

    if not native.available():
        pytest.skip("native renderer unavailable")
    rc = main([
        "sfm", "--frames", "5", "--size", "128",
        "--pair-selection", "covisibility",
    ])
    assert rc == 0


def test_cli_stream_online_odometry():
    """stream --window runs the online OdometryStream end-to-end on the
    native loader (tiny frames, CPU)."""
    if not native.available():
        pytest.skip("native renderer unavailable")
    rc = main([
        "stream", "--frames", "10", "--size", "128",
        "--max-keypoints", "128", "--window", "4",
    ])
    assert rc == 0
