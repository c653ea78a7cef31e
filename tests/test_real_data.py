"""Real-dataset I/O + accuracy gate (BASELINE.json "Sequence ATE
(TUM/KITTI-style)" target).

The reference has no image or dataset I/O at all (SURVEY.md section 4: its
input is a synthetic constant array). This suite gates the full
real-data path of the engine: PNG/PPM decode through the native
layer (native/sift_host.cpp), a TUM-format trajectory loader/writer with
timestamp association (utils/trajectory.py), and the `cli sfm --image-dir
--groundtruth` pipeline reporting ATE on an on-disk sequence.

No public dataset ships in this environment (zero egress), so the on-disk
sequence is synthesized REPRODUCIBLY by the native 3-D renderer and
written through the same PNG encoder a real dataset would arrive in —
the decode -> frontend -> SfM -> TUM-ATE path is identical from the
files onward.
"""

import numpy as np
import pytest

from sift_parallel_optimization.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


class TestImageIO:
    def test_png_roundtrip(self, tmp_path, rng):
        img = rng.random((48, 64)).astype(np.float32)
        p = tmp_path / "x.png"
        native.write_png(p, img)
        back = native.read_png(p)
        assert back.shape == (48, 64)
        assert np.max(np.abs(back - img)) < 1.0 / 255.0 + 1e-6

    def test_imread_dispatch(self, tmp_path, rng):
        img = rng.random((32, 32)).astype(np.float32)
        native.write_png(tmp_path / "a.png", img)
        native.write_pgm(tmp_path / "a.pgm", img)
        a = native.imread(tmp_path / "a.png")
        b = native.imread(tmp_path / "a.pgm")
        assert np.max(np.abs(a - b)) < 2.0 / 255.0
        with pytest.raises(IOError):
            native.imread(tmp_path / "a.jpg")

    def test_ppm_binary_luma(self, tmp_path):
        # A hand-built 2x1 P6: red and white pixels.
        p = tmp_path / "c.ppm"
        p.write_bytes(b"P6\n2 1\n255\n" + bytes([255, 0, 0, 255, 255, 255]))
        img = native.read_ppm(p)
        assert img.shape == (1, 2)
        assert abs(img[0, 0] - 0.299) < 1e-3   # Rec.601 red weight
        assert abs(img[0, 1] - 1.0) < 1e-6

    def test_png_16bit_and_rgb(self, tmp_path, rng):
        # External-style PNGs (RGB) decode to luma via libpng.
        try:
            from PIL import Image  # noqa: F401
            have_pil = True
        except ImportError:
            have_pil = False
        if not have_pil:
            pytest.skip("PIL unavailable for writing an RGB png")
        arr = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        p = tmp_path / "rgb.png"
        Image.fromarray(arr, "RGB").save(p)
        img = native.read_png(p)
        assert img.shape == (16, 16)
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


class TestTumFormat:
    def test_save_load_roundtrip(self, tmp_path, rng):
        from sift_parallel_optimization.utils.trajectory import (
            camera_centers,
            load_tum,
            save_tum,
        )
        import jax.numpy as jnp

        n = 7
        rvecs = (0.2 * rng.normal(size=(n, 3))).astype(np.float32)
        tvecs = rng.normal(size=(n, 3)).astype(np.float32)
        ts = 1000.0 + np.arange(n) * 0.1
        p = tmp_path / "traj.txt"
        save_tum(p, ts, rvecs, tvecs)
        ts2, centers, quats = load_tum(p)
        np.testing.assert_allclose(ts2, ts, atol=1e-5)
        expect = np.asarray(
            camera_centers(jnp.asarray(rvecs), jnp.asarray(tvecs))
        )
        np.testing.assert_allclose(centers, expect, atol=1e-4)
        # Quaternions are unit and reproduce the rotations.
        from sift_parallel_optimization.utils.trajectory import (
            quat_to_rotmat,
        )
        from sift_parallel_optimization.models.geometry import rodrigues

        r_wc = np.asarray(quat_to_rotmat(quats))
        r_expected = np.swapaxes(np.asarray(rodrigues(jnp.asarray(rvecs))),
                                 1, 2)
        np.testing.assert_allclose(r_wc, r_expected, atol=1e-4)

    def test_associate_protocol(self):
        from sift_parallel_optimization.utils.trajectory import associate

        ts_a = [0.0, 1.0, 2.0, 3.0]
        ts_b = [0.005, 1.5, 2.996, 3.004]
        ia, ib = associate(ts_a, ts_b, max_dt=0.02)
        assert list(ia) == [0, 3]
        assert list(ib) == [0, 3]

    def test_load_rejects_garbage(self, tmp_path):
        from sift_parallel_optimization.utils.trajectory import load_tum

        p = tmp_path / "bad.txt"
        p.write_text("# header only\n1.0 2.0 3.0\n")
        with pytest.raises(IOError):
            load_tum(p)


@pytest.mark.slow
def test_sequence_dir_ate_gate(tmp_path, capsys):
    """cli sfm --image-dir <PNG sequence> --groundtruth <TUM file>: the
    full real-data path must recover the trajectory within 3% of span."""
    from sift_parallel_optimization.cli import main
    from sift_parallel_optimization.utils.trajectory import save_tum

    size, n = 256, 8
    focal = float(size)
    rvecs = np.stack(
        [[0.0, 0.025 * i, 0.0] for i in range(n)]
    ).astype(np.float32)
    tvecs = np.stack(
        [[-0.3 * i, 0.0, 0.03 * i] for i in range(n)]
    ).astype(np.float32)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i in range(n):
        img = native.render_frame(size, rvecs[i], tvecs[i], focal, seed=11)
        native.write_png(seq / f"{1000.0 + 0.1 * i:.4f}.png", img)
    save_tum(tmp_path / "gt.txt", 1000.0 + 0.1 * np.arange(n), rvecs, tvecs)

    rc = main([
        "sfm", "--image-dir", str(seq),
        "--groundtruth", str(tmp_path / "gt.txt"),
        "--focal", str(focal),
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    ate_line = [l for l in out.splitlines() if l.startswith("ATE vs")]
    assert ate_line, out
    pct = float(ate_line[0].split("(")[1].split("%")[0])
    assert pct < 3.0, out


class TestKittiFormat:
    def test_save_load_roundtrip(self, tmp_path, rng):
        import jax.numpy as jnp

        from sift_parallel_optimization.models.geometry import rodrigues
        from sift_parallel_optimization.utils.trajectory import (
            camera_centers,
            load_kitti,
            save_kitti,
        )

        n = 6
        rvecs = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
        tvecs = rng.normal(size=(n, 3)).astype(np.float32)
        p = tmp_path / "poses.txt"
        save_kitti(p, rvecs, tvecs)
        centers, rots = load_kitti(p)
        expect = np.asarray(
            camera_centers(jnp.asarray(rvecs), jnp.asarray(tvecs))
        )
        np.testing.assert_allclose(centers, expect, atol=1e-5)
        r_expected = np.swapaxes(
            np.asarray(rodrigues(jnp.asarray(rvecs))), 1, 2
        )
        np.testing.assert_allclose(rots, r_expected, atol=1e-5)

    def test_load_rejects_garbage(self, tmp_path):
        from sift_parallel_optimization.utils.trajectory import (
            load_kitti,
        )

        p = tmp_path / "bad.txt"
        p.write_text("1 2 3 4 5\n")
        with pytest.raises(IOError):
            load_kitti(p)


@pytest.mark.slow
def test_cli_save_traj_and_kitti_gate(tmp_path, capsys):
    """cli sfm --save-traj round-trips through BOTH formats, and a
    KITTI-format ground truth gates ATE (frame-indexed association)."""
    from sift_parallel_optimization.cli import main
    from sift_parallel_optimization.utils.trajectory import (
        load_kitti,
        load_tum,
    )

    kitti_path = tmp_path / "est_kitti.txt"
    rc = main([
        "sfm", "--frames", "5", "--size", "192",
        "--save-traj", str(kitti_path), "--traj-format", "kitti",
    ])
    assert rc == 0
    centers, rots = load_kitti(kitti_path)
    assert centers.shape == (5, 3)

    tum_path = tmp_path / "est_tum.txt"
    rc = main([
        "sfm", "--frames", "5", "--size", "192",
        "--save-traj", str(tum_path), "--traj-format", "tum",
    ])
    assert rc == 0
    ts, centers2, _ = load_tum(tum_path)
    np.testing.assert_allclose(centers2, centers, atol=1e-4)

    # The saved estimate IS a perfect KITTI ground truth for itself:
    # re-running with it as --gt-format kitti must report ~0 ATE.
    # (Rendered run is deterministic for fixed seed/size.)
    rc = main([
        "sfm", "--frames", "5", "--size", "192",
        "--groundtruth", str(kitti_path), "--gt-format", "kitti",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ATE vs" in out
    # Self-comparison: the reported ATE must be ~0 (deterministic rerun).
    import re

    m = re.search(r"ATE vs \S+ over \d+ poses: ([0-9.]+)", out)
    assert m and float(m.group(1)) < 1e-3, out
