"""Roofline cost models: floors must be sane, positive, and composable."""

import numpy as np
import pytest

from sift_parallel_optimization.bench.roofline import (
    PEAKS,
    CostModel,
    dense_score_model,
    descriptor_model,
    frontend_model,
    matching_model,
    peaks_for,
    reference_pyramid_model,
    refit_model,
    sift_pyramid_model,
    stage_models,
)
from sift_parallel_optimization.models.frontend import sift_config

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def test_floor_is_max_of_resources():
    m = CostModel(hbm_bytes=3350e9 * 1e-3)  # exactly 1 ms of HBM traffic
    assert abs(m.floor_ms(H100) - 1.0) < 1e-9
    assert m.bound(H100) == "hbm"
    m2 = CostModel(hbm_bytes=3350e6, matmul_flops=495e12 * 1e-2)
    assert abs(m2.floor_ms(H100) - 10.0) < 1e-6  # compute dominates
    assert m2.bound(H100) == "matmul"
    m3 = CostModel(vector_flops=67e12 * 2e-3)
    assert abs(m3.floor_ms(H100) - 2.0) < 1e-9
    assert m3.bound(H100) == "vector"


def test_sol_pct_inverse_in_measurement():
    m = reference_pyramid_model(512, 2)
    f = m.floor_ms(H100)
    assert m.sol_pct(f, H100) == 100.0
    assert m.sol_pct(2 * f, H100) == 50.0


def test_models_positive_and_monotone_in_size():
    cfg256, cfg512 = sift_config(256), sift_config(512)
    for build in (sift_pyramid_model, dense_score_model):
        small, big = build(cfg256), build(cfg512)
        assert 0 < small.floor_ms(H100) < big.floor_ms(H100)
    assert 0 < refit_model(256).floor_ms(H100) < refit_model(512).floor_ms(H100)
    assert (
        0
        < descriptor_model(cfg512, 256).floor_ms(H100)
        < descriptor_model(cfg512, 512).floor_ms(H100)
    )
    assert 0 < matching_model(512).floor_ms(H100)


def test_frontend_floor_is_stage_sum():
    cfg = sift_config(512)
    stages = stage_models(cfg, 512)
    total = frontend_model(cfg, 512)
    parts = sum(
        stages[s].floor_ms(H100)
        for s in ("pyramid", "dense_score", "refit", "descriptors")
    )
    # Floors are max() per stage, so the total floor is <= the sum of
    # stage floors but must be within the same order.
    assert total.floor_ms(H100) <= parts + 1e-9
    assert total.floor_ms(H100) > 0.5 * parts


def test_known_magnitudes():
    """Anchor the models by hand-computed byte counts so a unit slip
    (bytes vs bits, ms vs us) cannot pass silently."""
    # REFERENCE pyramid 512^2 S=2: 24 B/px over the octave pyramid,
    # ~8.4 MB -> ~2.5 us at 3.35 TB/s.
    f = reference_pyramid_model(512, 2).floor_ms(H100)
    assert 0.002 < f < 0.003, f
    cfg = sift_config(512)
    # Descriptor stage at K=512: 512 patches of 96 x 256 f32 (~50 MB)
    # plus the atlas -> ~15-20 us, memory-bound.
    d = descriptor_model(cfg, 512)
    f3 = d.floor_ms(H100)
    assert 0.012 < f3 < 0.03, f3
    assert d.bound(H100) == "hbm"
    assert np.isfinite(f3)
    f2 = frontend_model(cfg, 512).floor_ms(H100)
    assert f3 < f2 < 0.2, f2


def test_peak_table_h100():
    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert (p.hbm_gbps, p.f32_tflops, p.tf32_tflops, p.bf16_tflops) == (
        3350.0, 67.0, 495.0, 989.0,
    )
    assert p.source
    assert set(PEAKS) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""]
)
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks_for(kind)


def test_ici_models():
    from sift_parallel_optimization.bench.roofline import (
        ba_cg_comm_bytes,
        dp_frontend_comm_bytes,
        ring_all_gather_bytes,
        ring_all_reduce_bytes,
        ring_reduce_scatter_bytes,
        sharded_pyramid_comm_bytes,
    )

    cfg = sift_config(512)
    assert dp_frontend_comm_bytes() == 0.0
    assert sharded_pyramid_comm_bytes(cfg, 1) == 0.0
    b8 = sharded_pyramid_comm_bytes(cfg, 8)
    # 8-way at 512^2: base-blur halo (r=5) + octave-0 and octave-1
    # exchanges at r=15 (octave 2 local height 16 < 2r -> unsharded):
    # 2*2*(5*512 + 15*512 + 15*256) * 4B = 215 KB.
    assert b8 == 2 * 2 * (5 * 512 + 15 * 512 + 15 * 256) * 4.0
    # More devices shard fewer octaves but never move more halo bytes
    # per device than 2-way (halo per exchange is mesh-size-invariant).
    assert sharded_pyramid_comm_bytes(cfg, 2) >= b8
    # Ring collectives: (n-1)/n of the array per device per phase.
    assert ring_all_reduce_bytes(100.0, 2) == 100.0
    assert ring_all_reduce_bytes(100.0, 1) == 0.0
    assert ring_reduce_scatter_bytes(100.0, 4) == 75.0
    assert ring_all_gather_bytes(100.0, 4) == 75.0
    # BA CG traffic: exact count at 4 devices, grows with GN iters.
    assert ba_cg_comm_bytes(50, 2000, 1) == 0.0
    c_blk = (50 * 36 + 50 * 6) * 4.0
    p_blk = (2000 * 9 + 2000 * 3) * 4.0
    per_gn = 2 * c_blk * 3 / 4 + p_blk * 3 / 4
    per_mv = 2 * (2000 * 12.0 * 3 / 4) + 2 * (50 * 24.0) * 3 / 4
    assert ba_cg_comm_bytes(50, 2000, 4, gn_iters=10, cg_iters=25) == (
        pytest.approx(10 * (per_gn + 25 * per_mv))
    )
    assert (
        ba_cg_comm_bytes(50, 2000, 8, gn_iters=10, cg_iters=25)
        > ba_cg_comm_bytes(50, 2000, 8, gn_iters=1, cg_iters=25) * 9
    )
