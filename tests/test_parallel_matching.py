"""Ring-sharded pairwise matching == single-device all-pairs matching.

The distributed keyframe matcher (parallel/matching.py) must reproduce
models/matching.match_descriptors pair-by-pair on the 8-device CPU mesh
— the variant-equivalence discipline of SURVEY.md section 4 applied to
the last section-5 promise (ring-style matching schedule; reference
analogue: the scale-owner rank decomposition of mpitest.cpp:42-93).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models.matching import (
    match_descriptors,
)
from sift_parallel_optimization.parallel.matching import (
    ring_pairwise_match_counts,
    select_covisible_pairs,
)
from sift_parallel_optimization.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=8, n_spatial=1)


def _fake_keyframes(rng, F, K, n_shared=20):
    """Descriptor sets where adjacent frames share rotating landmarks:
    nearby frames match strongly, distant ones barely."""
    bank = rng.normal(size=(F + n_shared, 128)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    desc = np.zeros((F, K, 128), np.float32)
    valid = np.zeros((F, K), bool)
    for f in range(F):
        shared = bank[f : f + n_shared]
        own = rng.normal(size=(K - n_shared, 128)).astype(np.float32)
        own /= np.linalg.norm(own, axis=-1, keepdims=True)
        d = np.concatenate([shared, own])
        # Tiny per-frame noise so matches are near- but not exact-dup.
        d = d + 0.01 * rng.normal(size=d.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        desc[f] = d
        valid[f, : K - 3] = True  # a few invalid slots per frame
    return jnp.asarray(desc), jnp.asarray(valid)


def _reference_table(desc, valid):
    F = desc.shape[0]
    out = np.zeros((F, F), np.int32)
    for i in range(F):
        for j in range(F):
            out[i, j] = int(
                match_descriptors(
                    desc[i], desc[j], valid[i], valid[j]
                ).count()
            )
    return out


@pytest.mark.parametrize("F", [16, 13])  # multiple of 8 and padded
def test_ring_table_matches_single_device(mesh, rng, F):
    desc, valid = _fake_keyframes(rng, F, K=40)
    want = _reference_table(desc, valid)
    got = np.asarray(ring_pairwise_match_counts(mesh, desc, valid))
    np.testing.assert_array_equal(got, want)
    # Sanity on the scenario itself: adjacent frames share landmarks.
    assert (np.diag(want, 1) > 5).all()


def test_ring_table_jits(mesh, rng):
    desc, valid = _fake_keyframes(rng, 8, K=24)
    fn = jax.jit(
        lambda d, v: ring_pairwise_match_counts(mesh, d, v)
    )
    got = np.asarray(fn(desc, valid))
    np.testing.assert_array_equal(got, _reference_table(desc, valid))


def test_select_covisible_pairs(mesh, rng):
    desc, valid = _fake_keyframes(rng, 12, K=40)
    table = ring_pairwise_match_counts(mesh, desc, valid)
    pairs = np.asarray(select_covisible_pairs(table, min_count=5,
                                              min_gap=2))
    ii, jj = np.nonzero(pairs)
    assert len(ii) > 0
    assert (jj - ii >= 2).all()            # gap respected
    tbl = np.asarray(table)
    assert (tbl[ii, jj] >= 5).all()        # threshold respected


def test_ring_ici_bytes_model():
    from sift_parallel_optimization.bench.roofline import (
        ring_matching_comm_bytes,
    )

    b = ring_matching_comm_bytes(64, 512, 8)
    # 8 frames/device * 512 kp * (512 + 1) bytes * 8 steps ~ 16.8 MB.
    assert 10e6 < b < 30e6


def test_pairwise_match_counts_single_device(rng=None):
    """The unsharded production table == the per-pair reference loop."""
    rng = np.random.default_rng(5)
    desc, valid = _fake_keyframes(rng, F=6, K=40)
    table = jax.jit(
        __import__(
            "sift_parallel_optimization.parallel.matching",
            fromlist=["pairwise_match_counts"],
        ).pairwise_match_counts
    )(desc, valid)
    np.testing.assert_array_equal(
        np.asarray(table), _reference_table(desc, valid)
    )


def test_covisibility_order_spanning_tree():
    """Greedy MST plan: every frame's partner is registered before it,
    the strongest pair bootstraps, and partners are covisible."""
    from sift_parallel_optimization.parallel.matching import (
        covisibility_order,
    )

    # Chain covisibility 0-1-2-3-4 shuffled into table indices: frame i
    # overlaps only i +- 1 (counts 10), distant pairs 0.
    F = 5
    t = np.zeros((F, F), np.int32)
    for i in range(F - 1):
        t[i, i + 1] = t[i + 1, i] = 10 + i  # strongest at the 3-4 end
    order, partner = covisibility_order(t)
    assert sorted(order) == list(range(F))
    assert set(order[:2]) == {3, 4}  # strongest pair bootstraps
    seen = set(order[:2])
    for f in order[2:]:
        p = partner[f]
        assert p in seen, (order, partner)
        assert abs(p - f) == 1  # only true neighbors are covisible
        seen.add(f)
