"""Ring-sharded pairwise keyframe matching (distributed place recognition).

The last SURVEY section-5 promise: "shard keyframe sets across hosts for
matching/BA (ring-style pairwise matching schedule ~ ring attention over
keyframes)". Global SfM pair selection and loop-candidate proposal need
the (F, F) table of pairwise match counts over F keyframes — an
all-pairs descriptor-matching sweep whose cost grows as F^2 * K^2 * 128
matmul flops and whose descriptor set (F * K * 128 floats) outgrows one
device's HBM long before the compute does.

Decomposition (the analogue of the reference's scale-owner
rank split, /root/reference/mpitest.cpp:42-93, applied to keyframes):

* Each of D devices owns a stationary block of F/D keyframes'
  descriptors — the ROWS of its output stripe.
* A traveling copy of each block walks the ring via `ppermute`
  (D - 1 neighbor hops, bandwidth-optimal like ring all-gather: every
  link carries the same bytes every step, no all-to-all hotspot).
* At step r, device d scores its stationary block against the block
  that started at device (d - r) mod D and writes the (F/D, F/D) tile
  of match counts into column block (d - r) mod D of its stripe.
* The per-pair score is EXACTLY models/matching.match_descriptors
  (ratio + mutual-NN count) vmapped over the tile — the distributed
  table is bitwise the single-device table, just sharded.

Interconnect budget: each device sends its traveling block D-1 times:
(D - 1) * (F/D) * K * (128 * 4 + 1) bytes per sweep
(bench/roofline.ring_matching_comm_bytes); compute per step is
(F/D)^2 * K^2 * 128 MACs — the compute/communication ratio grows with
K, so the
schedule is compute-bound for any realistic descriptor count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sift_parallel_optimization.models.matching import (
    match_descriptors,
)


def _pair_tile_counts(
    desc_a: jax.Array,   # (fa, K, 128) stationary block
    valid_a: jax.Array,  # (fa, K)
    desc_b: jax.Array,   # (fb, K, 128) traveling block
    valid_b: jax.Array,  # (fb, K)
    ratio: float,
) -> jax.Array:
    """(fa, fb) match counts via the single-device matcher, vmapped."""

    def one_vs_one(da, va, db, vb):
        return match_descriptors(da, db, va, vb, ratio=ratio).count()

    def one_vs_all(da, va):
        return jax.vmap(lambda db, vb: one_vs_one(da, va, db, vb))(
            desc_b, valid_b
        )

    return jax.vmap(one_vs_all)(desc_a, valid_a)


def _ring_stripe(
    desc_loc: jax.Array,   # (f_loc, K, 128) this device's block
    valid_loc: jax.Array,  # (f_loc, K)
    axis: str,
    n_dev: int,
    ratio: float,
) -> jax.Array:
    """Inside shard_map: (f_loc, n_dev * f_loc) stripe of the table."""
    d = lax.axis_index(axis)
    f_loc = desc_loc.shape[0]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    # + 0*d marks the accumulator as device-varying up front; the loop
    # body writes device-dependent tiles into it, and scan carries must
    # keep one varying-axes type across iterations.
    out = jnp.zeros((f_loc, n_dev * f_loc), jnp.int32) + 0 * d

    def body(r, carry):
        trav_d, trav_v, out = carry
        # The traveling block now on this device started at (d - r).
        src = (d - r) % n_dev
        tile = _pair_tile_counts(
            desc_loc, valid_loc, trav_d, trav_v, ratio
        )
        out = lax.dynamic_update_slice(out, tile, (0, src * f_loc))
        # Pass the block to the next device (skip after the last tile).
        trav_d = lax.ppermute(trav_d, axis, perm)
        trav_v = lax.ppermute(trav_v, axis, perm)
        return trav_d, trav_v, out

    _, _, out = lax.fori_loop(
        0, n_dev, body, (desc_loc, valid_loc, out)
    )
    return out


def ring_pairwise_match_counts(
    mesh: Mesh,
    descriptors: jax.Array,  # (F, K, 128)
    valid: jax.Array,        # (F, K)
    axis: str = "data",
    ratio: float = 0.8,
) -> jax.Array:
    """(F, F) pairwise match-count table, keyframes sharded over ``axis``.

    F is padded up to a multiple of the axis size with invalid frames
    (zero counts); entry (i, j) counts ratio+mutual matches of frame i's
    descriptors against frame j's — identical to looping
    ``match_descriptors(...).count()`` over all ordered pairs on one
    device. The diagonal is the self-match count (useful as a
    normalizer: score_ij / sqrt(score_ii * score_jj) is the standard
    pair-selection similarity).
    """
    F, K, Dd = descriptors.shape
    n_dev = mesh.shape[axis]
    f_pad = -(-F // n_dev) * n_dev
    if f_pad != F:
        descriptors = jnp.pad(
            descriptors, ((0, f_pad - F), (0, 0), (0, 0))
        )
        valid = jnp.pad(valid, ((0, f_pad - F), (0, 0)))

    fn = shard_map(
        functools.partial(
            _ring_stripe, axis=axis, n_dev=n_dev, ratio=ratio
        ),
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
    )
    spec = NamedSharding(mesh, P(axis))
    table = fn(
        jax.device_put(descriptors, spec), jax.device_put(valid, spec)
    )
    return table[:F, :F]


def pairwise_match_counts(
    descriptors: jax.Array,  # (F, K, 128)
    valid: jax.Array,        # (F, K)
    ratio: float = 0.8,
) -> jax.Array:
    """(F, F) pairwise match-count table on ONE device.

    The unsharded counterpart of :func:`ring_pairwise_match_counts`
    (same `_pair_tile_counts` kernel with the full set as both blocks)
    — the production pair-selection path when the keyframe set fits one
    device; the ring variant shards the identical computation.
    """
    return _pair_tile_counts(
        descriptors, valid, descriptors, valid, ratio
    )


def covisibility_order(table) -> tuple[list[int], dict[int, int]]:
    """Greedy covisibility-first registration plan from a match table.

    Prim-style maximum-spanning-tree over the symmetrized pair counts:
    start at the strongest pair, then repeatedly admit the unregistered
    frame with the highest count against ANY registered frame, recording
    that frame as its triangulation PARTNER. Strictly-sequential
    incremental SfM registers frame i against i-1 and fails outright
    when temporal neighbors do not overlap (shuffled captures, unordered
    photo sets); this plan registers every frame against its most
    covisible predecessor instead (tested:
    tests/test_parallel_matching.py round-5 shuffled-sequence gate).

    Host-side O(F^2) numpy on the fetched table (F x F ints — the table
    itself was computed on device, sharded or not). Returns
    (order, partner): ``order[0]``/``order[1]`` are the bootstrap pair;
    ``partner[f]`` is the registration partner of every later frame.
    """
    import numpy as np

    t = np.asarray(table)
    sym = t + t.T
    np.fill_diagonal(sym, -1)
    F = sym.shape[0]
    a, b = np.unravel_index(np.argmax(sym), sym.shape)
    order = [int(a), int(b)]
    partner = {int(b): int(a)}
    best = np.maximum(sym[a], sym[b])
    best_from = np.where(sym[b] > sym[a], b, a).astype(np.int64)
    best[[a, b]] = -1
    for _ in range(F - 2):
        u = int(np.argmax(best))
        order.append(u)
        partner[u] = int(best_from[u])
        upd = sym[u] > best
        best_from = np.where(upd, u, best_from)
        best = np.maximum(best, sym[u])
        best[u] = -1
        best[order] = -1
    return order, partner


def select_covisible_pairs(
    table: jax.Array, min_count: int, min_gap: int = 1
) -> jax.Array:
    """(F, F) bool mask of proposed pairs from the match-count table.

    Upper-triangle pairs at least ``min_gap`` apart with at least
    ``min_count`` matches — the global-SfM pair shortlist / loop
    -candidate proposal set. Pure elementwise; callers threshold the
    sharded table without gathering it.
    """
    F = table.shape[0]
    i = jnp.arange(F)
    apart = (i[None, :] - i[:, None]) >= min_gap
    return apart & (table >= min_count)
