"""Halo exchange for spatially-sharded stencils.

The reference never needed this: its "blur" is an elementwise window, so its
OpenMP row split (GaussDePyramid-OpenMP.h:164-175) and MPI decomposition are
embarrassingly parallel. The TRUE convolution path of this framework (SIFT
mode) does need neighbor rows, and the mechanism here is
`shard_map` + `jax.lax.ppermute` between devices — the stencil analogue of
sequence-parallel halo exchange, replacing MPI_Send/MPI_Recv row streaming
(mpitest.cpp:58-77) with neighbor-only collective permutes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def neighbor_rows(
    x: jax.Array, halo: int, axis_name: str
) -> tuple[jax.Array, jax.Array]:
    """The two ``halo``-row neighbor strips of a row-sharded block,
    WITHOUT concatenating them onto the local rows.

    Returns (from_up, from_down): the rows arriving from the shard above
    (its bottom rows) and below (its top rows), with replicate-edge
    synthesis at the global image border. Exposing the strips separately
    is what enables communication/compute OVERLAP: a consumer can keep
    its bulk compute dependent only on ``x`` and touch the strips late,
    so XLA can schedule the async collective-permute (start/done pair)
    underneath the interior work — the analogue of the reference
    streaming finished rows
    while computing the next (/root/reference/mpitest.cpp:47-64).

    Must be called inside shard_map.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    top_rows = x[..., :halo, :]
    bot_rows = x[..., -halo:, :]

    if n == 1:
        from_up = top_rows
        from_down = bot_rows
    else:
        # Send my bottom rows down (they become the lower neighbor's top halo)
        # and my top rows up.
        down_perm = [(i, (i + 1) % n) for i in range(n)]
        up_perm = [(i, (i - 1) % n) for i in range(n)]
        from_up = lax.ppermute(bot_rows, axis_name, down_perm)  # neighbor above's bottom
        from_down = lax.ppermute(top_rows, axis_name, up_perm)  # neighbor below's top

    # Replicate-edge at the global image border: shard 0's top halo is its own
    # first row repeated; last shard's bottom halo is its own last row.
    edge_top = jnp.repeat(x[..., :1, :], halo, axis=-2)
    edge_bot = jnp.repeat(x[..., -1:, :], halo, axis=-2)
    from_up = jnp.where(idx == 0, edge_top, from_up)
    from_down = jnp.where(idx == n - 1, edge_bot, from_down)
    return from_up, from_down


def exchange_rows(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Pad a row-sharded block (..., H_local, W) with ``halo`` rows from each
    neighbor along mesh axis ``axis_name``.

    Edge shards replicate their border rows (matching the 'edge' padding of
    core.pyramid_ref.separable_blur on a single device, so sharded and
    unsharded results agree bit-for-bit away from float reassociation).

    Must be called inside shard_map. Returns (..., H_local + 2*halo, W).
    NOTE: concatenating makes ALL downstream compute depend on the
    ppermute — use :func:`neighbor_rows` where overlap matters.
    """
    from_up, from_down = neighbor_rows(x, halo, axis_name)
    return jnp.concatenate([from_up, x, from_down], axis=-2)
