"""Distributed pose-graph optimization: edges sharded over the mesh.

Same one-collective pattern as parallel/ba.py: every device assembles
normal-equation blocks from its edge shard, a single psum over the block
pytree yields the global system, and the (6N, 6N) solve runs replicated
(N = keyframe count is small next to the edge count on real graphs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sift_parallel_optimization.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    assemble_pgo_blocks,
    solve_pgo,
)


def pad_edges(edges: PoseGraphEdges, multiple: int) -> PoseGraphEdges:
    """Pad the edge list to a multiple (padded edges get zero weight)."""
    e = edges.i.shape[0]
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return edges
    return PoseGraphEdges(
        i=jnp.pad(edges.i, (0, pad)),
        j=jnp.pad(edges.j, (0, pad)),
        rel_rvec=jnp.pad(edges.rel_rvec, ((0, pad), (0, 0))),
        rel_tvec=jnp.pad(edges.rel_tvec, ((0, pad), (0, 0))),
        weight=jnp.pad(edges.weight, (0, pad)),  # zeros: inert
    )


def distributed_pgo(
    poses: Poses,
    edges: PoseGraphEdges,
    mesh: Mesh,
    n_iters: int = 20,
    damping: float = 1e-3,
    axis: str = "data",
) -> Poses:
    """Edge-sharded damped Gauss-Newton PGO (jit this whole function)."""
    edges = pad_edges(edges, mesh.shape[axis])

    def step(p: Poses, e: PoseGraphEdges) -> Poses:
        def local(pp, ee):
            blocks = assemble_pgo_blocks(pp, ee)
            blocks = jax.tree.map(lambda x: lax.psum(x, axis), blocks)
            delta = solve_pgo(*blocks, damping=damping)
            return Poses(
                rvecs=pp.rvecs + delta[:, :3],
                tvecs=pp.tvecs + delta[:, 3:],
            )

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(
                jax.tree.map(lambda _: P(), p),
                jax.tree.map(lambda _: P(axis), e),
            ),
            out_specs=jax.tree.map(lambda _: P(), p),
            check_vma=False,
        )(p, e)

    def body(_, p):
        return step(p, edges)

    return lax.fori_loop(0, n_iters, body, poses)
