"""Distributed bundle adjustment over a device mesh.

The north-star distributed back end (BASELINE.json: "distributed BA via
Schur-complement reduction over ICI collectives"). Where the reference's
distribution story was MPI point-to-point rows streamed to one collector
rank that did all the reduction work (GaussDePyramid-MPI.h:265-335,
mpitest.cpp:35-113 — the Amdahl bottleneck SURVEY.md section 2 flags), BA
here distributes the DOMINANT cost (per-observation linearization + block
assembly) and reduces with one collective:

  * the observation list is sharded over the ``data`` mesh axis
    (measurement-graph data parallelism);
  * every device assembles NormalBlocks from its shard — `segment_sum`
    and scatter-adds are shard-local;
  * ONE `psum` over the NormalBlocks pytree produces the global normal
    equations on every device (sums over observations commute with
    assembly);
  * the reduced (6C, 6C) camera solve + landmark back-substitution run
    replicated — they are O(C^3 + P) which is negligible next to the
    O(M) assembly for real scenes, and replication keeps every device
    holding the full updated state for the next linearization without a
    gather.

Equivalence with the single-device path is exact up to float reduction
order (tested in tests/test_parallel_ba.py).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sift_parallel_optimization.models.ba import (
    BAState,
    Observations,
    _damp_blocks,
    _linearize,
    apply_deltas,
    assemble_normal_blocks,
    solve_schur,
)


def pad_observations(obs: Observations, multiple: int) -> Observations:
    """Pad the observation list so it divides the mesh axis (masked slots)."""
    m = obs.cam_idx.shape[0]
    target = ((m + multiple - 1) // multiple) * multiple
    pad = target - m
    if pad == 0:
        return obs
    return Observations(
        cam_idx=jnp.pad(obs.cam_idx, (0, pad)),
        pt_idx=jnp.pad(obs.pt_idx, (0, pad)),
        uv=jnp.pad(obs.uv, ((0, pad), (0, 0))),
        valid=jnp.pad(obs.valid, (0, pad)),
    )


def distributed_ba_step(
    mesh: Mesh,
    K: jax.Array,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    axis: str = "data",
):
    """Returns fn(state, obs) -> state: one sharded Gauss-Newton step.

    ``obs`` arrays must divide mesh.shape[axis] (use pad_observations).
    State is replicated; observations are sharded on ``axis``.
    """

    def step(state: BAState, obs: Observations) -> BAState:
        def local(st, ob):
            blocks = assemble_normal_blocks(
                st, ob, K,
                huber_delta=huber_delta, fix_first_cam=fix_first_cam,
            )
            # The one collective: global normal equations on every device.
            blocks = jax.tree.map(lambda x: lax.psum(x, axis), blocks)
            dc, dp = solve_schur(
                blocks, damping=damping, fix_first_cam=fix_first_cam
            )
            return apply_deltas(st, dc, dp)

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(
                jax.tree.map(lambda _: P(), state),
                jax.tree.map(lambda _: P(axis), obs),
            ),
            out_specs=jax.tree.map(lambda _: P(), state),
            check_vma=False,
        )(state, obs)

    return step


def distributed_ba_step_cg(
    mesh: Mesh,
    K: jax.Array,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    axis: str = "data",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
):
    """Implicit-Schur CG Gauss-Newton step, sharded over observations.

    The scalable distributed refinement (BASELINE.json north star): NO
    dense (C, P, 6, 3) W is ever formed or psummed. Per GN step:

      * per-obs Jacobians are shard-local (zero communication);
      * camera blocks Hcc/bc: ONE psum of (C, 6, 6)+(C, 6) — kilobytes;
      * landmark blocks Hpp/bp: `psum_scatter` leaves each device owning
        a (P/n, 3, 3) shard — the 3x3 inverses are computed and applied
        where the shard lives (reduce_scatter of landmark blocks);
      * each CG matvec does one psum_scatter (P, 3) -> shard, applies the
        local Hpp^-1, `all_gather`s the (P, 3) landmark intermediate back,
        and psums the (C, 6) camera vector — ~P*3 + C*6 floats of ICI
        traffic per matvec vs the old dense-W psum of C*P*18 floats per
        step.

    Landmark updates come back through the same all_gather. The CG
    recurrence runs replicated (identical on every device — collectives
    keep it bitwise in lockstep, so the adaptive ``cg_tol`` early exit
    below takes the same trip count everywhere and the collectives stay
    aligned).
    """

    def step(state: BAState, obs: Observations) -> BAState:
        n_dev = mesh.shape[axis]

        def local(st, ob):
            with jax.default_matmul_precision("highest"):
                return _local_cg_step(st, ob)

        def _local_cg_step(st, ob):
            C = st.rvecs.shape[0]
            P = st.points.shape[0]
            # Pad the point axis so psum_scatter shards evenly; pad blocks
            # are damped-identity and their updates are sliced off.
            p_pad = (P + n_dev - 1) // n_dev * n_dev
            jc, jp, r = _linearize(st, ob, K, huber_delta, fix_first_cam)

            hcc = lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("mik,mil->mkl", jc, jc), ob.cam_idx, C
                ),
                axis,
            )
            bc = -lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("mik,mi->mk", jc, r), ob.cam_idx, C
                ),
                axis,
            )
            hpp_part = jax.ops.segment_sum(
                jnp.einsum("mik,mil->mkl", jp, jp), ob.pt_idx, p_pad
            )
            bp_part = -jax.ops.segment_sum(
                jnp.einsum("mik,mi->mk", jp, r), ob.pt_idx, p_pad
            )
            hpp_shard = lax.psum_scatter(
                hpp_part, axis, scatter_dimension=0, tiled=True
            )                                          # (p_pad/n, 3, 3)
            bp_shard = lax.psum_scatter(
                bp_part, axis, scatter_dimension=0, tiled=True
            )
            hcc = _damp_blocks(hcc, damping)
            if fix_first_cam:
                hcc = hcc.at[0].set(jnp.eye(6))
            from sift_parallel_optimization.models.ba import _inv3x3

            hpp_inv_shard = _inv3x3(_damp_blocks(hpp_shard, damping))

            def wt_shard(x):
                """W^T x -> owner's (p_pad/n, 3) landmark shard."""
                t = jnp.einsum("mik,mk->mi", jc, x[ob.cam_idx])
                u = jnp.einsum("mil,mi->ml", jp, t)
                v = jax.ops.segment_sum(u, ob.pt_idx, p_pad)
                return lax.psum_scatter(
                    v, axis, scatter_dimension=0, tiled=True
                )

            def w_apply(y_full):
                """W y -> replicated (C, 6) camera vector."""
                t = jnp.einsum("mil,ml->mi", jp, y_full[ob.pt_idx])
                u = jnp.einsum("mik,mi->mk", jc, t)
                return lax.psum(
                    jax.ops.segment_sum(u, ob.cam_idx, C), axis
                )

            def hpp_solve_gather(v_shard):
                """Apply the owned Hpp^-1 shard, all_gather to (p_pad, 3)."""
                y_shard = jnp.einsum("pkl,pl->pk", hpp_inv_shard, v_shard)
                return lax.all_gather(y_shard, axis, axis=0, tiled=True)

            b = bc - w_apply(hpp_solve_gather(bp_shard))
            minv = jnp.linalg.inv(hcc)

            def prec(v):
                return jnp.einsum("ckl,cl->ck", minv, v)

            def matvec(x):
                y = hpp_solve_gather(wt_shard(x))
                return jnp.einsum("ckl,cl->ck", hcc, x) - w_apply(y)

            x = jnp.zeros_like(b)
            rr = b
            z = prec(rr)
            p = z
            rz = jnp.sum(rr * z)
            thresh = cg_tol * rz

            def cond(carry):
                i, _x, _rr, _p, rz = carry
                return (i < cg_iters) & (rz > thresh)

            def body(carry):
                i, x, rr, p, rz = carry
                ap = matvec(p)
                pap = jnp.sum(p * ap)
                alpha = jnp.where(
                    pap > 1e-20, rz / jnp.maximum(pap, 1e-20), 0.0
                )
                x = x + alpha * p
                rr = rr - alpha * ap
                z = prec(rr)
                rz_new = jnp.sum(rr * z)
                beta = jnp.where(
                    rz > 1e-20, rz_new / jnp.maximum(rz, 1e-20), 0.0
                )
                return i + 1, x, rr, z + beta * p, rz_new

            _, x, rr, p, rz = lax.while_loop(
                cond, body, (0, x, rr, p, rz)
            )
            delta_c = x
            dp_shard = jnp.einsum(
                "pkl,pl->pk", hpp_inv_shard, bp_shard - wt_shard(delta_c)
            )
            delta_p = lax.all_gather(
                dp_shard, axis, axis=0, tiled=True
            )[:P]                                       # drop padding
            return apply_deltas(st, delta_c, delta_p)

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(
                jax.tree.map(lambda _: P(), state),
                jax.tree.map(lambda _: P(axis), obs),
            ),
            out_specs=jax.tree.map(lambda _: P(), state),
            check_vma=False,
        )(state, obs)

    return step


def distributed_bundle_adjust(
    state: BAState,
    obs: Observations,
    K: jax.Array,
    mesh: Mesh,
    n_iters: int = 10,
    damping: float = 1e-3,
    huber_delta: float | None = None,
    fix_first_cam: bool = True,
    axis: str = "data",
    solver: str = "dense",
    cg_iters: int = 25,
    cg_tol: float = 1e-8,
) -> BAState:
    """Sharded damped Gauss-Newton BA (jit this whole function).

    ``solver="cg"`` uses the implicit-Schur CG step (no dense W psum —
    see distributed_ba_step_cg); "dense" keeps the exact reduced solve.
    """
    n_dev = mesh.shape[axis]
    obs = pad_observations(obs, n_dev)
    if solver == "cg":
        step = distributed_ba_step_cg(
            mesh, K,
            damping=damping, huber_delta=huber_delta,
            fix_first_cam=fix_first_cam, axis=axis, cg_iters=cg_iters,
            cg_tol=cg_tol,
        )
    else:
        step = distributed_ba_step(
            mesh, K,
            damping=damping, huber_delta=huber_delta,
            fix_first_cam=fix_first_cam, axis=axis,
        )

    def body(_, st):
        return step(st, obs)

    return lax.fori_loop(0, n_iters, body, state)
