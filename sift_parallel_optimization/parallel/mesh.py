"""Device-mesh construction for the framework.

Replaces the reference's process-level machinery — `MPI_Init` inside the
compute routine, rank-id dispatch, one collector rank
(GaussDePyramid-MPI.h:265-335, mpitest.cpp:35-113) — with one explicit
`jax.sharding.Mesh`. Axis meanings:

  * ``data``    — batch of frames (the reference had none; DP axis).
  * ``spatial`` — image rows within a frame (the reference's OpenMP row split
    and the sequence-parallel analogue for stencils; SP axis).

Scale parallelism (the reference's MPI rank-per-scale and pthread
scale-split, GaussDePyramid-pThread.h:256-308) is deliberately NOT a mesh
axis: the S+3 scales of an octave are computed together from one base
(core/pyramid_ref.blur_bank) — splitting them across devices would turn
a free fusion into interconnect traffic. The capability (computing scales in
parallel) is preserved; the mechanism is better.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bootstrap: `jax.distributed.initialize` with defaults.

    Replaces the reference's `MPI_Init` — which it called INSIDE the
    compute routine, making re-runs silently broken
    (GaussDePyramid-MPI.h:268, re-invoked by main.cpp:66-73; SURVEY.md
    section 2 flags the latent re-init bug). Call once at process start;
    afterwards `jax.devices()` spans every host and `make_mesh` lays the
    global mesh over all of them. Safe to call on a single host (no-op
    without cluster env).
    """
    import jax

    if num_processes is None and coordinator_address is None:
        # Cluster auto-detection (scheduler env vars) or single-process.
        try:
            jax.distributed.initialize()
        except Exception as e:  # noqa: BLE001 — must not abort single-host
            import sys

            print(
                "initialize_distributed: cluster auto-detection failed "
                f"({type(e).__name__}: {e}); continuing single-process. "
                "If this IS a multi-host run, pass coordinator_address/"
                "num_processes/process_id explicitly — computing on a "
                "partial mesh would silently produce wrong results.",
                file=sys.stderr,
            )
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    n_data: int | None = None,
    n_spatial: int | None = None,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a (data, spatial) mesh over the available devices.

    Defaults: all devices on the spatial axis if ``n_data`` is None.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_data is None and n_spatial is None:
        n_data, n_spatial = 1, n
    elif n_data is None:
        n_data = n // n_spatial
    elif n_spatial is None:
        n_spatial = n // n_data
    if n_data * n_spatial != n:
        raise ValueError(
            f"mesh {n_data}x{n_spatial} does not cover {n} devices"
        )
    arr = np.asarray(devices).reshape(n_data, n_spatial)
    return Mesh(arr, ("data", "spatial"))


def spatial_size(mesh: Mesh) -> int:
    return mesh.shape["spatial"]


def data_size(mesh: Mesh) -> int:
    return mesh.shape["data"]


def row_sharding(mesh: Mesh, batched: bool = False) -> NamedSharding:
    """Sharding for an image (H, W) split by rows, or (B, H, W) batched."""
    if batched:
        return NamedSharding(mesh, P("data", "spatial", None))
    return NamedSharding(mesh, P("spatial", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
