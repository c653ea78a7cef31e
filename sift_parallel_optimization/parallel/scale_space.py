"""Mesh-sharded scale-space computation (the distributed layer).

Replaces the reference's process-level decompositions — MPI rank-per-scale
with a serial collector rank (GaussDePyramid-MPI.h:265-335, mpitest.cpp:35-113)
and the pthread octave/scale splits (GaussDePyramid-pThread.h:176-342) — with
`shard_map` over an explicit device mesh:

  * rows of a frame are sharded over the ``spatial`` axis (the reference's
    OpenMP row split, now across devices);
  * a batch of frames is sharded over ``data`` (DP — the reference had no
    batch dimension at all);
  * there is NO collector: DoG is computed where the Gaussian planes live
    (owner computes), eliminating the reference's Amdahl bottleneck where
    one rank received every row of every plane and did all subtraction
    (mpitest.cpp:66-93);
  * the true-convolution path exchanges halo rows with neighbor-only
    `ppermute` instead of row-granular MPI_Send/Recv.

Two flavors are provided: explicit `shard_map` functions (this module), and
the GSPMD path where `jax.jit` + sharding constraints auto-partitions the
plain jnp code (used by models/pipeline code; XLA inserts equivalent
collectives).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sift_parallel_optimization.core.pyramid_ref import (
    reference_filter_bank,
    reference_subsample,
    window_dog_planes,
)
from sift_parallel_optimization.parallel.halo import exchange_rows


# ---------------------------------------------------------------------------
# REFERENCE mode: window + DoG, row-sharded (embarrassingly parallel — the
# window is elementwise, so no halo is needed; each shard only needs its own
# row-slice of the filter bank).
# ---------------------------------------------------------------------------


def _local_window_dog(local: jax.Array, n_scales: int, global_size: int) -> jax.Array:
    """Inside shard_map: (h, N) local rows -> (n_scales, h, N) planes."""
    n = lax.axis_size("spatial")
    i = lax.axis_index("spatial")
    h = local.shape[0]
    f = reference_filter_bank(global_size, n_scales, dtype=local.dtype)
    frow = lax.dynamic_slice_in_dim(f, i * h, h, axis=1)  # (n_scales, h)
    # Rectangular variant of window_dog_planes (row/col banks differ).
    windows = frow[:, :, None] * f[:, None, :]  # (n_scales, h, N)
    w_dog = windows[:-1] - windows[1:]
    w_all = jnp.concatenate([w_dog, windows[-1:]], axis=0)
    return local[None] * w_all


def sharded_reference_dog_octave(mesh: Mesh, S: int, size: int):
    """Returns a jittable fn: (size, size) row-sharded -> (S+3, size, size).

    Output is row-sharded on the same axis (planes replicated only in spec
    position, data stays put — zero communication, unlike the reference's
    full-pyramid MPI_Send to the collector)."""
    n_scales = S + 3

    fn = shard_map(
        functools.partial(_local_window_dog, n_scales=n_scales, global_size=size),
        mesh=mesh,
        in_specs=P("spatial", None),
        out_specs=P(None, "spatial", None),
    )
    return fn


def _shardable(size: int, n_shards: int, min_rows: int = 8) -> bool:
    return size % n_shards == 0 and size // n_shards >= min_rows


def sharded_reference_dog_pyramid(
    img: jax.Array, S: int, mesh: Mesh, n_octaves: int | None = None
) -> list[jax.Array]:
    """Full REFERENCE pyramid with large octaves row-sharded over the mesh.

    Octaves too small to shard (the deep tail of the pyramid, a few KB total)
    are computed with plain jnp — under jit+GSPMD they run replicated, which
    is both correct and faster than forcing tiny collectives.
    """
    from sift_parallel_optimization.config import num_octaves
    from sift_parallel_optimization.core.pyramid_ref import reference_dog_octave

    img = img.astype(jnp.float32)
    total = num_octaves(img.shape[0])
    n_octaves = total if n_octaves is None else min(n_octaves, total)
    n_sp = mesh.shape["spatial"]
    out = []
    for o in range(n_octaves):
        base = reference_subsample(img, o)
        size = base.shape[0]
        if _shardable(size, n_sp):
            out.append(sharded_reference_dog_octave(mesh, S, size)(base))
        else:
            out.append(reference_dog_octave(base, S))
    return out


# ---------------------------------------------------------------------------
# REFERENCE mode, scale-parallel decomposition (the reference's
# rank-per-scale MPI layout and pthread scale-split, GaussDePyramid-MPI.h:
# 271-318, GaussDePyramid-pThread.h:256-308). Each device owns a block of
# scale planes; the DoG dependency on scale s+1 — the reference's one real
# cross-worker synchronization (its pthread barrier / its MPI collector) —
# becomes a single neighbor ppermute of one plane. No collector rank: the
# device that owns the data computes its DoG.
# ---------------------------------------------------------------------------


def _local_scale_dog(
    base: jax.Array, f_local: jax.Array, n_scales: int, axis: str
) -> jax.Array:
    """Inside shard_map: base (N, N) replicated; f_local (k, N) this
    device's window rows. Returns (k, N, N) output planes."""
    n = lax.axis_size(axis)
    i = lax.axis_index(axis)
    k = f_local.shape[0]
    windows = f_local[:, :, None] * f_local[:, None, :]   # (k, N, N)
    g = base[None] * windows                              # my Gaussian planes
    # Fetch the NEXT device's first plane (scale i*k + k).
    perm = [(j, (j - 1) % n) for j in range(n)]
    nxt = lax.ppermute(g[:1], axis, perm)                 # (1, N, N)
    g_ext = jnp.concatenate([g, nxt], axis=0)             # (k+1, N, N)
    dog = g_ext[:-1] - g_ext[1:]                          # (k, N, N)
    # Global plane S+2 keeps the windowed image (in-place semantics,
    # GuassDePyramid.h:136-149); padded planes beyond it are dropped later.
    gidx = i * k + jnp.arange(k)
    keep_g = (gidx == n_scales - 1)[:, None, None]
    return jnp.where(keep_g, g, dog)


def scale_sharded_reference_dog_octave(
    mesh: Mesh, S: int, size: int, axis: str = "spatial"
):
    """Returns fn(base) -> (S+3, size, size): scale planes sharded on
    ``axis`` (padded to a multiple of the axis size internally)."""
    n_scales = S + 3
    n_dev = mesh.shape[axis]
    padded = -(-n_scales // n_dev) * n_dev

    fn = shard_map(
        functools.partial(_local_scale_dog, n_scales=n_scales, axis=axis),
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=P(axis, None, None),
    )

    def run(base: jax.Array) -> jax.Array:
        f = reference_filter_bank(size, n_scales, dtype=base.dtype)
        f = jnp.pad(f, ((0, padded - n_scales), (0, 0)))
        return fn(base, f)[:n_scales]

    return run


# ---------------------------------------------------------------------------
# REFERENCE mode, octave-parallel decomposition (the reference's pthread
# round-robin over octaves: thread t owns octaves t, t+T, ... —
# GaussDePyramid-pThread.h:211-254 and all x-pthread hybrids). Octaves are
# fully independent in REFERENCE mode (each is a strided subsample of the
# ORIGINAL image), so device d computes its own octaves end-to-end with no
# communication at all — the ideal-scaling case. SPMD needs one static
# program, so per-device octave sizes are handled by masked repeated
# halving into a padded (N, N) buffer and masked filter banks.
# ---------------------------------------------------------------------------


def _padded_halve(x: jax.Array) -> jax.Array:
    """(N, N) -> (N, N): stride-2 subsample into the top-left, zero pad."""
    n = x.shape[0]
    y = lax.reduce_window(x, 0.0, lax.add, (1, 1), (2, 2), "VALID")
    return jnp.pad(y, ((0, n - n // 2), (0, n - n // 2)))


def _masked_filter_bank(n: int, n_scales: int, length: jax.Array) -> jax.Array:
    """(n_scales, n) reference window bank for a TRACED octave side length.

    Matches reference_filter_bank(length, n_scales) on the first ``length``
    columns, zero beyond (GuassDePyramid.h:117-120 with traced len).
    """
    from sift_parallel_optimization.config import REF_PI, REF_SIGMA

    i = jnp.arange(n, dtype=jnp.float32)
    s = jnp.arange(n_scales, dtype=jnp.float32)
    sig = REF_SIGMA / (s + 1.0)
    c = (length.astype(jnp.float32) - 1.0) / 2.0
    x = i[None, :] - c
    f = jnp.exp(-(x**2) / (2.0 * sig[:, None] ** 2)) / (
        sig[:, None] * jnp.sqrt(2.0 * REF_PI)
    )
    return jnp.where(i[None, :] < length, f, 0.0)


def _local_octaves_dog(
    img: jax.Array, k: int, n_scales: int, n_octaves: int, axis: str
) -> jax.Array:
    """Inside shard_map: replicated (N, N) image -> (k, n_scales, N, N),
    device d owning octaves d*k .. d*k+k-1 (padded into N x N buffers)."""
    d = lax.axis_index(axis)
    n = img.shape[0]
    # The halving loop's carry varies per device (trip count depends on
    # axis_index); mark the replicated input as varying up front.
    img = lax.pcast(img, (axis,), to="varying")
    outs = []
    for local in range(k):
        oct_idx = d * k + local
        # Repeated masked halving: octave o base = o halvings of the image.
        def body(i, x):
            return jnp.where(i < oct_idx, _padded_halve(x), x)

        base = lax.fori_loop(0, n_octaves, body, img)
        length = (n // jnp.left_shift(1, jnp.minimum(oct_idx, 30))).astype(
            jnp.int32
        )
        f = _masked_filter_bank(n, n_scales, length)
        out = base[None] * window_dog_planes(f)
        # Zero the padded region and any octave index beyond the pyramid.
        valid = oct_idx < n_octaves
        outs.append(jnp.where(valid, out, 0.0))
    return jnp.stack(outs)


def octave_sharded_reference_dog_pyramid(
    img: jax.Array, S: int, mesh: Mesh, axis: str = "spatial",
    n_octaves: int | None = None,
) -> list[jax.Array]:
    """Octave-sharded REFERENCE pyramid: device d owns octave block d.

    Returns the usual list of (S+3, size_o, size_o) arrays (cropped from
    the padded per-device buffers). Zero inter-device communication.
    """
    from sift_parallel_optimization.config import num_octaves

    img = img.astype(jnp.float32)
    n = img.shape[0]
    total = num_octaves(n)
    n_octaves = total if n_octaves is None else min(n_octaves, total)
    n_dev = mesh.shape[axis]
    k = -(-n_octaves // n_dev)  # octaves per device (ceil)

    fn = shard_map(
        functools.partial(
            _local_octaves_dog,
            k=k, n_scales=S + 3, n_octaves=n_octaves, axis=axis,
        ),
        mesh=mesh,
        in_specs=P(),
        out_specs=P(axis),
    )
    padded = fn(img)  # (n_dev * k, n_scales, N, N)
    return [
        padded[o, :, : n // 2**o, : n // 2**o] for o in range(n_octaves)
    ]


def _blur_local_rows(local: jax.Array, taps: jax.Array) -> jax.Array:
    """Inside shard_map: blur (h, W) local rows; halo rows come from
    neighbors via ppermute, W handled locally with edge padding."""
    k = taps.shape[0]
    r = k // 2
    x = exchange_rows(local, r, "spatial")  # (h + 2r, W)
    # Column (W) pass — row-local.
    xw = jnp.pad(x, ((0, 0), (r, r)), mode="edge")
    x = lax.conv_general_dilated(
        xw[None, None], taps.reshape(1, 1, 1, k).astype(x.dtype), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    # Row (H) pass — consumes the halo.
    x = lax.conv_general_dilated(
        x[None, None], taps.reshape(1, 1, k, 1).astype(x.dtype), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    return x


def sharded_separable_blur(mesh: Mesh):
    """Returns fn(img, taps): row-sharded separable Gaussian blur.

    Bit-compatible with core.pyramid_ref.separable_blur (tested); the ICI
    traffic is exactly 2 * radius * W floats per shard boundary per pass —
    the minimum any distributed stencil can move."""
    return shard_map(
        _blur_local_rows,
        mesh=mesh,
        in_specs=(P("spatial", None), P()),
        out_specs=P("spatial", None),
    )


def _band_matrices(h: int, sigmas, dtype) -> jnp.ndarray:
    """(n_sigma, h, h + 2*max_r) Toeplitz band slices for the row pass of a
    halo-extended shard.

    out[a] = sum_b L[a, b] * x_ext[b] with x_ext the (h + 2r)-row
    halo-extended local block — exchange_rows already provides replicate
    padding at the global border, so every shard uses the SAME unclamped
    band (edge handling lives in the halo, not the matrix)."""
    import math as _math

    import numpy as np

    radii = [max(1, int(_math.ceil(3.0 * s))) for s in sigmas]
    r = max(radii)
    L = np.zeros((len(sigmas), h, h + 2 * r), np.float32)
    for si, (sig, rs) in enumerate(zip(sigmas, radii)):
        x = np.arange(-rs, rs + 1, dtype=np.float64)
        taps = np.exp(-(x**2) / (2.0 * sig * sig))
        taps = (taps / taps.sum()).astype(np.float32)
        for a in range(h):
            L[si, a, a + r - rs : a + r + rs + 1] = taps
    return jnp.asarray(L, dtype), r


def sharded_blur_bank(
    mesh: Mesh, height: int, width: int, sigmas, axis: str = "spatial",
    dtype=jnp.float32, precision=None,
):
    """Row-sharded multi-scale Gaussian blur as two MXU matmuls per shard.

    The single-device form is core.pyramid_ref.blur_bank (B^T X B as
    matmuls); sharding the rows turns the row pass into a per-shard
    band-matrix matmul over halo-extended rows — ONE ppermute halo
    exchange (max radius over all sigmas) covers every scale, in place of
    shard-local 1-channel convs. The analogue of the reference's drafted
    MPI x SIMD hybrids (mpitest.cpp:190-437).

    Returns fn: (height, width) row-sharded on ``axis`` ->
    (n_sigma, height, width) row-sharded. Requires height % axis_size == 0
    and local height >= max radius.
    """
    from sift_parallel_optimization.core.pyramid_ref import blur_matrix

    n_dev = mesh.shape[axis]
    h = height // n_dev
    L, r = _band_matrices(h, sigmas, dtype)
    bank_w = jnp.stack(
        [blur_matrix(width, s) for s in sigmas]
    ).astype(dtype)
    # Same measured speed/accuracy knob as blur_bank (HIGHEST = geometry
    # accuracy anchor; HIGH = 2x cheaper, detection-grade only; DEFAULT
    # 1-pass bf16 = the known spurious-extrema trap). See
    # core/pyramid_ref.blur_bank and PyramidConfig.blur_precision.
    prec = jax.lax.Precision.HIGHEST if precision is None else precision

    def local(x, bw, band):
        # OVERLAPPED halo exchange (round 5): issue the ppermutes
        # first, then run the bulk column pass + interior row pass on
        # LOCAL rows only — neither depends on the halo, so XLA
        # schedules the async collective-permute underneath them (the
        # reference's send-rows-while-computing pattern,
        # /root/reference/mpitest.cpp:47-64). Only the two r-row
        # boundary contributions (band columns [0, r) and [r+h, r+2r))
        # consume the arrived strips. Algebraically identical to the
        # old exchange-then-one-matmul form: the band is zero outside
        # [a, a+2r], so interior rows receive exact 0.0 from the halo
        # terms (sharded == unsharded equivalence tests unchanged).
        from sift_parallel_optimization.parallel.halo import (
            neighbor_rows,
        )

        from_up, from_down = neighbor_rows(x, r, axis)  # (r, W) each

        def colpass(rows):
            return jnp.einsum(
                "hw,swv->shv", rows, bw,
                preferred_element_type=jnp.float32, precision=prec,
            )

        def rowpass(bandpart, tmp):
            return jnp.einsum(
                "sab,sbv->sav", bandpart, tmp,
                preferred_element_type=jnp.float32, precision=prec,
            )

        # Halo-independent bulk (overlaps the ppermutes in flight).
        out = rowpass(band[:, :, r:r + h], colpass(x))
        # Halo-dependent boundary terms (2r rows of column pass + two
        # (h, r) x (r, W) matmuls — a 2r/h fraction of the work).
        out = out + rowpass(band[:, :, :r], colpass(from_up))
        out = out + rowpass(band[:, :, r + h:], colpass(from_down))
        return out.astype(x.dtype)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=P(None, axis, None),
    )
    return lambda x: fn(x, bank_w, L)


def sharded_sift_gaussian_pyramid(img: jax.Array, cfg, mesh: Mesh) -> list[jax.Array]:
    """True SIFT Gaussian pyramid, large octaves row-sharded with halo
    exchange, small-tail octaves computed unsharded.

    All blurs run as Toeplitz/band matmuls on the MXU (sharded_blur_bank;
    single-device tail uses blur_bank) — one halo exchange per octave
    covers every scale. The downsample between octaves is a stride-2 row
    slice: while the local shard height stays even the slice is
    shard-local (no resharding); once octaves become too small the loop
    falls back to the unsharded path — the resharding point SURVEY.md
    section 7 flags as hard part (d).
    """
    import math as _math

    from sift_parallel_optimization.core.pyramid_ref import (
        blur_bank,
        strided_subsample,
        _octave_scale_sigmas,
    )

    n_sp = mesh.shape["spatial"]

    x = img.astype(cfg.dtype)
    base_sigma = _math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
    rel = _octave_scale_sigmas(cfg)
    max_r = max(
        max(1, int(_math.ceil(3.0 * s))) for s in [base_sigma, *rel]
    )

    def can_shard(size: int) -> bool:
        # Halo must not exceed local height, and stride-2 must stay local.
        return size % (2 * n_sp) == 0 and size // n_sp >= max(2 * max_r, 8)

    octaves = []
    prec = cfg.blur_lax_precision
    sharded = can_shard(x.shape[0])
    if sharded:
        x = sharded_blur_bank(
            mesh, x.shape[0], x.shape[1], [base_sigma], dtype=cfg.dtype,
            precision=prec,
        )(x)[0]
    else:
        x = blur_bank(x, [base_sigma], precision=prec)[0]
    for _o in range(cfg.n_octaves):
        if sharded:
            blurred = sharded_blur_bank(
                mesh, x.shape[0], x.shape[1], rel, dtype=cfg.dtype,
                precision=prec,
            )(x)
        else:
            blurred = blur_bank(x, rel, precision=prec)
        octave = jnp.concatenate([x[None], blurred], axis=0)
        octaves.append(octave)
        x = strided_subsample(octave[cfg.S], 2)
        if sharded and not can_shard(x.shape[0]):
            sharded = False  # resharding point: tail octaves run unsharded
    return octaves
