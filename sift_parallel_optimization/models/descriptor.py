"""Orientation assignment + 128-d SIFT descriptors, fully on device.

North-star extension (BASELINE.json config 2); the reference has no
descriptor stage. ONE pass over the keypoints, no scattered per-sample
gathers:

* All octaves' Gaussian planes are packed into one 2-D "plane atlas"
  (scales and octaves stacked vertically, spatially padded so every patch
  window is in bounds and every patch origin can be aligned to a
  (ROW_ALIGN, 128) grid).
* ONE gather (:func:`extract_atlas_patches`) pulls a (rows, 256) patch
  per keypoint straight from the keypoint's own (octave, scale) plane,
  and two batched hat-weight einsums resample all patches at once.
* The sigma-proportional sample grid is AXIS-ALIGNED (rotation is applied
  to bin coordinates and gradient angles, not the sampling lattice), so
  resampling is two small batched matmuls against bilinear hat-weight
  matrices.
* Gradients are central differences ON the resampled grid (uniform sigma-
  proportional spacing — scale-normalized by construction).
* Histogram votes are one-hot einsums (batched matmuls) with the trilinear
  corner loop unrolled statically.

Orientation and descriptor share the same patches: use
``orient_and_describe`` for the fused path (the frontend does); the
separate ``assign_orientations`` / ``compute_descriptors`` entry points
are kept for tests and ad-hoc use.

Precision note: the resampling einsums are pinned to HIGHEST (see
:func:`_resample`); the histogram votes run at the backend's DEFAULT
matmul precision (TF32 on an H100's tensor cores, float32 on the CPU),
and chip_smoke.py's frontend phase bounds the device-vs-CPU descriptor
difference. A keypoint whose orientation histogram has two near-equal
peaks may still pick the other peak on a different backend; such a
keypoint simply fails to match, which the pipeline tolerates by
construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sift_parallel_optimization.models.keypoints import Keypoints

N_ORI_BINS = 36
ORI_SIGMA_FACTOR = 1.5     # orientation window sigma = 1.5 * keypoint sigma
ORI_RADIUS_FACTOR = 3.0    # window radius = 3 * window sigma
ORI_GRID = 18              # samples per axis (16x16 usable gradients)

DESC_WIDTH = 4             # 4x4 spatial bins
DESC_ORI_BINS = 8
DESC_GRID = 26             # samples per axis (24x24 usable gradients)
DESC_BIN_SIGMA = 3.0       # spatial bin width = 3 * sigma_o (Lowe 2004)
DESC_CLIP = 0.2

# Atlas geometry. Patch must cover the largest descriptor window radius:
# sigma_o_max = sigma0 * 2^((S + MAX_REFINE_OFFSET)/S), which GROWS as S
# shrinks — 3.7 px at S=3 but 4.85 px at S=1 — giving a max radius of
# 3*sigma_o*sqrt(2)*2.5 ~ 51.5 px. The margins below guarantee coverage
# for S >= 1 (and _keypoint_patches clamps the radius to MAX_RADIUS as a
# final guard). Patch origins align to ROW_ALIGN rows and 128 columns.
#
# ATLAS_DTYPE stays float32: a bfloat16 atlas halves the patch bytes (the
# stage's dominant memory traffic) but its rounding re-rolls near-tied
# orientation-histogram peaks, which measurably degraded the loop-closure
# revisit gates. Alignment only moves the patch origin (the resample
# weights absorb it), so ROW_ALIGN trades patch height against nothing
# but the alignment slack.
ATLAS_DTYPE = jnp.float32
ROW_ALIGN = 16 if jnp.dtype(ATLAS_DTYPE).itemsize < 4 else 8
MAX_RADIUS = 52            # guaranteed in-patch sample radius (+1 bilinear)
ROW_PAD = 64               # top pad per octave (mult of 16, >= MAX_RADIUS+4)
COL_PAD = 128              # left pad per octave (one column block)
PATCH_ROWS = 128           # >= 2*MAX_RADIUS + 16 alignment slack, mult of 16
PATCH_COLS = 256           # >= 2*MAX_RADIUS + 128 alignment slack


def max_patch_radius(S: int, sigma0: float = 1.6) -> int:
    """Config-tight sample-radius bound.

    MAX_RADIUS = 52 is the S=1 worst case; at the shipping S=3 the
    largest refined scale is sigma0 * 2^((S + 0.6)/S) ~ 3.68 px, whose
    descriptor window radius is ~39 px. Using the config's own bound
    shrinks the per-keypoint patch from 128 rows (-25% of the stage's
    dominant memory traffic at ROW_ALIGN 8) with IDENTICAL sampling for every
    keypoint the config can produce (the radius clamp only tightens
    from 51 to a value no keypoint reaches). The 0.6 matches
    detect.MAX_REFINE_OFFSET (a refined scale can exceed its integer
    plane by at most the trust region).
    """
    import math

    sig_max = sigma0 * 2.0 ** ((S + 0.6) / S)
    rad_d = DESC_BIN_SIGMA * sig_max * math.sqrt(2.0) * (DESC_WIDTH + 1) / 2
    rad_o = ORI_RADIUS_FACTOR * ORI_SIGMA_FACTOR * sig_max
    return min(MAX_RADIUS, int(math.ceil(max(rad_d, rad_o))) + 1)


def patch_rows_for(max_radius: int) -> int:
    """Rows of the gathered patch: 2*(radius+1 bilinear) + ROW_ALIGN
    slack for the aligned-down origin, rounded to ROW_ALIGN."""
    need = 2 * (max_radius + 1) + ROW_ALIGN
    return min(PATCH_ROWS, -(-need // ROW_ALIGN) * ROW_ALIGN)


def _roundup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def build_atlas(gauss_octaves: list[jax.Array]):
    """Pack (S+3, H_o, W_o) octaves into one (R, C) atlas + index tables.

    Scale s of octave o occupies rows
    [row_off[o] + s * hprime[o], row_off[o] + (s+1) * hprime[o]) with the
    image itself starting ROW_PAD rows / COL_PAD cols into its band.
    """
    heights = [g.shape[1] for g in gauss_octaves]
    widths = [g.shape[2] for g in gauss_octaves]
    wlim = [_roundup(w, 128) for w in widths]      # max aligned x0
    hprime = [2 * ROW_PAD + _roundup(h, ROW_ALIGN) for h in heights]
    C = max(COL_PAD + wl + 128 for wl in wlim)
    blocks, row_off = [], []
    r = 0
    for g, hp, w in zip(gauss_octaves, hprime, widths):
        s, h, _ = g.shape
        block = jnp.pad(
            g.astype(ATLAS_DTYPE),
            (
                (0, 0),
                (ROW_PAD, hp - ROW_PAD - h),
                (COL_PAD, C - COL_PAD - w),
            ),
        ).reshape(s * hp, C)
        blocks.append(block)
        row_off.append(r)
        r += s * hp
    atlas = jnp.concatenate(blocks, axis=0)
    meta = {
        "row_off": jnp.asarray(row_off, jnp.int32),
        "hprime": jnp.asarray(hprime, jnp.int32),
        "wlim": jnp.asarray(wlim, jnp.int32),
    }
    return atlas, meta


def extract_atlas_patches(
    atlas: jax.Array, ys: jax.Array, xs: jax.Array, rows: int, cols: int
) -> jax.Array:
    """(R, C) atlas + (K,) row/col origins -> (K, rows, cols) patches.

    A vmapped ``dynamic_slice``, which XLA lowers to one gather of
    contiguous rows; origins past the atlas edge are clamped
    (``dynamic_slice`` semantics). A hand-written gather kernel measured
    no faster in the whole frontend on the H100 (PERF.md).
    """

    def one(y0, x0):
        return jax.lax.dynamic_slice(atlas, (y0, x0), (rows, cols))

    return jax.vmap(one)(ys.astype(jnp.int32), xs.astype(jnp.int32))


def _keypoint_patches(
    gauss_octaves: list[jax.Array],
    kp: Keypoints,
    max_radius: int = MAX_RADIUS,
):
    """One aligned (patch_rows_for(max_radius), 256) patch per keypoint
    from its own plane.

    Returns (patches, py, px, sig_o): float in-patch keypoint coordinates
    (fractional) and the keypoint sigma in octave pixels.
    """
    rows = patch_rows_for(max_radius)
    atlas, meta = build_atlas(gauss_octaves)
    o = jnp.clip(kp.octave, 0, len(gauss_octaves) - 1)
    inv = jnp.exp2(-o.astype(jnp.float32))
    y_o = kp.y * inv
    x_o = kp.x * inv
    sig_o = kp.sigma * inv
    ya = y_o + ROW_PAD
    xa = x_o + COL_PAD
    hp = meta["hprime"][o]
    wl = meta["wlim"][o]
    ro = meta["row_off"][o]
    y0l = jnp.clip(
        (jnp.floor((ya - max_radius) / ROW_ALIGN) * ROW_ALIGN).astype(
            jnp.int32
        ),
        0,
        hp - rows,
    )
    x0 = jnp.clip(
        (jnp.floor((xa - (max_radius + 1.0)) / 128.0) * 128).astype(
            jnp.int32
        ),
        0,
        wl,
    )
    grow = ro + kp.scale * hp + y0l
    patches = extract_atlas_patches(atlas, grow, x0, rows, PATCH_COLS)
    py = ya - y0l.astype(jnp.float32)
    px = xa - x0.astype(jnp.float32)
    return patches, py, px, sig_o


def _hat_weights(coords: jax.Array, extent: int) -> jax.Array:
    """(K, G) absolute patch coords -> (K, G, extent) bilinear hat weights."""
    p = jnp.arange(extent, dtype=jnp.float32)
    return jnp.maximum(0.0, 1.0 - jnp.abs(coords[..., None] - p))


def _resample(patches, py, px, offsets) -> jax.Array:
    """Separable bilinear resample at axis-aligned sigma-scaled offsets.

    patches: (K, PR, PC); py/px: (K,) in-patch keypoint coords;
    offsets: (K, G) pixel offsets. Returns (K, G, G) samples.
    """
    cy = py[:, None] + offsets                       # (K, G) rows
    cx = px[:, None] + offsets                       # (K, G) cols
    # Hat weights in the patches' dtype: avoids a mixed-dtype upcast of
    # the (much larger) patch operand. Extents follow the actual patch
    # shape (config-tight rows, patch_rows_for). Pinned to HIGHEST: the
    # gradients are differences of neighbouring samples, and TF32-rounded
    # samples (the H100's default) flip orientation peaks on enough
    # keypoints to take the 18-frame revisit gate from ~1% to 14% of
    # span (PERF.md).
    hi = jax.lax.Precision.HIGHEST
    ay = _hat_weights(cy, patches.shape[-2]).astype(patches.dtype)
    ax = _hat_weights(cx, patches.shape[-1]).astype(patches.dtype)
    t = jnp.einsum("kgp,kpq->kgq", ay, patches,
                   preferred_element_type=jnp.float32, precision=hi)
    return jnp.einsum("kgq,khq->kgh", t, ax.astype(t.dtype),
                      preferred_element_type=jnp.float32, precision=hi)


def _grid_gradients(samples: jax.Array):
    """(K, G, G) -> (gy, gx) central differences, (K, G-2, G-2)."""
    gy = (samples[:, 2:, 1:-1] - samples[:, :-2, 1:-1]) / 2
    gx = (samples[:, 1:-1, 2:] - samples[:, 1:-1, :-2]) / 2
    return gy, gx


def _radii(
    sig_o: jax.Array, max_radius: int = MAX_RADIUS
) -> tuple[jax.Array, jax.Array]:
    """Per-keypoint (orientation, descriptor) sample-grid radii, clamped
    to the guaranteed patch coverage."""
    rad_o = jnp.minimum(
        ORI_RADIUS_FACTOR * ORI_SIGMA_FACTOR * sig_o, max_radius - 1.0
    )
    rad_d = jnp.minimum(
        DESC_BIN_SIGMA * sig_o * (2**0.5) * (DESC_WIDTH + 1) * 0.5,
        max_radius - 1.0,
    )
    return rad_o, rad_d


def _sample_grids(
    gauss_octaves: list[jax.Array],
    kp: Keypoints,
    max_radius: int = MAX_RADIUS,
):
    """Shared entry: one patch read per keypoint -> BOTH sample grids.

    Gathered patches + two batched hat-weight einsums. Returns
    (samples_o (K,18,18), samples_d (K,26,26), off_o (K,18),
    off_d (K,26), sig_o)."""
    lin_o = jnp.linspace(-1.0, 1.0, ORI_GRID)
    lin_d = jnp.linspace(-1.0, 1.0, DESC_GRID)
    patches, py, px, sig_o = _keypoint_patches(
        gauss_octaves, kp, max_radius=max_radius
    )
    rad_o, rad_d = _radii(sig_o, max_radius=max_radius)
    samples_o = _resample(patches, py, px, lin_o[None] * rad_o[:, None])
    samples_d = _resample(patches, py, px, lin_d[None] * rad_d[:, None])
    off_o = lin_o[None] * rad_o[:, None]
    off_d = lin_d[None] * rad_d[:, None]
    return samples_o, samples_d, off_o, off_d, sig_o


def _smooth_hist_circular(hist: jax.Array, iters: int = 2) -> jax.Array:
    """[1,4,6,4,1]/16 circular smoothing along the last axis."""
    for _ in range(iters):
        hist = (
            6 * hist
            + 4 * (jnp.roll(hist, 1, -1) + jnp.roll(hist, -1, -1))
            + (jnp.roll(hist, 2, -1) + jnp.roll(hist, -2, -1))
        ) / 16.0
    return hist


def _orientation_from_samples(samples, offsets, sig_o, kp: Keypoints):
    """(K,) dominant orientation from the shared (K, 18, 18) sample grid."""
    g = ORI_GRID
    k = kp.capacity
    win_sigma = ORI_SIGMA_FACTOR * sig_o
    gy, gx = _grid_gradients(samples)                 # (K, g-2, g-2)
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(k, -1)
    ang = jnp.arctan2(gy, gx).reshape(k, -1)

    du = offsets[:, 1:-1]
    d2 = du[:, :, None] ** 2 + du[:, None, :] ** 2
    w = mag * jnp.exp(
        -d2.reshape(k, -1) / (2.0 * win_sigma[:, None] ** 2 + 1e-12)
    )

    # Linear (hat-weighted, circular) binning — same trick as the
    # descriptor vote: no one-hot materialization, and bin interpolation
    # comes for free.
    binf = (ang + jnp.pi) / (2 * jnp.pi) * N_ORI_BINS
    bins = jnp.arange(N_ORI_BINS, dtype=jnp.float32)
    db = jnp.abs(binf[..., None] - bins)
    db = jnp.minimum(db, N_ORI_BINS - db)
    wb = jnp.maximum(0.0, 1.0 - db)
    hist = jnp.einsum("kp,kpb->kb", w, wb,
                      preferred_element_type=jnp.float32)

    hist = _smooth_hist_circular(hist)

    def peak_theta(h, peak):
        hp = jnp.take_along_axis(h, peak[:, None], -1)[:, 0]
        hl = jnp.take_along_axis(
            h, ((peak - 1) % N_ORI_BINS)[:, None], -1
        )[:, 0]
        hr = jnp.take_along_axis(
            h, ((peak + 1) % N_ORI_BINS)[:, None], -1
        )[:, 0]
        denom = hl - 2 * hp + hr
        frac = jnp.where(
            jnp.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0
        )
        binf = peak.astype(jnp.float32) + frac
        theta = binf / N_ORI_BINS * 2 * jnp.pi - jnp.pi
        return jnp.mod(theta + jnp.pi, 2 * jnp.pi) - jnp.pi, hp

    peak1 = jnp.argmax(hist, axis=-1)
    theta1, h1 = peak_theta(hist, peak1)
    # Secondary peak (Lowe's 80% rule): best bin at distance >= 2 from the
    # primary, qualifying when within 80% of it AND a local maximum.
    bins = jnp.arange(N_ORI_BINS)
    d = jnp.abs(bins[None, :] - peak1[:, None])
    d = jnp.minimum(d, N_ORI_BINS - d)
    masked = jnp.where(d >= 2, hist, -jnp.inf)
    peak2 = jnp.argmax(masked, axis=-1)
    theta2, h2 = peak_theta(hist, peak2)
    hl2 = jnp.take_along_axis(
        hist, ((peak2 - 1) % N_ORI_BINS)[:, None], -1
    )[:, 0]
    hr2 = jnp.take_along_axis(
        hist, ((peak2 + 1) % N_ORI_BINS)[:, None], -1
    )[:, 0]
    second_ok = (h2 >= 0.8 * h1) & (h2 >= hl2) & (h2 >= hr2)
    return theta1, theta2, second_ok


def _descriptors_from_samples(samples, offsets, sig_o, theta, kp: Keypoints):
    """(K, 128) raw descriptor histograms from the (K, 26, 26) samples."""
    d = DESC_WIDTH
    g = DESC_GRID
    k = kp.capacity
    bin_w = DESC_BIN_SIGMA * sig_o                    # (K,) pixels per bin
    gy, gx = _grid_gradients(samples)
    p = (g - 2) * (g - 2)
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(k, p)
    ang = jnp.arctan2(gy, gx).reshape(k, p) - theta[:, None]

    du = offsets[:, 1:-1]
    dy = jnp.broadcast_to(du[:, :, None], (k, g - 2, g - 2)).reshape(k, p)
    dx = jnp.broadcast_to(du[:, None, :], (k, g - 2, g - 2)).reshape(k, p)
    cos_t, sin_t = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]
    inv_bw = 1.0 / jnp.maximum(bin_w, 1e-6)[:, None]
    u = (cos_t * dy - sin_t * dx) * inv_bw            # rotated row, bin units
    v = (sin_t * dy + cos_t * dx) * inv_bw            # rotated col, bin units

    w = mag * jnp.exp(-(u * u + v * v) / (0.5 * d * d))

    rbin = u + d / 2.0 - 0.5
    cbin = v + d / 2.0 - 0.5
    obin = jnp.mod(ang, 2 * jnp.pi) / (2 * jnp.pi) * DESC_ORI_BINS

    # Trilinear voting WITHOUT the classic 8-corner loop: the corner
    # weights (1-f / f) are exactly the bilinear hat evaluated at the two
    # neighboring integer bins, so per-dimension hat-weight VECTORS
    # (K, P, 4/4/8) reproduce all 8 corner contributions in one separable
    # product — no (K, P, 128) one-hot materialization (8x ~37 MB of HBM
    # traffic at K=512), just two small contractions.
    bins_rc = jnp.arange(d, dtype=jnp.float32)
    wr = jnp.maximum(0.0, 1.0 - jnp.abs(rbin[..., None] - bins_rc))
    wc = jnp.maximum(0.0, 1.0 - jnp.abs(cbin[..., None] - bins_rc))
    bins_o = jnp.arange(DESC_ORI_BINS, dtype=jnp.float32)
    do = jnp.abs(obin[..., None] - bins_o)
    do = jnp.minimum(do, DESC_ORI_BINS - do)          # circular
    wo = jnp.maximum(0.0, 1.0 - do)

    t = jnp.einsum("kpr,kpc->kprc", w[..., None] * wr, wc).reshape(k, p, d * d)
    hist = jnp.einsum(
        "kpx,kpo->kxo", t, wo, preferred_element_type=jnp.float32
    ).reshape(k, d * d * DESC_ORI_BINS)
    return hist


def _normalize_desc(hist: jax.Array, valid: jax.Array) -> jax.Array:
    norm = jnp.linalg.norm(hist, axis=-1, keepdims=True)
    desc = hist / jnp.maximum(norm, 1e-7)
    desc = jnp.minimum(desc, DESC_CLIP)
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-7)
    return jnp.where(valid[:, None], desc, 0.0)


def orient_and_describe(
    gauss_octaves: list[jax.Array],
    kp: Keypoints,
    dual_orientation: bool = False,
    max_radius: int = MAX_RADIUS,
) -> tuple[Keypoints, jax.Array]:
    """Fused path: one patch gather feeds orientation AND descriptor.

    With ``dual_orientation`` (Lowe's 80% rule), the output doubles its
    capacity: slots [K:2K) duplicate each keypoint with the secondary
    histogram peak as orientation (valid only where a qualifying second
    peak exists). Patches are gathered once and shared by both halves, so
    the extra cost is one more descriptor-histogram pass. Downstream
    consumers need no changes — they are capacity-agnostic.
    """
    s_o, s_d, off_o, off_d, sig_o = _sample_grids(
        gauss_octaves, kp, max_radius=max_radius
    )
    theta1, theta2, second_ok = _orientation_from_samples(
        s_o, off_o, sig_o, kp
    )
    kp1 = kp._replace(orientation=jnp.where(kp.valid, theta1, 0.0))
    hist1 = _descriptors_from_samples(
        s_d, off_d, sig_o, kp1.orientation, kp1
    )
    desc1 = _normalize_desc(hist1, kp1.valid)
    if not dual_orientation:
        return kp1, desc1

    valid2 = kp.valid & second_ok
    kp2 = kp._replace(
        orientation=jnp.where(valid2, theta2, 0.0), valid=valid2
    )
    hist2 = _descriptors_from_samples(
        s_d, off_d, sig_o, kp2.orientation, kp2
    )
    desc2 = _normalize_desc(hist2, valid2)
    both = Keypoints(*[
        jnp.concatenate([a, b], axis=0) for a, b in zip(kp1, kp2)
    ])
    return both, jnp.concatenate([desc1, desc2], axis=0)


def assign_orientations(
    gauss_octaves: list[jax.Array], kp: Keypoints
) -> Keypoints:
    """Fill ``kp.orientation`` with the dominant gradient direction.

    One orientation per keypoint; use ``orient_and_describe`` with
    ``dual_orientation=True`` for Lowe's 80% secondary-peak duplicates.
    """
    s_o, _s_d, off_o, _off_d, sig_o = _sample_grids(gauss_octaves, kp)
    theta, _theta2, _ok = _orientation_from_samples(s_o, off_o, sig_o, kp)
    return kp._replace(orientation=jnp.where(kp.valid, theta, 0.0))


def compute_descriptors(
    gauss_octaves: list[jax.Array], kp: Keypoints
) -> jax.Array:
    """(K, 128) L2-normalized, 0.2-clipped SIFT descriptors (Lowe 2004)."""
    _s_o, s_d, _off_o, off_d, sig_o = _sample_grids(gauss_octaves, kp)
    hist = _descriptors_from_samples(s_d, off_d, sig_o, kp.orientation, kp)
    return _normalize_desc(hist, kp.valid)
