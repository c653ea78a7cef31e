"""Scale-space pyramid semantics in pure jnp (the XLA-fused baseline path).

Two modes (see ``config.ScaleSpaceMode``):

* REFERENCE — the behavioral spec of the reference study (SURVEY.md section
  3.4; GuassDePyramid.h:60-149): per-octave strided subsample of the original
  image, separable multiplicative Gaussian *window*, adjacent-scale DoG. This
  single function subsumes the numerics of all 13 reference variants
  (GaussDePyramid-*.h) — their differences were only in how loops were split
  over SIMD lanes / threads / MPI ranks, which here is XLA's job.

* SIFT — a true Gaussian scale space (separable convolution, sigma_s =
  sigma0 * 2^(s/S), octave cascade by downsampling the previous octave's
  scale-S image), which the detect/describe/match pipeline builds on.

Everything here is jittable with static shapes: the octave loop is a Python
loop unrolled at trace time (octave count is a static function of image size),
so XLA sees a fixed DAG of dense ops it can fuse and tile —
no dynamic shapes, no data-dependent control flow.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

from sift_parallel_optimization.config import (
    REF_PI,
    REF_SIGMA,
    PyramidConfig,
    num_octaves,
)

# ---------------------------------------------------------------------------
# REFERENCE mode (parity with GuassDePyramid.h)
# ---------------------------------------------------------------------------


def reference_filter_bank(size: int, n_scales: int, dtype=jnp.float32) -> jax.Array:
    """(n_scales, size) bank of the reference's 1-D Gaussian windows.

    f_s[i] = exp(-(i-c)^2 / (2 sig_s^2)) / (sig_s * sqrt(2*PI)), with
    sig_s = 2/(s+1), c = (size-1)/2, PI = 3.1414926
    (GuassDePyramid.h:117-120; constants GuassDePyramid.h:7-8).
    """
    i = jnp.arange(size, dtype=jnp.float32)
    s = jnp.arange(n_scales, dtype=jnp.float32)
    sig = REF_SIGMA / (s + 1.0)  # (n_scales,)
    c = (size - 1) / 2.0
    x = i - c  # (size,)
    f = jnp.exp(-(x[None, :] ** 2) / (2.0 * sig[:, None] ** 2)) / (
        sig[:, None] * jnp.sqrt(2.0 * REF_PI)
    )
    return f.astype(dtype)


def window_dog_planes(f: jax.Array) -> jax.Array:
    """(n_scales, N) window bank -> (n_scales, ...) separable DoG weights.

    Planes 0..S+1 hold W_s - W_{s+1}, plane S+2 holds W_{S+2} (the
    in-place storage layout of GuassDePyramid.h:136-149). Shared by the
    core path and every sharded decomposition so the REFERENCE semantics
    live in exactly one place.
    """
    windows = f[:, :, None] * f[:, None, :]
    w_dog = windows[:-1] - windows[1:]
    return jnp.concatenate([w_dog, windows[-1:]], axis=0)


def reference_dog_octave(base: jax.Array, S: int) -> jax.Array:
    """One octave: (size, size) base image -> (S+3, size, size) result.

    Planes 0..S+1 hold DoG, plane S+2 holds the top windowed scale —
    mirroring the reference's in-place storage (GuassDePyramid.h:136-149).

    Fused form: since every scale starts as the same base image and the
    "filter" is the separable window W_s = f_s (x) f_s, the DoG plane is
    base * (W_s - W_{s+1}) — one multiply per output plane. The reference
    instead does 2*(S+3) full-image multiply passes plus S+2 subtract passes;
    here it collapses to a single fused elementwise expression the
    compiler vectorizes (the entire SIMD layer of the reference —
    GaussDePyramid-NEON.h:131-156 et al. — for free).
    """
    size = base.shape[-1]
    f = reference_filter_bank(size, S + 3, dtype=base.dtype)  # (S+3, size)
    return base[None, :, :] * window_dog_planes(f)


def strided_subsample(img: jax.Array, step: int) -> jax.Array:
    """img[::step, ::step], expressed as a 1x1-window stride-``step``
    reduce_window.

    Kept as a reduce_window because it fuses into its producer as a
    strided window; whether a plain strided slice is as fast on the GPU
    has not been measured.
    """
    if step == 1:
        return img
    return lax.reduce_window(
        img, 0.0, lax.add, (1, 1), (step, step), "VALID"
    )


def reference_subsample(img: jax.Array, octave: int) -> jax.Array:
    """Octave o base: the 2^o-strided subsample of the ORIGINAL image
    (GuassDePyramid.h:74-86 — not a cascade over previous octaves)."""
    step = 2**octave
    size = img.shape[0] // step
    return strided_subsample(img, step)[:size, :size]


def _octave_bases(img: jax.Array, n_octaves: int) -> list[jax.Array]:
    """Cascaded stride-2 subsampling: base_o = base_{o-1}[::2, ::2].

    Identical indexing to the reference's independent 2^o-strided subsample
    of the original image (GuassDePyramid.h:74-86) — ([::2])^o == [::2^o]
    on an integer grid — but each step reads the (shrinking) previous base
    instead of re-reading the full image with a growing stride.
    """
    bases = [img]
    for o in range(1, n_octaves):
        prev = bases[-1]
        size = prev.shape[0] // 2
        bases.append(strided_subsample(prev, 2)[:size, :size])
    return bases


def _tail_base_stack(parent: jax.Array, sizes: list[int]) -> jax.Array:
    """(n_tail, t, t) zero-padded stack of ``parent[::2^i]`` bases from
    ONE batched selection-einsum pair.

    The tail of the pyramid is DISPATCH-bound: the cascaded per-base
    subsample + pad + stack chain is a run of tiny launches moving ~5 KB.
    Building every tail base at once
    as ``P_o^T parent P_o`` with 0/1 selection matrices collapses ~11
    launches into two tiny batched matmuls. BIT-exact at HIGHEST
    precision: each output entry is ``x * 1.0`` plus exact zeros (no
    operand rounding), so the compiled-reference parity gate still
    holds; the zero columns of the padded selectors reproduce the zero
    padding of the old per-base jnp.pad.
    """
    import numpy as np

    t = sizes[0]
    p = parent.shape[0]
    sel = np.zeros((len(sizes), p, t), np.float32)
    for o, s in enumerate(sizes):
        step = p // s
        sel[o, np.arange(s) * step, np.arange(s)] = 1.0
    P = jnp.asarray(sel).astype(parent.dtype)
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("hw,owv->ohv", parent, P, precision=hi)
    return jnp.einsum("ohu,ohv->ouv", P, tmp, precision=hi)


def _reference_dog_tail_batched(
    parent: jax.Array, sizes: list[int], S: int
) -> list[jax.Array]:
    """DoG for the small-octave tail as ONE padded batched op.

    Computing each tiny octave separately costs a fixed per-kernel
    overhead that dwarfs the (few-KB) math; building every tail base
    from ``parent`` in one selection einsum (:func:`_tail_base_stack`)
    and computing all their windows in one fused expression collapses
    the tail to ~3 kernels.
    """
    if not sizes:
        return []
    n_scales = S + 3
    t = sizes[0]  # largest tail size (descending order)
    stacked = _tail_base_stack(parent, sizes)  # (n_tail, t, t)
    banks = jnp.stack(
        [
            jnp.pad(
                reference_filter_bank(s, n_scales, dtype=parent.dtype),
                ((0, 0), (0, t - s)),
            )
            for s in sizes
        ]
    )  # (n_tail, n_scales, t)
    w_all = jnp.stack([window_dog_planes(b) for b in banks])
    out = stacked[:, None] * w_all  # (n_tail, n_scales, t, t)
    return [out[i, :, :s, :s] for i, s in enumerate(sizes)]


def reference_dog_pyramid(
    img: jax.Array,
    S: int,
    n_octaves: int | None = None,
    tail_threshold: int = 64,
) -> list[jax.Array]:
    """Full REFERENCE-mode pipeline: list of (S+3, size_o, size_o) per octave.

    Equivalent to GaussPyramid::GenerateDoG over GaussPyInit-ed state
    (GuassDePyramid.h:60-149), validated bit-for-bit against
    core/numpy_golden.py. Octaves smaller than ``tail_threshold`` are
    computed in one padded batched op (see _reference_dog_tail_batched).
    """
    img = img.astype(jnp.float32)
    total = num_octaves(img.shape[0])
    if n_octaves is None:
        n_octaves = total
    n_octaves = min(n_octaves, total)
    sizes = [img.shape[0] // 2**o for o in range(n_octaves)]
    n_head = sum(1 for s in sizes if s >= tail_threshold) or 1
    # Cascade only the head bases; the tail stack builds from the last
    # head base in one batched op (_tail_base_stack).
    bases = _octave_bases(img, n_head)
    out = [reference_dog_octave(b, S) for b in bases]
    out.extend(
        _reference_dog_tail_batched(bases[-1], sizes[n_head:], S)
    )
    return out


# ---------------------------------------------------------------------------
# SIFT mode (true Gaussian scale space)
# ---------------------------------------------------------------------------


def gaussian_kernel_1d(sigma: float, dtype=jnp.float32) -> jax.Array:
    """Normalized 1-D Gaussian taps, radius = ceil(3*sigma) (static length)."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-(x**2) / (2.0 * sigma * sigma))
    return (k / jnp.sum(k)).astype(dtype)


def separable_blur(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Separable Gaussian blur of (..., H, W) with replicate border padding.

    Rows then columns, each a 1-D VALID convolution after edge padding —
    XLA lowers these to convolutions / fused multiply-adds. The
    reference's SIMD inner loops (e.g. GaussDePyramid-AVXxPTHREAD.h:217-252)
    are the hand-written analogue of what XLA emits here.
    """
    k = taps.shape[0]
    r = k // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2], x.shape[-1]
    n = 1
    for d in lead:
        n *= d
    x4 = x.reshape(n, 1, h, w)
    dn = ("NCHW", "OIHW", "NCHW")
    kern_w = taps.reshape(1, 1, 1, k).astype(x.dtype)
    kern_h = taps.reshape(1, 1, k, 1).astype(x.dtype)
    pad_w = jnp.pad(x4, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    x4 = lax.conv_general_dilated(pad_w, kern_w, (1, 1), "VALID", dimension_numbers=dn)
    pad_h = jnp.pad(x4, ((0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    x4 = lax.conv_general_dilated(pad_h, kern_h, (1, 1), "VALID", dimension_numbers=dn)
    return x4.reshape(*lead, h, w)


def _octave_scale_sigmas(cfg: PyramidConfig) -> list[float]:
    """COMPOSED sigmas: blur applied to the octave BASE to reach scale s.

    Gaussian semigroup: blurring the base (absolute sigma0) once with
    sqrt(sig_s^2 - sigma0^2) equals the Lowe cascade of incremental blurs in
    the continuum. Composed blurs are used because they remove the
    serial scale-to-scale dependency — all S+2 blurred scales of an octave
    are computed from one base in a single batched matmul (see blur_bank).
    """
    sig = cfg.sift_sigmas()
    return [
        math.sqrt(max(sig[s] ** 2 - sig[0] ** 2, 1e-12))
        for s in range(1, cfg.n_scales)
    ]


def _blur_matrix_np(size: int, sigma: float):
    """NumPy core of :func:`blur_matrix` (sigma is static; this must stay
    trace-free so band-block construction works under jit)."""
    import numpy as np

    # Same taps as gaussian_kernel_1d, in pure NumPy.
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-(x**2) / (2.0 * sigma * sigma))
    taps = (taps / taps.sum()).astype(np.float32)
    b = np.zeros((size, size), np.float32)
    v = np.arange(size)
    for k, t in enumerate(taps):
        u = np.clip(v + k - r, 0, size - 1)
        np.add.at(b, (u, v), t)
    return b


def blur_matrix(size: int, sigma: float) -> jnp.ndarray:
    """(size, size) banded Toeplitz matrix B with edge-clamped Gaussian taps.

    (x @ B) equals a 1-D VALID convolution of each row of x with
    gaussian_kernel_1d(sigma) after replicate ('edge') padding — i.e. the
    same op as separable_blur's column pass, reformulated as a matmul (a
    1-channel convolution leaves a matrix unit idle; a batched matmul
    keeps it busy).
    """
    return jnp.asarray(_blur_matrix_np(size, sigma))


def _band_radius(sigma: float) -> int:
    """Half-width of blur_matrix's nonzero band (taps radius)."""
    return max(1, int(math.ceil(3.0 * sigma)))


def _band_blocks_np(size: int, sigmas: Sequence[float], bw: int, r: int):
    """(S, nb, bw + 2r, bw) band blocks of the blur matrices.

    Block jb holds B[jb*bw - r : jb*bw + bw + r, jb*bw : (jb+1)*bw] (rows
    clipped by zero padding) — every nonzero of column block jb, since
    B's band half-width is <= r. Pure NumPy: sigmas are static.

    ``size`` need not divide ``bw``: the matrix is zero-padded up to the
    block grid (zero rows/columns multiply the image's zero padding —
    exact, the round-4 generalization that lets KITTI-shaped 1241 x 376
    frames take this path).
    """
    import numpy as np

    nb = -(-size // bw)
    pad = nb * bw - size
    out = np.zeros((len(sigmas), nb, bw + 2 * r, bw), np.float32)
    for si, sigma in enumerate(sigmas):
        bp = np.pad(_blur_matrix_np(size, sigma), ((r, r + pad), (0, pad)))
        for jb in range(nb):
            out[si, jb] = bp[jb * bw : jb * bw + bw + 2 * r,
                             jb * bw : (jb + 1) * bw]
    return out


def blur_bank_banded(
    base: jax.Array,
    sigmas: Sequence[float],
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    bw: int = 64,
) -> jax.Array:
    """Blocked-BAND form of :func:`blur_bank`: skip the structural zeros.

    blur_matrix is banded — only the 2*ceil(3*sigma)+1 diagonals are
    nonzero (half-width 4..15 for the SIFT octave sigmas vs N = 512) —
    so the dense N x N x N matmuls spend ~70% of their flops
    multiplying zeros. Here each pass is a batched (N, bw + 2r) x
    (bw + 2r, bw) matmul per column block: identical terms, identical
    edge-clamped taps, just without the zero columns (equal to the dense
    form up to f32 summation order, ~2e-7 max abs at 512^2).

    bw=64 and the 512 dispatch cutoff in :func:`blur_bank` were tuned
    on the accelerator this engine was first built for; they have not
    been re-measured on the GPU. Reference analogue: the fused
    single-pass filter worker of GaussDePyramid-pThread.h:211-254 — this
    is its matmul form.

    Rectangular and non-64-multiple frames (round 4): the two passes
    are independent, so H != W just means independent row/col band
    -block banks, and each axis is zero-padded up to its block grid
    (zero image rows meet zero matrix columns — exact; at most 63 dead
    lanes per axis). KITTI-shaped 1241 x 376 frames take this path
    where round 3 silently fell back to dense (N, N) blur matrices
    (the reference's square-``len`` assumption,
    GuassDePyramid.h:106-134, generalized).
    """
    prec = precision
    dt = base.dtype
    h, w = base.shape[-2], base.shape[-1]
    s = len(sigmas)
    nbh, nbw = -(-h // bw), -(-w // bw)
    hp, wp = nbh * bw, nbw * bw
    r = max(_band_radius(sg) for sg in sigmas)
    blk_h = jnp.asarray(_band_blocks_np(h, sigmas, bw, r)).astype(dt)
    blk_w = (
        blk_h if w == h
        else jnp.asarray(_band_blocks_np(w, sigmas, bw, r)).astype(dt)
    )
    # Pass 1 (rows): tmp = B_h^T @ base. Output row block ib reads base
    # rows [ib*bw - r, ib*bw + bw + r); the zero row padding matches the
    # zero rows clipped off the band blocks. Reshape (s, nbh, bw, w) ->
    # (s, hp, w) is free (row blocks are contiguous).
    xpad = jnp.pad(base, ((r, r + (hp - h)), (0, 0)))
    win = jnp.stack(
        [xpad[ib * bw : ib * bw + bw + 2 * r] for ib in range(nbh)]
    )
    tmp = jnp.einsum(
        "sbhv,bhn->sbvn", blk_h, win,
        preferred_element_type=jnp.float32, precision=prec,
    ).astype(dt).reshape(s, hp, w)
    # Pass 2 (cols): out = tmp @ B_w, blocked over output column blocks.
    tpad = jnp.pad(tmp, ((0, 0), (0, 0), (r, r + (wp - w))))
    winc = jnp.stack(
        [tpad[:, :, jb * bw : jb * bw + bw + 2 * r] for jb in range(nbw)],
        axis=1,
    )
    out = jnp.einsum(
        "sbnh,sbhv->snbv", winc, blk_w,
        preferred_element_type=jnp.float32, precision=prec,
    )
    return out.reshape(s, hp, wp)[:, :h, :w].astype(dt)


# Banded dispatch cutoff: below 512 the band window (bw + 2r up to 94)
# stops being much narrower than the image. Rectangular frames take the
# banded path when the LONG axis clears the cutoff; non-multiple-of-64
# sizes are block-padded inside blur_bank_banded.
_BANDED_MIN_SIZE = 512


def blur_bank(
    base: jax.Array,
    sigmas: Sequence[float],
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """(H, W) base -> (len(sigmas), H, W): all blurs in two batched matmuls.

    out_s = B^H_s^T @ base @ B^W_s with B^D_s = blur_matrix(D, sigma_s).
    This is the matmul form of the reference's entire per-scale filter
    loop (GuassDePyramid.h:106-134 and every SIMD/thread variant of it):
    all scales of an octave in one batched product instead of 2*(S+3)
    separate elementwise passes.

    ``precision`` (see PyramidConfig.blur_precision):

    * HIGHEST (default): full-f32 blurs, the accuracy anchor the SfM and
      odometry gates are calibrated against.
    * lower precisions round the blur operands; the residual blur error
      is AMPLIFIED by the subpixel fit's second differences (DoG entries
      are O(1e-2), Hessians O(1e-3)), which inflates reprojection error
      and, at one-pass bf16/TF32 grade, injects spurious DoG extrema.
      Fine for detection-only throughput work; NOT for geometry.
    """
    prec = precision
    dt = base.dtype
    h, w = base.shape[-2], base.shape[-1]
    if max(h, w) >= _BANDED_MIN_SIZE:
        return blur_bank_banded(base, sigmas, precision=prec)
    bank = jnp.stack([blur_matrix(w, s) for s in sigmas]).astype(dt)
    if h != w:
        bank_h = jnp.stack([blur_matrix(h, s) for s in sigmas]).astype(dt)
        tmp = jnp.einsum(
            "hw,swv->shv", base, bank,
            preferred_element_type=jnp.float32, precision=prec,
        )
        return jnp.einsum(
            "shu,shv->suv", bank_h, tmp,
            preferred_element_type=jnp.float32, precision=prec,
        ).astype(dt)
    tmp = jnp.einsum(
        "hw,swv->shv", base, bank,
        preferred_element_type=jnp.float32, precision=prec,
    )
    # Row pass is B^T @ tmp (contract over B's ROW index): B is only
    # symmetric in the interior — edge clamping breaks symmetry, so using
    # B here instead of B^T corrupts the outermost rows. Inputs keep the
    # caller's dtype (bf16 halves the memory traffic); accumulation is
    # always f32.
    return jnp.einsum(
        "shu,shv->suv", bank, tmp,
        preferred_element_type=jnp.float32, precision=prec,
    ).astype(dt)


# SIFT-mode tail: octaves whose long side is at or below this run as ONE
# batched composite-operator einsum pair instead of the per-octave
# blur/subsample cascade (see _sift_tail_octaves). 64 matches the
# REFERENCE-mode tail threshold (small octaves cost launches, not
# compute).
_SIFT_TAIL_MAX = 64
_SIFT_TAIL_CACHE: dict = {}


def _sift_tail_mats_np(
    n: int, rel: tuple, sig_s: float, n_tail: int
):
    """(n_tail * n_scales, n, n) zero-padded per-axis operator stack.

    The blur/subsample cascade is LINEAR, so every tail plane is
    ``A^T x_t A`` with A a product of blur_matrix and even-row selection
    factors. The factors are composed in float64 here (f32 entries,
    exact f64 products), so the single f32-HIGHEST application has ONE
    rounding stage where the cascade had one per octave — within ~1e-7
    of the cascade, same operator. ``sig_s`` is the scale-S relative
    sigma the cascade blurs with before each subsample.
    """
    import numpy as np

    mats = []
    M = np.eye(n, dtype=np.float64)
    sz = n
    for o in range(n_tail):
        mats.append(M.copy())  # scale 0: the octave base itself
        for s_rel in rel:
            mats.append(M @ _blur_matrix_np(sz, s_rel).astype(np.float64))
        if o + 1 < n_tail:
            bs = _blur_matrix_np(sz, sig_s).astype(np.float64)
            nxt = -(-sz // 2)
            p = np.zeros((sz, nxt), np.float64)
            p[np.arange(nxt) * 2, np.arange(nxt)] = 1.0
            M = M @ bs @ p
            sz = nxt
    out = np.zeros((len(mats), n, n), np.float32)
    for i, m in enumerate(mats):
        out[i, :, : m.shape[1]] = m.astype(np.float32)
    return out


def _sift_tail_octaves(
    x: jax.Array,
    rel: Sequence[float],
    sig_s: float,
    n_tail: int,
    n_scales: int,
    precision,
    dtype,
) -> list[jax.Array]:
    """All remaining tail octaves from base ``x`` in one einsum pair.

    The <=64 cascade tail is a chain of tiny launches; this computes
    every tail plane directly from the tail base with precomposed
    operators (:func:`_sift_tail_mats_np`) — two batched matmuls total.
    """
    h, w = x.shape
    key = (h, w, tuple(rel), sig_s, n_tail)
    if key not in _SIFT_TAIL_CACHE:
        ah = _sift_tail_mats_np(h, tuple(rel), sig_s, n_tail)
        aw = (
            ah if w == h
            else _sift_tail_mats_np(w, tuple(rel), sig_s, n_tail)
        )
        _SIFT_TAIL_CACHE[key] = (ah, aw)
    ah_np, aw_np = _SIFT_TAIL_CACHE[key]
    ah = jnp.asarray(ah_np).astype(dtype)
    aw = ah if w == h else jnp.asarray(aw_np).astype(dtype)
    tmp = jnp.einsum(
        "hw,pwv->phv", x, aw,
        preferred_element_type=jnp.float32, precision=precision,
    )
    out = jnp.einsum(
        "phu,phv->puv", ah, tmp,
        preferred_element_type=jnp.float32, precision=precision,
    ).astype(dtype)
    octaves = []
    ho, wo = h, w
    for o in range(n_tail):
        octaves.append(out[o * n_scales : (o + 1) * n_scales, :ho, :wo])
        ho, wo = -(-ho // 2), -(-wo // 2)
    return octaves


def sift_gaussian_pyramid(img: jax.Array, cfg: PyramidConfig) -> list[jax.Array]:
    """True SIFT Gaussian pyramid: list of (S+3, H_o, W_o) per octave.

    Octave 0 scale 0 is the input brought up to sigma0 from the assumed blur;
    scales 1..S+2 are composed blurs of the octave base (equivalent to the
    Lowe 2004 cascade, parallelized — see _octave_scale_sigmas); octave o+1
    starts from octave o's scale-S image downsampled by 2. Unlike REFERENCE
    mode, octaves cascade instead of subsampling the original image.
    Octaves at or below _SIFT_TAIL_MAX are computed in one batched
    composite-operator pass (see _sift_tail_octaves).
    """
    x = img.astype(cfg.dtype)
    prec = cfg.blur_lax_precision
    base_sigma = math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
    # Base blur ALSO as a Toeplitz matmul (the same op as separable_blur,
    # batched with the octave's other blurs' form).
    x = blur_bank(x, [base_sigma], precision=prec)[0]
    rel = _octave_scale_sigmas(cfg)
    octaves = []
    n_oct = cfg.n_octaves
    for _o in range(n_oct):
        n_left = n_oct - _o
        if n_left > 1 and max(x.shape) <= _SIFT_TAIL_MAX:
            octaves.extend(
                _sift_tail_octaves(
                    x, rel, rel[cfg.S - 1], n_left, cfg.n_scales,
                    prec, cfg.dtype,
                )
            )
            break
        octave = jnp.concatenate(
            [x[None], blur_bank(x, rel, precision=prec)], axis=0
        )
        octaves.append(octave)
        # Next octave base: scale index S has absolute blur 2*sigma0.
        x = strided_subsample(octave[cfg.S], 2)
    return octaves


def sift_dog_pyramid(img: jax.Array, cfg: PyramidConfig) -> list[jax.Array]:
    """DoG pyramid for detection: list of (S+2, H_o, W_o) per octave."""
    return [g[1:] - g[:-1] for g in sift_gaussian_pyramid(img, cfg)]
