"""On-device DoG extrema detection (SIFT keypoint localization).

North-star extension (BASELINE.json config 2): the reference computes the
DoG pyramid and stops (SURVEY.md — no detection exists in
ZhangShuui/SIFT-parallel-optimization); this module consumes the SIFT-mode
pyramid of core/pyramid_ref.py and finds scale-space extrema with dense,
static-shape array programs:

* 3x3x3 extremum test as dense `lax.reduce_window` max/min pools + compare —
  no per-pixel branching;
* subpixel refinement (Brown & Lowe quadratic fit) computed DENSELY: the 3D
  gradient/Hessian are finite-difference stencils and the 3x3 solve is a
  closed-form adjugate — cheaper to do everywhere than to gather candidates;
* fixed-capacity extraction: score-masked `lax.top_k` over the flattened
  octave, unraveled back to (scale, y, x) — the static-shape substitute for
  dynamic compaction (SURVEY.md section 7 hard part (b)).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sift_parallel_optimization.config import PyramidConfig
from sift_parallel_optimization.models.keypoints import Keypoints

# Detection thresholds (standard SIFT values for images scaled to [0, 1]).
CONTRAST_THRESHOLD = 0.04
EDGE_RATIO = 10.0
MAX_REFINE_OFFSET = 0.6  # reject candidates whose quadratic fit moves further


def _window_extrema(dog: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(D, H, W) -> bool (D-2, H-2, W-2): strict 26-neighbor max / min.

    Separable shifted-slice max/min instead of `lax.reduce_window`:
    bitwise-identical booleans (max is associative; the window includes
    the center either way), but the slices are plain elementwise ops XLA
    fuses into the same pass as the quadratic-fit stencils, while each
    reduce_window lowers to its own volume pass.
    """
    def m3(x, axis, op):
        n = x.shape[axis]
        sl = lambda a, b: lax.slice_in_dim(x, a, b, axis=axis)
        return op(op(sl(0, n - 2), sl(1, n - 1)), sl(2, n))

    mx = dog
    mn = dog
    for axis in range(3):
        mx = m3(mx, axis, jnp.maximum)
        mn = m3(mn, axis, jnp.minimum)
    c = dog[1:-1, 1:-1, 1:-1]
    return c >= mx, c <= mn


def _grad_hess(dog: jax.Array):
    """Central differences at interior voxels of the TRAILING (D, H, W) axes.

    Returns g = (gs, gy, gx) and Hessian entries, each (..., D-2, H-2, W-2).
    :func:`_cube_fit` re-derives the same expressions sparsely for gathered
    candidate neighborhoods — keep the two in lockstep so sparse re-fits
    stay bitwise equal to the dense fields they replace.
    """
    c = dog[..., 1:-1, 1:-1, 1:-1]
    ds_p, ds_m = dog[..., 2:, 1:-1, 1:-1], dog[..., :-2, 1:-1, 1:-1]
    dy_p, dy_m = dog[..., 1:-1, 2:, 1:-1], dog[..., 1:-1, :-2, 1:-1]
    dx_p, dx_m = dog[..., 1:-1, 1:-1, 2:], dog[..., 1:-1, 1:-1, :-2]
    gs, gy, gx = (ds_p - ds_m) / 2, (dy_p - dy_m) / 2, (dx_p - dx_m) / 2
    hss = ds_p + ds_m - 2 * c
    hyy = dy_p + dy_m - 2 * c
    hxx = dx_p + dx_m - 2 * c
    hsy = (dog[..., 2:, 2:, 1:-1] - dog[..., 2:, :-2, 1:-1]
           - dog[..., :-2, 2:, 1:-1] + dog[..., :-2, :-2, 1:-1]) / 4
    hsx = (dog[..., 2:, 1:-1, 2:] - dog[..., 2:, 1:-1, :-2]
           - dog[..., :-2, 1:-1, 2:] + dog[..., :-2, 1:-1, :-2]) / 4
    hyx = (dog[..., 1:-1, 2:, 2:] - dog[..., 1:-1, 2:, :-2]
           - dog[..., 1:-1, :-2, 2:] + dog[..., 1:-1, :-2, :-2]) / 4
    return (gs, gy, gx), (hss, hyy, hxx, hsy, hsx, hyx)


def _edge_test(hyy, hxx, hyx, edge_ratio):
    """Lowe's 2D edge-response test on the spatial Hessian (shared by the
    dense ranking and the sparse re-fit so their booleans agree exactly)."""
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    return (det2 > 0) & (tr * tr * edge_ratio < (edge_ratio + 1) ** 2 * det2)


def _solve3(h, g):
    """Solve H @ off = -g for symmetric 3x3 H, densely, via adjugate.

    h = (hss, hyy, hxx, hsy, hsx, hyx); g = (gs, gy, gx). Returns
    (off_s, off_y, off_x, det).
    """
    a, d, f, b, c, e = h  # H = [[a,b,c],[b,d,e],[c,e,f]]
    gs, gy, gx = g
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    off_s = -(A * gs + B * gy + C * gx) * inv_det
    off_y = -(B * gs + D * gy + E * gx) * inv_det
    off_x = -(C * gs + E * gy + F * gx) * inv_det
    return off_s, off_y, off_x, det


def _dense_score(
    dog: jax.Array,
    cfg: PyramidConfig,
    contrast_threshold: float,
    edge_ratio: float,
    refine_iters: int,
    want_hops: bool = False,
) -> jax.Array:
    """Dense per-voxel ranking stage: (S+2, H, W) DoG -> (S, H-2, W-2) score.

    ``score`` is the top-k ranking key (0 where not a candidate). The
    quadratic-fit offsets computed here are FUSED INTERMEDIATES only —
    they feed the ranking contrast and are never materialized: writing
    the three dense offset fields plus the gate field and flat-gathering
    them moves four dense volumes where the sparse stage instead re-fits
    the K candidates from gathered 3x3x3 DoG cubes.

    ``want_hops`` (refine_iters >= 1 only) additionally returns the dense
    hop-PACKED int32 plane: each voxel's first refinement hop code
    (step_s+1)*9 + (step_y+1)*3 + (step_x+1) with per-axis step =
    clip(round(offset), -1, 1), or 13 (no hop) where all |offset| <=
    MAX_REFINE_OFFSET — exactly the decision the sparse stage's first
    re-fit round would make from a gathered cube (same expressions on the
    same f32 inputs; see _cube_fit's bitwise-equality contract) — packed
    into the low 5 mantissa bits of the score's order-preserving int32
    bit pattern (see the inline comment). Carrying this through the
    block-reduce extraction lets the sparse stage SKIP its first
    19-offset gather round entirely (the refinement hop is already
    known). The packed plane is a fused intermediate like the offsets;
    it never reaches device memory densely.
    """
    dog = dog.astype(jnp.float32)
    is_max, is_min = _window_extrema(dog)
    g, h = _grad_hess(dog)
    off_s, off_y, off_x, _det3 = _solve3(h, g)
    c = dog[1:-1, 1:-1, 1:-1]
    gs, gy, gx = g
    _hss, hyy, hxx, _hsy, _hsx, hyx = h
    edge_ok = _edge_test(hyy, hxx, hyx, edge_ratio)

    # Lowe/OpenCV convention: the usable threshold scales with the number
    # of intervals (DoG plane spacing shrinks as S grows).
    thr = contrast_threshold / cfg.S
    if refine_iters:
        # Rank WITHOUT the offset gate (failed fits get a chance to hop to
        # the right voxel); contrast for ranking uses offsets clamped to
        # the trust region so a near-singular Hessian cannot inflate it.
        d_rank = c + 0.5 * (
            gs * jnp.clip(off_s, -MAX_REFINE_OFFSET, MAX_REFINE_OFFSET)
            + gy * jnp.clip(off_y, -MAX_REFINE_OFFSET, MAX_REFINE_OFFSET)
            + gx * jnp.clip(off_x, -MAX_REFINE_OFFSET, MAX_REFINE_OFFSET)
        )
        good = (is_max | is_min) & (jnp.abs(d_rank) > thr) & edge_ok
        score = jnp.where(good, jnp.abs(d_rank), 0.0)
        if want_hops:
            conv = (
                (jnp.abs(off_s) <= MAX_REFINE_OFFSET)
                & (jnp.abs(off_y) <= MAX_REFINE_OFFSET)
                & (jnp.abs(off_x) <= MAX_REFINE_OFFSET)
            )
            st = lambda o: (
                jnp.clip(jnp.round(o), -1, 1).astype(jnp.int32) + 1
            )
            hop = jnp.where(
                conv, 13, st(off_s) * 9 + st(off_y) * 3 + st(off_x)
            )
            # Pack the hop into the score's 5 low mantissa bits: for
            # non-negative f32, the int32 bit pattern is order-preserving,
            # so the block-reduce ranks the packed int directly and the
            # fused producer feeds ONE operand. (With a separate hop
            # operand XLA duplicates the whole dense-fit chain into the
            # second reduce input.) Ranking is
            # quantized by 2^-18 relative — divergence only among scores
            # tied to 19 mantissa bits, already inside the approx-top-k
            # tolerance this branch runs under (recall gates apply).
            # score == 0 (non-candidate) must stay EXACTLY 0 so the
            # downstream vals > 0 validity gate cannot pass.
            bits = lax.bitcast_convert_type(score, jnp.int32)
            packed = jnp.where(score > 0, (bits & ~31) | hop, 0)
            return score, packed
        return score
    if want_hops:
        raise ValueError("want_hops requires refine_iters >= 1")
    # Refined contrast |D_hat| = |D + 1/2 g . offset|.
    d_hat = c + 0.5 * (gs * off_s + gy * off_y + gx * off_x)
    off_ok = (
        (jnp.abs(off_s) < MAX_REFINE_OFFSET)
        & (jnp.abs(off_y) < MAX_REFINE_OFFSET)
        & (jnp.abs(off_x) < MAX_REFINE_OFFSET)
    )
    good = (is_max | is_min) & (jnp.abs(d_hat) > thr) & edge_ok & off_ok
    return jnp.where(good, jnp.abs(d_hat), 0.0)


# The 19 voxels of a 3x3x3 neighborhood the quadratic fit actually reads
# (center, 6 faces, 12 edges — the 8 corners appear in no stencil), as
# (ds, dy, dx) offsets from the cube corner. Fetching 19 instead of 27
# elements saves ~30% of each refinement round's element gather.
_FIT_OFFSETS = tuple(
    (ds, dy, dx)
    for ds in range(3) for dy in range(3) for dx in range(3)
    if (ds != 1) + (dy != 1) + (dx != 1) <= 2
)
_FIT_DS, _FIT_DY, _FIT_DX = [
    jnp.asarray([o[i] for o in _FIT_OFFSETS], jnp.int32) for i in range(3)
]


def _cube_fit(vals19: jax.Array, edge_ratio: float):
    """Sparse Brown & Lowe re-fit on gathered (..., 19) DoG neighborhoods
    (laid out per :data:`_FIT_OFFSETS`).

    Same expressions as the dense ranking stage's :func:`_grad_hess` /
    :func:`_solve3` / :func:`_edge_test` (same ops in the same order on
    the same f32 inputs), so the values are bitwise equal to the dense
    fields they replace. Returns ``(off_s, off_y, off_x, d_hat, edge_ok)``,
    each shaped like the leading dims.
    """
    v = {off: vals19[..., i] for i, off in enumerate(_FIT_OFFSETS)}
    c = v[1, 1, 1]
    ds_p, ds_m = v[2, 1, 1], v[0, 1, 1]
    dy_p, dy_m = v[1, 2, 1], v[1, 0, 1]
    dx_p, dx_m = v[1, 1, 2], v[1, 1, 0]
    gs, gy, gx = (ds_p - ds_m) / 2, (dy_p - dy_m) / 2, (dx_p - dx_m) / 2
    hss = ds_p + ds_m - 2 * c
    hyy = dy_p + dy_m - 2 * c
    hxx = dx_p + dx_m - 2 * c
    hsy = (v[2, 2, 1] - v[2, 0, 1] - v[0, 2, 1] + v[0, 0, 1]) / 4
    hsx = (v[2, 1, 2] - v[2, 1, 0] - v[0, 1, 2] + v[0, 1, 0]) / 4
    hyx = (v[1, 2, 2] - v[1, 2, 0] - v[1, 0, 2] + v[1, 0, 0]) / 4
    g = (gs, gy, gx)
    h = (hss, hyy, hxx, hsy, hsx, hyx)
    off_s, off_y, off_x, _det3 = _solve3(h, g)
    d_hat = c + 0.5 * (gs * off_s + gy * off_y + gx * off_x)
    edge_ok = _edge_test(hyy, hxx, hyx, edge_ratio)
    return off_s, off_y, off_x, d_hat, edge_ok


def _block_top2(rows: jax.Array):
    """(N, B) non-negative scores -> per-row (max, argmax, 2nd max,
    2nd argmax), as ONE variadic lax.reduce over the block axis.

    The combiner is the associative AND commutative top-2 tournament
    merge — value ties break toward the smaller index, because XLA's
    reduce documents guaranteed results only for commutative combiners
    (a keep-the-left rule is only defined under in-order reduction and
    a backend may reorder operands). XLA fuses the whole table
    construction into the score producer; matches max/argmax +
    mask-the-argmax/re-reduce exactly (first-index ties).

    ``rows`` may be f32 scores OR the hop-packed non-negative int32 of
    :func:`_dense_score` (for non-negative f32 the bit pattern is
    order-preserving, so integer compares rank identically); the
    combiner is dtype-generic. Only the lane iota feeds the reduce
    besides ``rows`` itself, so the (expensive) score producer is fused
    into exactly one operand.
    """
    lane = jnp.broadcast_to(
        jnp.arange(rows.shape[1], dtype=jnp.int32)[None, :], rows.shape
    )
    zf = jnp.zeros_like(rows)
    zi = jnp.zeros_like(lane)

    def comb(a, b):
        m1a, a1a, m2a, a2a = a
        m1b, a1b, m2b, a2b = b
        swap = (m1b > m1a) | ((m1b == m1a) & (a1b < a1a))
        first = jnp.where(swap, m1b, m1a)
        fidx = jnp.where(swap, a1b, a1a)
        lose_v = jnp.where(swap, m1a, m1b)
        lose_i = jnp.where(swap, a1a, a1b)
        win2_v = jnp.where(swap, m2b, m2a)
        win2_i = jnp.where(swap, a2b, a2a)
        s_swap = (lose_v > win2_v) | (
            (lose_v == win2_v) & (lose_i < win2_i)
        )
        second = jnp.where(s_swap, lose_v, win2_v)
        sidx = jnp.where(s_swap, lose_i, win2_i)
        return first, fidx, second, sidx

    z = jnp.zeros((), rows.dtype)
    return lax.reduce(
        (rows, lane, zf, zi), (z, jnp.int32(0), z, jnp.int32(0)),
        comb, (1,),
    )


def detect_octave_groups(
    groups: list[list[tuple[int, jax.Array]]],
    cfg: PyramidConfig,
    capacity: int,
    **thresholds,
) -> Keypoints:
    """Detect over a whole pyramid in ONE fused program -> ``capacity``
    keypoint slots SHARED across all octaves (global top-k by ranking
    score).

    ``groups`` is a list of octave groups, each group a list of
    ``(octave_id, dog)`` pairs with ``dog`` shaped (S+2, H, W). Thin B=1
    wrapper over :func:`detect_octave_groups_batched` — see there for the
    design rationale (grouping, flat top-k, scalar gathers).
    """
    kp = detect_octave_groups_batched(
        [[(o, d[None]) for o, d in grp] for grp in groups],
        cfg, capacity, **thresholds,
    )
    return jax.tree.map(lambda x: x[0], kp)


def detect_octave_groups_batched(
    groups: list[list[tuple[int, jax.Array]]],
    cfg: PyramidConfig,
    capacity: int,
    contrast_threshold: float = CONTRAST_THRESHOLD,
    edge_ratio: float = EDGE_RATIO,
    refine_iters: int = 1,
    use_approx_topk: bool = True,
    adaptive_hop: bool = False,
) -> Keypoints:
    """Detect over B frames' pyramids in ONE fused program -> (B, capacity)
    keypoint slots, each frame's slots shared across its octaves (global
    per-frame top-k by ranking score).

    The production batched frontend (parallel/frontend.py) unrolls
    detection per frame, which measured faster than this batch-aware
    form on the accelerator the engine was first built for (the batched
    stage boundaries cost relayout copies the per-frame program never
    needs). With B=1 this is the per-frame path (:func:`detect_pyramid`);
    B>1 has not been re-measured on the GPU.

    ``groups`` is a list of octave groups, each group a list of
    ``(octave_id, dog)`` pairs with ``dog`` shaped (B, S+2, H, W). Octaves
    within a group are zero-padded to a common canvas and their dense
    stage is vmapped (over frames x group members); groups exist so that
    LARGE octaves (where dense work dominates) keep their native size
    while the small tail shares one canvas.

    Why this shape: a per-octave detect call has a fixed overhead of
    kernel launches, top-k and sparse gathers regardless of octave size,
    and the small tail octaves are almost no compute. This design pays
    the dense stencils per GROUP (trivial FLOPs) and the sparse stage
    exactly once for the whole frame BATCH.

    The shared capacity is not a quality loss vs per-octave capacities:
    the final selection is a top-k over all octaves with the same ranking
    key either way, so any candidate dropped here has >= ``capacity``
    better candidates and could never appear in the final set.

    Batching rules (this function exists because `vmap` over the serial
    path violates them):

    * top-k is a flat 1-D selection per frame, UNROLLED over the
      (static) batch, each call a contiguous row slice of the (B, V)
      score table.
    * the dense stage outputs ONLY the ranking score. Candidate offsets
      and gates are re-fit SPARSELY from gathered (3, 3, 3) DoG cubes —
      ONE flat 19-offset gather per refinement round serves all frames,
      groups, and cube positions (see ``fit_at``), instead of writing
      dense offset/gate fields and gathering from them.

    Correctness under padding: candidate voxels are masked to each
    octave's true interior BEFORE top-k, so a padded voxel can never rank;
    refinement hops clip to per-octave interior limits, so a hop can never
    land in a padded voxel either (a cube at interior (s, y, x) reads
    dog[s:s+3, y:y+3, x:x+3], inside the true region whenever y <= h-3).
    With exact top-k and fewer than ``capacity`` total candidates this
    selects exactly the union of the per-octave valid sets (tested in
    tests/test_sift_frontend.py).
    """
    assert groups and all(groups)
    b = groups[0][0][1].shape[0]
    ds2 = groups[0][0][1].shape[1]
    # Dense-hop carry (see _dense_score): with the block-reduce
    # extraction the first refinement hop of every candidate is decided
    # by the DENSE pass and rides the top-2 tables, so the sparse stage
    # starts directly at the hopped voxel — one 19-offset gather round
    # removed, bitwise-identical keypoints.
    use_hops = bool(use_approx_topk) and refine_iters >= 1
    seg_score = []
    seg_hop = []
    seg_base = []  # per group: flat score base of its first octave
    stacks = []  # per group: (B*n_g, S+2, hp, wp) DoG stack
    # Per-octave metadata (numpy, static): in-frame flat base offset,
    # padded dims for unravel, true interior limits for hop clipping,
    # octave id, flat start of the owning group's DoG segment, the group's
    # member count, and this octave's row within its stack.
    m_base, m_hs, m_ws, m_ly, m_lx, m_oct = [], [], [], [], [], []
    m_gstart, m_ng, m_row = [], [], []
    base = 0
    gstart = 0
    ds = None
    for gi, grp in enumerate(groups):
        assert all(d.shape[:2] == (b, ds2) for _, d in grp), \
            "octaves must share batch and S"
        hp = max(d.shape[2] for _, d in grp)
        wp = max(d.shape[3] for _, d in grp)
        # (B, n_g, S+2, hp, wp): frame-major so per-frame flattening below
        # is a plain reshape.
        stack = jnp.stack([
            jnp.pad(
                d, ((0, 0), (0, 0), (0, hp - d.shape[2]), (0, wp - d.shape[3]))
            )
            for _, d in grp
        ], axis=1)
        n_g = len(grp)
        stack4 = stack.reshape(b * n_g, ds2, hp, wp).astype(jnp.float32)
        hopc = None
        if use_hops:
            score, hopc = jax.vmap(
                lambda d: _dense_score(
                    d, cfg, contrast_threshold, edge_ratio, refine_iters,
                    want_hops=True,
                )
            )(stack4)
        else:
            score = jax.vmap(
                lambda d: _dense_score(
                    d, cfg, contrast_threshold, edge_ratio, refine_iters
                )
            )(stack4)
        ds, hs, ws = score.shape[1:]
        shp5 = (b, n_g, ds, hs, ws)
        score = score.reshape(shp5)
        if hopc is not None:
            hopc = hopc.reshape(shp5)
        if any(d.shape != grp[0][1].shape for _, d in grp):
            # Mask padded voxels out of the candidate set. True interior
            # rows of an (s2, h, w) octave are [0, h-3] in interior coords.
            h_real = np.array([d.shape[2] for _, d in grp], np.int32)
            w_real = np.array([d.shape[3] for _, d in grp], np.int32)
            iy = lax.broadcasted_iota(jnp.int32, shp5, 3)
            ix = lax.broadcasted_iota(jnp.int32, shp5, 4)
            inb = (iy < jnp.asarray(h_real)[None, :, None, None, None] - 2) & (
                ix < jnp.asarray(w_real)[None, :, None, None, None] - 2
            )
            score = jnp.where(inb, score, 0.0)
            if hopc is not None:
                hopc = jnp.where(inb, hopc, 0)
        if hopc is not None:
            seg_hop.append(hopc.reshape(b, -1))
        v = ds * hs * ws
        seg_base.append(base)
        for j, (o, d) in enumerate(grp):
            m_base.append(base + j * v)
            m_hs.append(hs)
            m_ws.append(ws)
            m_ly.append(d.shape[2] - 3)
            m_lx.append(d.shape[3] - 3)
            m_oct.append(o)
            m_gstart.append(gstart)
            m_ng.append(n_g)
            m_row.append(j)
        base += n_g * v
        gstart += stack4.size
        stacks.append(stack4)
        seg_score.append(score.reshape(b, -1))

    n_total = base

    # Static-shape extraction, two selection modes per frame (both loops
    # unrolled — B and the grouping are static):
    #
    # * approx (the default): per-group BLOCK-REDUCE — reshape the flat
    #   score to (V_g / BLK, BLK) rows and keep each row's TOP-2. The
    #   reductions FUSE into the score producer (no dense score volume
    #   is written), and one small top-k over the concatenated
    #   (sum V_g / BLK,) tables selects the winners. Top-2, not top-1:
    #   SIFT candidates CLUSTER (blob edges yield extrema 2-3 voxels
    #   apart in one row), and top-1 tables measurably broke downstream
    #   odometry after single-frame recall checks had passed. Top-2 needs
    #   THREE global-top-k candidates in one 64-voxel block to lose one.
    #   On an H100 at 512^2 / K=512 this path and the exact one select
    #   the same keypoints and it runs the frontend in 0.89 ms against
    #   1.13 ms (PERF.md). Recall is gated at >= 0.95 by the suite
    #   (tests/test_sift_frontend.py) and at >= 0.99 on the card
    #   (chip_smoke.py); the odometry revisit gate guards the downstream
    #   effect.
    # * exact: flat top-k per group + exact merge — any global winner is
    #   inside its group's top-k, and ties resolve by flat index in both
    #   forms (group-major concat order == flat score order), so this
    #   selects exactly the union of per-octave sets.
    k = min(capacity, n_total)
    blk = 64
    vals_l, idx_l = [], []
    for bi in range(b):
        parts_v, parts_i = [], []
        for sg, (sc, g_base) in enumerate(zip(seg_score, seg_base)):
            row = sc[bi] if b > 1 else sc.reshape(-1)    # sc: (B, V_g)
            if use_hops:
                sh = seg_hop[sg]
                hrow = sh[bi] if b > 1 else sh.reshape(-1)
            vg = row.shape[0]
            if use_approx_topk and vg >= 4096:
                pad = (-vg) % blk
                # Top-2 per block (see design comment above) as ONE
                # variadic lax.reduce — a two-pass mask-the-argmax form
                # has a cross-pass data dependency that stops XLA fusing
                # the block table into the score producer. With hop
                # codes, the reduce runs
                # on the hop-PACKED int32 (order-preserving bitcast of
                # the f32 score — see _dense_score) so the producer
                # still feeds one operand; values and hops unpack from
                # the small tables afterwards.
                if use_hops:
                    # The table stays hop-PACKED int32 (order-preserving
                    # bitcast of the f32 score, see _dense_score) all
                    # the way through the final top-k: one decode of K
                    # entries at the end instead of per-octave
                    # unpack/bitcast passes (tiny arrays, but each was
                    # its own ~1-us launch).
                    prows = (jnp.pad(hrow, (0, pad)) if pad
                             else hrow).reshape(-1, blk)
                    tv1, ta1, tv2, ta2 = _block_top2(prows)
                else:
                    rows = (jnp.pad(row, (0, pad)) if pad else row)
                    rows = rows.reshape(-1, blk)
                    tv1, ta1, tv2, ta2 = _block_top2(rows)
                rbase = jnp.arange(
                    (vg + pad) // blk, dtype=jnp.int32
                ) * blk
                # Padded entries carry score 0 (never valid), but clamp
                # their index inside the group so downstream octave/coord
                # math cannot read out of range.
                parts_v.append(jnp.concatenate([tv1, tv2]))
                parts_i.append(
                    g_base + jnp.minimum(
                        jnp.concatenate([rbase + ta1, rbase + ta2]),
                        vg - 1,
                    )
                )
            else:
                kg = min(k, vg)
                v_g, i_g = lax.top_k(row, kg)
                parts_i.append(i_g + g_base)
                # In hop mode the packed int (same ranking) joins the
                # packed tables; otherwise the f32 score does.
                parts_v.append(hrow[i_g] if use_hops else v_g)
        if len(parts_v) == 1 and parts_v[0].shape[0] == k:
            v_b, i_b = parts_v[0], parts_i[0]
        else:
            cv = jnp.concatenate(parts_v) if len(parts_v) > 1 else parts_v[0]
            ci = jnp.concatenate(parts_i) if len(parts_i) > 1 else parts_i[0]
            if cv.shape[0] < k:  # tiny pyramid under block reduction
                cv = jnp.pad(cv, (0, k - cv.shape[0]))
                ci = jnp.pad(ci, (0, k - ci.shape[0]))
            if use_approx_topk and cv.shape[0] >= 8 * k:
                # The table selection itself. approx_max_k is exact on
                # backends without an approximate top-k unit (XLA lowers
                # it to a sort, as on the GPU); where it is approximate,
                # what it can miss is the tail of the score RANKING near
                # the capacity cut, not spatial structure. Packed-int
                # tables rank through a bitcast: non-negative int32
                # patterns order identically as f32 (no NaN aliases —
                # score exponents are far below the NaN band).
                rank = (
                    lax.bitcast_convert_type(cv, jnp.float32)
                    if use_hops else cv
                )
                v_b, sel = lax.approx_max_k(rank, k, recall_target=0.99)
                if use_hops:
                    v_b = cv[sel]
            else:
                v_b, sel = lax.top_k(cv, k)
            i_b = ci[sel]
        vals_l.append(v_b)
        idx_l.append(i_b)
    vals = jnp.stack(vals_l)                       # (B, K)
    idx = jnp.stack(idx_l)
    if k < capacity:  # tiny pyramid: pad up to capacity
        vals = jnp.pad(vals, ((0, 0), (0, capacity - k)))
        idx = jnp.pad(idx, ((0, 0), (0, capacity - k)))
    hops = None
    if use_hops:
        # One decode of the (B, K) winners: hop code from the low 5
        # bits, the f32 score from the masked bit pattern (packed 0 ->
        # score 0.0, so invalid slots stay invalid).
        hops = vals & 31
        vals = lax.bitcast_convert_type(vals & ~31, jnp.float32)

    # Per-candidate octave + in-octave voxel coords from the flat index.
    # All (B, K); gathers on tiny (n_oct,) tables flatten to 1-D form.
    n_oct = len(m_base)
    flat_take = lambda src, i: src[i.reshape(-1)].reshape(i.shape)
    if n_oct == 1:
        hs_c, ws_c = m_hs[0], m_ws[0]
        base_c = 0
        lim_y, lim_x = m_ly[0], m_lx[0]
        gstart_c, ng_c, row_c = 0, 1, 0
        rem = idx
    else:
        # Octave of each candidate: segment bases are sorted ascending, so
        # count how many bases the index has passed (tiny (B, K, n_oct)
        # compare — cheaper than any gather-based search). All nine
        # per-octave metadata columns come back in ONE packed gather
        # (kept for the smaller graph).
        bases = jnp.asarray(np.asarray(m_base, np.int32))
        j_i = jnp.sum(idx[..., None] >= bases[None, None, :], axis=-1) - 1
        packed = jnp.asarray(
            np.stack(
                [m_base, m_hs, m_ws, m_ly, m_lx, m_gstart, m_ng, m_row,
                 m_oct],
                axis=1,
            ).astype(np.int32)
        )  # (n_oct, 9)
        cols = flat_take(
            packed.reshape(-1),
            j_i[..., None] * 9 + jnp.arange(9, dtype=jnp.int32),
        )  # (B, K, 9)
        base_c = cols[..., 0]
        hs_c, ws_c = cols[..., 1], cols[..., 2]
        lim_y, lim_x = cols[..., 3], cols[..., 4]
        gstart_c, ng_c, row_c = cols[..., 5], cols[..., 6], cols[..., 7]
        oct_c = cols[..., 8]
        rem = idx - base_c
    s_i = rem // (hs_c * ws_c)
    y_i = (rem // ws_c) % hs_c
    x_i = rem % ws_c
    frame_i = jnp.arange(b, dtype=jnp.int32)[:, None]

    # One frame-major flat copy of every group's DoG stack — the ONLY
    # layout cost of the sparse stage (the linear write fuses with the DoG
    # subtraction / padding producers; a (1, 3, 3, 3)-slice `lax.gather`
    # from the native 4-D stacks, or per-field dense-offset gathers, both
    # relayout data this flat copy never touches). A candidate's fit
    # neighborhood
    # is 19 scalar offsets around its voxel (_FIT_OFFSETS); ONE flat
    # gather per refinement round serves all frames, groups, and
    # positions.
    flat_dog = (stacks[0].reshape(-1) if len(stacks) == 1 else
                jnp.concatenate([s4.reshape(-1) for s4 in stacks]))
    wp_c = ws_c + 2                                  # padded canvas strides
    sp_c = (hs_c + 2) * wp_c
    if n_oct == 1:                                   # strides are static ints
        deltas = _FIT_DS * sp_c + _FIT_DY * wp_c + _FIT_DX           # (19,)
    else:
        deltas = (_FIT_DS * sp_c[..., None] + _FIT_DY * wp_c[..., None]
                  + _FIT_DX)                                     # (B, K, 19)

    def fit_at(ps, py, px):
        """Re-fit all (B, K) candidates at voxel (ps, py, px): one flat
        19-offset gather for the whole batch, then the shared sparse
        Brown & Lowe expressions."""
        corner = (gstart_c + (frame_i * ng_c + row_c) * (ds2 * sp_c)
                  + ps * sp_c + py * wp_c + px)
        pos = corner[..., None] + deltas             # (B, K, 19)
        nbhd = flat_take(flat_dog, pos)
        return _cube_fit(nbhd, edge_ratio)

    if use_hops:
        # First refinement hop decoded from the dense hop codes carried
        # through extraction — the first fit round's only output used
        # here was this decision, so its gather round is skipped. A
        # no-hop code (13) decodes to steps (0, 0, 0): clip(p + 0) == p
        # for in-range p, matching the gathered round's jnp.where(conv,
        # p, ...) bitwise.
        ps = jnp.clip(s_i + (hops // 9 - 1), 0, ds - 1)
        py = jnp.clip(y_i + ((hops // 3) % 3 - 1), 0, lim_y)
        px = jnp.clip(x_i + (hops % 3 - 1), 0, lim_x)
        os_, oy, ox, dh, eok = fit_at(ps, py, px)
        rounds_left = refine_iters - 1
    else:
        os_, oy, ox, dh, eok = fit_at(s_i, y_i, x_i)
        ps, py, px = s_i, y_i, x_i
        rounds_left = refine_iters
    if refine_iters:
        # Sparse neighbor-hop refinement on the candidates: re-fit the
        # quadratic at each candidate's voxel from its gathered DoG cube,
        # hop one voxel toward the fit when it escapes the trust region,
        # re-fit, repeat. One hop recovers essentially all the benefit:
        # over 4 synthetic frames, refine=1 matched refine=3 on 3/4
        # frames and was one keypoint short on the 4th — hence the
        # default of 1.

        def hop(p, o, lim, conv):
            step = jnp.clip(jnp.round(o), -1, 1).astype(jnp.int32)
            return jnp.where(conv, p, jnp.clip(p + step, 0, lim))

        for _ in range(rounds_left):
            conv = (
                (jnp.abs(os_) <= MAX_REFINE_OFFSET)
                & (jnp.abs(oy) <= MAX_REFINE_OFFSET)
                & (jnp.abs(ox) <= MAX_REFINE_OFFSET)
            )
            ps = hop(ps, os_, ds - 1, conv)
            py = hop(py, oy, lim_y, conv)
            px = hop(px, ox, lim_x, conv)
            os_, oy, ox, dh, eok = fit_at(ps, py, px)
        if adaptive_hop:
            # CONDITIONAL extra refit round (OPT-IN): candidates whose
            # last fit still escapes the trust region would be DROPPED
            # by the off_ok_f gate below; one more hop+refit recovers
            # them, converged candidates keep their results bitwise via
            # the where-select. Random-noise frames trigger the cond on
            # nearly every frame (weak candidates escape constantly),
            # so it costs a refit round per frame; default False.

            def _again(a):
                ps, py, px, os_, oy, ox, dh, eok = a
                # Zero-score slots count as converged: refitting them
                # would perturb unmasked fields (e.g. scale) and break
                # batched == per-frame equality when another frame's
                # escapes trigger the shared cond.
                conv = (
                    (jnp.abs(os_) <= MAX_REFINE_OFFSET)
                    & (jnp.abs(oy) <= MAX_REFINE_OFFSET)
                    & (jnp.abs(ox) <= MAX_REFINE_OFFSET)
                ) | (vals <= 0)
                ps2 = hop(ps, os_, ds - 1, conv)
                py2 = hop(py, oy, lim_y, conv)
                px2 = hop(px, ox, lim_x, conv)
                os2, oy2, ox2, dh2, eok2 = fit_at(ps2, py2, px2)

                def sel(new, old):
                    return jnp.where(conv, old, new)

                return (
                    sel(ps2, ps), sel(py2, py), sel(px2, px),
                    sel(os2, os_), sel(oy2, oy), sel(ox2, ox),
                    sel(dh2, dh), sel(eok2, eok),
                )

            esc = (
                (jnp.abs(os_) > MAX_REFINE_OFFSET)
                | (jnp.abs(oy) > MAX_REFINE_OFFSET)
                | (jnp.abs(ox) > MAX_REFINE_OFFSET)
            )
            args = (ps, py, px, os_, oy, ox, dh, eok)
            ps, py, px, os_, oy, ox, dh, eok = lax.cond(
                jnp.any(esc & (vals > 0)), _again, lambda a: a, args
            )
        fs, fy, fx = os_, oy, ox
        s_i, y_i, x_i = ps, py, px
        off_ok_f = (
            (jnp.abs(fs) < MAX_REFINE_OFFSET)
            & (jnp.abs(fy) < MAX_REFINE_OFFSET)
            & (jnp.abs(fx) < MAX_REFINE_OFFSET)
        )
        thr = contrast_threshold / cfg.S
        valid = (vals > 0) & off_ok_f & eok & (jnp.abs(dh) > thr)
        vals = jnp.where(valid, jnp.abs(dh), 0.0)
    else:
        fs, fy, fx = os_, oy, ox
        valid = vals > 0

    # +1: interior offset from the VALID window; coords in octave pixels.
    x_o = x_i.astype(jnp.float32) + 1.0 + fx
    y_o = y_i.astype(jnp.float32) + 1.0 + fy
    s_o = s_i.astype(jnp.float32) + 1.0 + fs  # DoG plane index (1..S)

    if n_oct == 1:
        oct_ids = jnp.full_like(s_i, m_oct[0])
        scale_mult = float(2 ** m_oct[0])
    else:
        oct_ids = oct_c  # from the packed metadata gather
        scale_mult = jnp.exp2(oct_ids.astype(jnp.float32))
    sigma = cfg.sigma0 * jnp.exp2(s_o / cfg.S) * scale_mult
    return Keypoints(
        x=jnp.where(valid, x_o * scale_mult, 0.0),
        y=jnp.where(valid, y_o * scale_mult, 0.0),
        sigma=jnp.where(valid, sigma, 0.0),
        score=vals,
        orientation=jnp.zeros_like(vals),
        octave=jnp.asarray(oct_ids),
        scale=(s_i + 1).astype(jnp.int32),
        valid=valid,
    )


def detect_octaves_batched(
    dogs: list[jax.Array],
    octaves: list[int],
    cfg: PyramidConfig,
    capacity: int,
    **thresholds,
) -> Keypoints:
    """Detect over B same-group octaves -> ``capacity`` shared slots.

    Thin wrapper over :func:`detect_octave_groups` with all octaves in one
    padded group.
    """
    return detect_octave_groups(
        [list(zip(octaves, dogs))], cfg, capacity, **thresholds
    )


def detect_octave(
    dog: jax.Array,
    octave: int,
    cfg: PyramidConfig,
    capacity: int,
    contrast_threshold: float = CONTRAST_THRESHOLD,
    edge_ratio: float = EDGE_RATIO,
    refine_iters: int = 1,
) -> Keypoints:
    """(S+2, H, W) DoG stack of one octave -> Keypoints with ``capacity`` slots.

    Coordinates/sigma are returned in ORIGINAL image units (scaled by 2^octave).

    ``refine_iters`` > 0 enables iterative subpixel refinement (Brown &
    Lowe / OpenCV): a candidate whose quadratic fit lands further than
    MAX_REFINE_OFFSET from its voxel is re-fit at the neighbor voxel the
    fit points to, up to ``refine_iters`` hops — recovering the ~7% of
    true keypoints the single-shot offset gate rejects. The hops are
    SPARSE (per-candidate 3x3x3 DoG cube gathers + re-fit for just the
    top-k candidates), so the dense stencil work is unchanged.
    """
    return detect_octaves_batched(
        [dog], [octave], cfg, capacity,
        contrast_threshold=contrast_threshold,
        edge_ratio=edge_ratio,
        refine_iters=refine_iters,
    )


def detect_pyramid(
    dogs: list[jax.Array],
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    tail_batch_side: int | None = None,
    **thresholds,
) -> Keypoints:
    """Full-pyramid detection -> ``max_keypoints`` slots across all octaves.

    One fused :func:`detect_octave_groups` call with every octave at its
    NATIVE size (one group per octave); a single global top-k replaces
    both the per-octave extraction and the final cross-octave selection.

    ``tail_batch_side``: octaves whose longest side is <= this share one
    zero-padded canvas group (an earlier design, kept as a study knob).
    With the block-reduce extraction the per-group cost is a fused
    reduction, and the padded canvas only ADDS stencil work + flat-copy
    bytes (the padded flat DoG copy is ~2x the native one at 512^2).
    """
    big = [
        (o, d) for o, d in enumerate(dogs)
        if tail_batch_side is None
        or max(d.shape[1], d.shape[2]) > tail_batch_side
    ]
    tail = [
        (o, d) for o, d in enumerate(dogs)
        if tail_batch_side is not None
        and max(d.shape[1], d.shape[2]) <= tail_batch_side
    ]
    groups = [[p] for p in big] + ([tail] if tail else [])
    return detect_octave_groups(groups, cfg, max_keypoints, **thresholds)


def detect_pyramid_batched(
    dogs: list[jax.Array],
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    tail_batch_side: int | None = None,
    **thresholds,
) -> Keypoints:
    """Frame-batched full-pyramid detection.

    ``dogs`` holds one (B, S+2, H_o, W_o) array per octave; returns
    Keypoints with a leading (B,) axis and ``max_keypoints`` slots per
    frame. Same grouping policy as :func:`detect_pyramid` (native
    per-octave groups; ``tail_batch_side`` re-enables the padded tail
    canvas); the sparse stage (top-k, gathers) is batch-aware instead of
    vmapped — see :func:`detect_octave_groups_batched` for why vmap
    loses here.
    """
    big = [
        (o, d) for o, d in enumerate(dogs)
        if tail_batch_side is None
        or max(d.shape[2], d.shape[3]) > tail_batch_side
    ]
    tail = [
        (o, d) for o, d in enumerate(dogs)
        if tail_batch_side is not None
        and max(d.shape[2], d.shape[3]) <= tail_batch_side
    ]
    groups = [[p] for p in big] + ([tail] if tail else [])
    return detect_octave_groups_batched(
        groups, cfg, max_keypoints, **thresholds
    )
