"""The descriptor stage's patch gather against plain NumPy slicing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.models import descriptor as D
from sift_parallel_optimization.models.descriptor import extract_atlas_patches


def _np_gather(atlas, ys, xs, rows, cols):
    """dynamic_slice semantics for non-negative origins (the descriptor
    stage clips them at 0): an origin past the end is clamped so the
    patch ends at the atlas edge."""
    r, c = atlas.shape
    out = []
    for y, x in zip(ys, xs):
        y = min(max(int(y), 0), r - rows)
        x = min(max(int(x), 0), c - cols)
        out.append(atlas[y:y + rows, x:x + cols])
    return np.stack(out)


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("rows,cols", [(96, 256), (112, 256), (24, 128)])
def test_gather_matches_numpy(k, rows, cols):
    rng = np.random.default_rng(k + rows)
    atlas = rng.random((300, 640)).astype(np.float32)
    ys = rng.integers(0, 300 - rows + 1, k).astype(np.int32)
    xs = (rng.integers(0, (640 - cols) // 128 + 1, k) * 128).astype(np.int32)
    out = extract_atlas_patches(jnp.asarray(atlas), jnp.asarray(ys),
                                jnp.asarray(xs), rows, cols)
    assert out.shape == (k, rows, cols)
    np.testing.assert_array_equal(
        np.asarray(out), _np_gather(atlas, ys, xs, rows, cols)
    )


def test_gather_clamps_out_of_range_origins():
    rng = np.random.default_rng(0)
    atlas = rng.random((200, 384)).astype(np.float32)
    rows, cols = 96, 256
    ys = np.array([0, 104, 105, 150, 10_000], np.int32)
    xs = np.array([0, 128, 129, 300, 10_000], np.int32)
    out = jax.jit(
        lambda a, y, x: extract_atlas_patches(a, y, x, rows, cols)
    )(jnp.asarray(atlas), jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_array_equal(
        np.asarray(out), _np_gather(atlas, ys, xs, rows, cols)
    )


def test_gather_vmapped_over_frames():
    """The batched frontend vmaps the gather over (atlas, offsets)."""
    rng = np.random.default_rng(1)
    b, k, rows, cols = 3, 5, 96, 256
    atlases = rng.random((b, 256, 512)).astype(np.float32)
    ys = rng.integers(0, 256 - rows + 1, (b, k)).astype(np.int32)
    xs = (rng.integers(0, 3, (b, k)) * 128).astype(np.int32)
    out = jax.vmap(
        lambda a, y, x: extract_atlas_patches(a, y, x, rows, cols)
    )(jnp.asarray(atlases), jnp.asarray(ys), jnp.asarray(xs))
    assert out.shape == (b, k, rows, cols)
    for i in range(b):
        np.testing.assert_array_equal(
            np.asarray(out[i]),
            _np_gather(atlases[i], ys[i], xs[i], rows, cols),
        )


def test_gather_on_real_atlas_geometry():
    """Offsets computed the way the descriptor stage computes them, on an
    atlas built from a pyramid-shaped stack, stay in bounds and match
    slicing (no clamp ever moves a patch)."""
    from sift_parallel_optimization.core.pyramid_ref import (
        sift_gaussian_pyramid,
    )
    from sift_parallel_optimization.models.frontend import sift_config

    cfg = sift_config(128)
    img = jnp.asarray(np.random.default_rng(2).random((128, 128)),
                      jnp.float32)
    gauss = sift_gaussian_pyramid(img, cfg)
    atlas, meta = D.build_atlas(gauss)
    rows = D.patch_rows_for(D.max_patch_radius(cfg.S, cfg.sigma0))
    hp = np.asarray(meta["hprime"])
    ro = np.asarray(meta["row_off"])
    wl = np.asarray(meta["wlim"])
    ys, xs = [], []
    for o in range(len(gauss)):
        for s in range(cfg.S + 3):
            ys.append(ro[o] + s * hp[o] + (hp[o] - rows) // D.ROW_ALIGN
                      * D.ROW_ALIGN)
            xs.append(wl[o])
    ys, xs = np.asarray(ys, np.int32), np.asarray(xs, np.int32)
    a_np = np.asarray(atlas)
    assert ys.max() + rows <= a_np.shape[0]
    assert xs.max() + D.PATCH_COLS <= a_np.shape[1]
    out = extract_atlas_patches(atlas, jnp.asarray(ys), jnp.asarray(xs),
                                rows, D.PATCH_COLS)
    ref = np.stack([a_np[y:y + rows, x:x + D.PATCH_COLS]
                    for y, x in zip(ys, xs)])
    np.testing.assert_array_equal(np.asarray(out), ref)
