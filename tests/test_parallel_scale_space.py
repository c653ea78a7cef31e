"""Sharded scale-space equivalence on the virtual 8-device CPU mesh.

Variant-equivalence discipline (SURVEY.md section 4): every sharding
decomposition must reproduce the single-device semantics. Covers the three
decompositions the reference explored by hand:
  * row split   (OpenMP rows / MPI strips)  -> spatial-axis sharding
  * scale split (pthread GenerateDoG_i / MPI rank-per-scale) -> scale-axis
    sharding with neighbor ppermute for the DoG dependency
  * true-convolution spatial split with halo exchange (SIFT mode)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization.core.pyramid_ref import (
    reference_dog_octave,
    reference_dog_pyramid,
    sift_gaussian_pyramid,
)
from sift_parallel_optimization.parallel.mesh import make_mesh
from sift_parallel_optimization.parallel.scale_space import (
    scale_sharded_reference_dog_octave,
    sharded_reference_dog_octave,
    sharded_reference_dog_pyramid,
    sharded_sift_gaussian_pyramid,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, n_spatial=8)


def test_row_sharded_octave_matches(mesh, rng):
    base = jnp.asarray(rng.normal(size=(64, 64)).astype(np.float32))
    want = reference_dog_octave(base, 2)
    got = jax.jit(sharded_reference_dog_octave(mesh, 2, 64))(base)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_row_sharded_pyramid_matches(mesh, rng):
    img = jnp.asarray(rng.normal(size=(64, 64)).astype(np.float32))
    want = reference_dog_pyramid(img, 2)
    got = jax.jit(
        lambda x: sharded_reference_dog_pyramid(x, 2, mesh)
    )(img)
    assert len(got) == len(want)
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-6,
            err_msg=f"octave {o}",
        )


def test_scale_sharded_octave_matches(mesh, rng):
    # 5 scales (S=2) across 8 devices: padded block decomposition with the
    # DoG neighbor exchange crossing every shard boundary.
    base = jnp.asarray(rng.normal(size=(32, 32)).astype(np.float32))
    want = reference_dog_octave(base, 2)
    got = jax.jit(scale_sharded_reference_dog_octave(mesh, 2, 32))(base)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_scale_sharded_octave_matches_s5(mesh, rng):
    # 8 scales (S=5) over 8 devices: exactly one scale per device — the
    # reference's literal rank-per-scale layout (mpitest.cpp:42-64).
    base = jnp.asarray(rng.normal(size=(32, 32)).astype(np.float32))
    want = reference_dog_octave(base, 5)
    got = jax.jit(scale_sharded_reference_dog_octave(mesh, 5, 32))(base)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_sift_sharded_pyramid_matches(mesh, rng):
    cfg = PyramidConfig(length=256, S=2, mode=ScaleSpaceMode.SIFT,
                        max_octaves=3)
    img = jnp.asarray(rng.normal(size=(256, 256)).astype(np.float32))
    want = sift_gaussian_pyramid(img, cfg)
    got = jax.jit(
        lambda x: sharded_sift_gaussian_pyramid(x, cfg, mesh)
    )(img)
    assert len(got) == len(want)
    for o, (g, w) in enumerate(zip(got, want)):
        # Matmul (Toeplitz) vs conv (halo) evaluate the same separable
        # blur with different reduction orders; tolerance covers f32
        # reassociation over ~40-tap kernels.
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=2e-4, atol=2e-5,
            err_msg=f"octave {o}",
        )


def test_octave_sharded_pyramid_matches(mesh, rng):
    # Device d owns octave d (8 octaves of a 128-image over 8 devices) —
    # the reference's pthread round-robin octave split, zero communication.
    from sift_parallel_optimization.parallel.scale_space import (
        octave_sharded_reference_dog_pyramid,
    )

    img = jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32))
    want = reference_dog_pyramid(img, 2)
    got = jax.jit(
        lambda x: octave_sharded_reference_dog_pyramid(x, 2, mesh)
    )(img)
    assert len(got) == len(want)
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-5,
            err_msg=f"octave {o}",
        )
