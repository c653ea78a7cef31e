"""Fixed-capacity keypoint containers (static shapes under jit).

The reference stops at the DoG pyramid — it has no keypoints, descriptors,
or matching (SURVEY.md: "no feature detection, no descriptors, no matching").
This module is the north-star extension's data model (BASELINE.json configs
2-5). Design rule: NO dynamic shapes on device — every stage produces a
fixed-capacity array pair (data, valid-mask), with dead slots masked instead
of compacted, so the whole pipeline stays inside one jit trace.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    """A fixed-capacity batch of keypoints.

    All arrays share leading shape (K,). Invalid slots have ``valid == False``
    and zeroed fields; every consumer must mask by ``valid``.

    Coordinates are in ORIGINAL-image pixels (octave scaling already applied):
    ``x`` = column, ``y`` = row. ``sigma`` is the absolute scale in original-
    image pixels. ``octave``/``scale`` locate the source DoG plane.
    """

    x: jax.Array        # (K,) f32 — column in original image coords
    y: jax.Array        # (K,) f32 — row in original image coords
    sigma: jax.Array    # (K,) f32 — absolute scale
    score: jax.Array    # (K,) f32 — |contrast| after subpixel interpolation
    orientation: jax.Array  # (K,) f32 — radians in [-pi, pi); 0 until assigned
    octave: jax.Array   # (K,) i32
    scale: jax.Array    # (K,) i32 — scale index within octave (1..S)
    valid: jax.Array    # (K,) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def empty_keypoints(capacity: int) -> Keypoints:
    z = jnp.zeros((capacity,), jnp.float32)
    zi = jnp.zeros((capacity,), jnp.int32)
    return Keypoints(
        x=z, y=z, sigma=z, score=z, orientation=z,
        octave=zi, scale=zi, valid=jnp.zeros((capacity,), bool),
    )


def concat_keypoints(kps: list[Keypoints]) -> Keypoints:
    return Keypoints(*[jnp.concatenate(f, axis=-1) for f in zip(*kps)])


def top_k_keypoints(kp: Keypoints, k: int) -> Keypoints:
    """Keep the k highest-score valid keypoints (static output shape)."""
    score = jnp.where(kp.valid, kp.score, -jnp.inf)
    _, idx = jax.lax.top_k(score, k)
    take = lambda a: jnp.take(a, idx, axis=-1)
    out = Keypoints(*[take(f) for f in kp])
    return out._replace(valid=out.valid & jnp.isfinite(jnp.take(score, idx)))
