"""The flagship frontend: grayscale frame -> keypoints + descriptors.

One jit-compiled program: SIFT-mode scale-space pyramid (core/pyramid_ref.py
— the generalization of the reference's entire workload,
GuassDePyramid.h:106-149), DoG extrema detection (models/detect.py),
orientation assignment and 128-d descriptors (models/descriptor.py). Static
shapes end to end; batching is a `jax.vmap` away and sharding a
`jax.sharding` annotation away (parallel/scale_space.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from sift_parallel_optimization.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization.core.pyramid_ref import (
    sift_gaussian_pyramid,
)
from sift_parallel_optimization.models.descriptor import (
    orient_and_describe,
)
from sift_parallel_optimization.models.detect import detect_pyramid
from sift_parallel_optimization.models.keypoints import Keypoints


class Features(NamedTuple):
    keypoints: Keypoints
    descriptors: jax.Array  # (K, 128) f32, zeroed for invalid slots


def sift_config(length: int, S: int = 3, **kw) -> PyramidConfig:
    return PyramidConfig(length=length, S=S, mode=ScaleSpaceMode.SIFT, **kw)


def extract_features(
    img: jax.Array,
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    dual_orientation: bool = False,
    **thresholds,
) -> Features:
    """Full frontend on one (H, W) grayscale image in [0, 1].

    ``dual_orientation`` enables Lowe's 80%-rule secondary orientations:
    output capacity doubles to 2 * max_keypoints with slots [K:2K) holding
    the secondary-peak duplicates (masked where no qualifying peak).
    """
    from sift_parallel_optimization.models.descriptor import (
        max_patch_radius,
    )

    gauss = sift_gaussian_pyramid(img, cfg)
    dogs = [g[1:] - g[:-1] for g in gauss]
    kp = detect_pyramid(dogs, cfg, max_keypoints=max_keypoints, **thresholds)
    kp, desc = orient_and_describe(
        gauss, kp, dual_orientation=dual_orientation,
        max_radius=max_patch_radius(cfg.S, cfg.sigma0),
    )
    return Features(keypoints=kp, descriptors=desc)
