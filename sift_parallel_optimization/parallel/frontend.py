"""Data-parallel batched frontend: frames sharded over the mesh.

The throughput path (BASELINE.json: frames/s scaling 1 device -> 1 host
-> N hosts). Scaling over frames is pure DP with zero
cross-frame communication — the ideal-scaling regime the reference's MPI
design (one collector rank, SURVEY.md section 2) could never reach.

How the local batched program is built: the pyramid is vmapped over the
batch (bigger blur einsums), and detection and description are UNROLLED
per frame, B independent subprograms in ONE launch. On the accelerator
the engine was first built for, this beat a plain ``vmap`` of the
per-frame frontend, a batch-aware sparse stage, and a frame-folded
descriptor stage: vmap turned the flat 1-D top-k and scalar gathers into
batched lowerings and materialized every batched stage boundary with
relayout copies and concats. The ranking has not been re-measured on the
GPU.

The win over B separate per-frame calls is the launch amortization (one
dispatch, one outer scan-able program instead of B round trips) and, with
a mesh, the shard_map form: each device runs exactly this single-chip
batched program on its local frame shard — not GSPMD's partitioning of a
vmapped one.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from sift_parallel_optimization.config import PyramidConfig
from sift_parallel_optimization.core.pyramid_ref import (
    sift_gaussian_pyramid,
)
from sift_parallel_optimization.models.descriptor import (
    orient_and_describe,
)
from sift_parallel_optimization.models.detect import detect_pyramid
from sift_parallel_optimization.models.frontend import Features


def _batched_frontend(
    imgs: jax.Array,
    cfg: PyramidConfig,
    max_keypoints: int,
    dual_orientation: bool,
    thresholds: dict,
) -> Features:
    """(B, H, W) -> Features with leading batch axis, single device."""
    b = imgs.shape[0]
    gauss = jax.vmap(lambda im: sift_gaussian_pyramid(im, cfg))(imgs)
    per_frame = []
    for i in range(b):
        g_i = [a[i] for a in gauss]
        dogs = [a[1:] - a[:-1] for a in g_i]
        kp = detect_pyramid(dogs, cfg, max_keypoints, **thresholds)
        kp, desc = orient_and_describe(
            g_i, kp, dual_orientation=dual_orientation
        )
        per_frame.append(Features(keypoints=kp, descriptors=desc))
    return jax.tree.map(lambda *xs: jax.numpy.stack(xs), *per_frame)


def batched_extract_features(
    imgs: jax.Array,
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    mesh: Mesh | None = None,
    dual_orientation: bool = False,
    **thresholds,
) -> Features:
    """(B, H, W) frames -> Features with leading batch axis.

    With ``mesh``, frames are sharded over its ``data`` axis (B must be a
    multiple of it) and each device runs the batch-aware single-chip
    program on its local shard; without, the same program runs on one
    device.
    """
    if mesh is None:
        return _batched_frontend(
            imgs, cfg, max_keypoints, dual_orientation, thresholds
        )
    from jax import shard_map

    fn = shard_map(
        lambda x: _batched_frontend(
            x, cfg, max_keypoints, dual_orientation, thresholds
        ),
        mesh=mesh,
        in_specs=P("data", None, None),
        out_specs=P("data"),
    )
    return fn(imgs)
