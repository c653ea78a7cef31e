"""Configuration for the scale-space / SIFT pipeline.

Replaces the reference's compile-time constants and hand-edited globals
(reference: GuassDePyramid.h:7-8 ``sigma=2.0``/``PI=3.1414926``;
GaussDePyramid-pThread.h:68 ``THREAD_COUNT``; GaussDePyramid-OpenMP.h:70-71
``thread_count/chunk_size``; main.cpp:19 image size; variant selection by
commenting #include lines, main.cpp:5-13) with one dataclass. Parallelism
knobs here are mesh/block parameters instead of thread counts.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import jax.numpy as jnp

# The reference's constants, kept verbatim for bit-parity in REFERENCE mode
# (GuassDePyramid.h:7-8). Note PI is the reference's (inaccurate) literal.
REF_SIGMA = 2.0
REF_PI = 3.1414926


class ScaleSpaceMode(enum.Enum):
    """Which scale-space semantics to compute.

    REFERENCE: the reference's behavioral spec (SURVEY.md section 3.4) — a
      separable multiplicative Gaussian *window* (apodization) per scale with
      sigma_s = 2/(s+1), each octave an independent 2^o-strided subsample of
      the original image, in-place DoG over adjacent scales
      (GuassDePyramid.h:106-149). Used for parity testing.

    SIFT: a true scale-space — separable Gaussian *convolution* with the
      standard SIFT schedule sigma_s = sigma0 * k^s, k = 2^(1/S), each octave
      downsampled from the previous octave's scale-S image (Lowe 2004). Used
      by the real detect/describe/match pipeline.
    """

    REFERENCE = "reference"
    SIFT = "sift"


def num_octaves(length: int) -> int:
    """Number of octaves for a square image of side ``length``.

    Matches the reference's ``while(len){x++; len/=2;}`` (GuassDePyramid.h:49-53):
    floor(log2(length)) + 1, going all the way down to 1x1.
    """
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    x = 0
    n = length
    while n:
        x += 1
        n //= 2
    return x


def octave_sizes(length: int, n_octaves: Optional[int] = None) -> list[int]:
    """Per-octave image side lengths (repeated integer halving)."""
    total = num_octaves(length)
    if n_octaves is None:
        n_octaves = total
    n_octaves = min(n_octaves, total)
    sizes = []
    n = length
    for _ in range(n_octaves):
        sizes.append(n)
        n //= 2
    return sizes


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Static configuration of one scale-space pyramid computation.

    Attributes:
      length: square image side. REFERENCE-mode parity requires a power of
        two (the reference's drivers only ever use 256/512/1024 —
        main.cpp:19, mpitest.cpp:548).
      S: number of DoG intervals usable for extrema; S+3 Gaussian scales and
        S+2 DoG planes per octave, as in the reference (GuassDePyramid.h:117,140).
      mode: REFERENCE (window, parity) or SIFT (true convolution).
      sigma0: base sigma for SIFT mode.
      assumed_blur: blur already present in the input image (SIFT mode).
      max_octaves: optionally truncate the pyramid (None = reference behavior,
        all the way to 1x1; SIFT mode stops once an octave is smaller than
        ``min_octave_size``).
      min_octave_size: smallest octave side computed in SIFT mode.
      dtype: compute dtype. float32 for parity; bfloat16 for max throughput.
      blur_precision: matmul precision of the SIFT-mode blur matmuls
        (see core/pyramid_ref.blur_bank). "highest" (default) is full
        f32 — required for geometry (SfM/BA reprojection gates are
        calibrated on it). "high" trades blur accuracy for speed, with
        near-identical detection but a worse reprojection RMS — for
        detection/throughput workloads that never triangulate.
        "default" (one-pass bf16 or TF32 grade) injects spurious DoG
        extrema and is rejected.
    """

    length: int = 512
    S: int = 2
    mode: ScaleSpaceMode = ScaleSpaceMode.REFERENCE
    sigma0: float = 1.6
    assumed_blur: float = 0.5
    max_octaves: Optional[int] = None
    min_octave_size: int = 8
    dtype: jnp.dtype = jnp.float32
    blur_precision: str = "highest"

    @property
    def blur_lax_precision(self):
        """lax.Precision for the blur matmuls (validates the knob)."""
        import jax

        allowed = {
            "highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
        }
        if self.blur_precision not in allowed:
            raise ValueError(
                f"blur_precision must be one of {sorted(allowed)} "
                f"(got {self.blur_precision!r}); one-pass 'default' is "
                "rejected — it injects spurious DoG extrema."
            )
        return allowed[self.blur_precision]

    @property
    def n_scales(self) -> int:
        return self.S + 3

    @property
    def n_dog(self) -> int:
        return self.S + 2

    @property
    def n_octaves(self) -> int:
        total = num_octaves(self.length)
        if self.mode is ScaleSpaceMode.SIFT:
            # Stop before octaves too small to convolve meaningfully.
            usable = max(
                1,
                int(math.log2(max(self.length // self.min_octave_size, 1))) + 1,
            )
            total = min(total, usable)
        if self.max_octaves is not None:
            total = min(total, self.max_octaves)
        return total

    @property
    def sizes(self) -> list[int]:
        return octave_sizes(self.length, self.n_octaves)

    def sift_sigmas(self) -> list[float]:
        """Per-scale absolute sigmas within one octave (SIFT mode)."""
        k = 2.0 ** (1.0 / self.S)
        return [self.sigma0 * (k**s) for s in range(self.n_scales)]
