"""sift_parallel_optimization — a JAX scale-space / SLAM-SfM engine.

A JAX / XLA / shard_map engine with the capabilities of the reference C++
study ``ZhangShuui/SIFT-parallel-optimization`` (see SURVEY.md): the
reference's twelve hand-written parallel variants of the Gaussian/DoG
scale-space pyramid (NEON/SSE/AVX/AVX-512 SIMD x pthread/OpenMP threads x
MPI processes) collapse here into

  * one XLA-fused scale-space computation (SIMD and thread levels -> the
    compiler's vector code and kernel launches),
  * explicit mesh sharding with shard_map + collectives (process level ->
    devices, no collector rank), and
  * a benchmark matrix replacing the reference's hand-edited #include variant
    selection (reference: main.cpp:5-13, GaussDePyramid-pThread.h:310-326).

On top of the parity slice the framework extends into the full north-star
pipeline: DoG extrema detection, SIFT descriptors, batched matching + RANSAC,
incremental SfM and distributed Schur-complement bundle adjustment.
"""

__version__ = "0.1.0"

from sift_parallel_optimization.config import PyramidConfig, ScaleSpaceMode

__all__ = ["PyramidConfig", "ScaleSpaceMode", "__version__"]
