from sift_parallel_optimization.core.pyramid_ref import (
    reference_dog_pyramid,
    reference_filter_bank,
    sift_dog_pyramid,
    sift_gaussian_pyramid,
)

__all__ = [
    "reference_dog_pyramid",
    "reference_filter_bank",
    "sift_dog_pyramid",
    "sift_gaussian_pyramid",
]
