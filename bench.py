"""Headline benchmark: scale-space pyramid + DoG, ms/frame on one GPU.

This is the reference's own headline measurement — mean ms per full
pyramid+DoG pass at 512x512, S=2 (reference: main.cpp:60-74 repeats
GenerateDoG until 100 ms accumulated and prints the mean). The baseline
number is the reference's C++ compiled with ``-O3 -march=native`` and
timed on a host CPU (see BASELINE.md):

  * serial GuassDePyramid.h GenerateDoG:     2.80 ms/frame
  * best parallel variant (pthread x7):      2.52 ms/frame  <- baseline

``vs_baseline`` is the speedup over the reference's BEST variant.

Iterations are chained on device with `lax.scan` (a data dependency
through the carry keeps XLA from eliding or hoisting the work, and summing
EVERY octave keeps them all live) and the per-frame time is the SLOPE
between two chain lengths, so fixed dispatch cost cancels
(utils/profiling.chained_slope_ms).

Prints exactly one JSON line. Exits non-zero on a device that has no
entry in the published-peak table (bench/roofline.PEAKS), the CPU
included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

# Reference's best self-measured variant on a host CPU (BASELINE.md):
# pthread THREAD_COUNT=7 (GaussDePyramid-pThread.h:176-254), -O3 -march=native.
BASELINE_BEST_MS = 2.52

SIZE = 512
S = 2
CHAIN_LO = 50
CHAIN_HI = 400


def main() -> None:
    from sift_parallel_optimization.bench.roofline import (
        peaks_for,
        reference_pyramid_model,
    )
    from sift_parallel_optimization.core.pyramid_ref import (
        reference_dog_pyramid,
    )
    from sift_parallel_optimization.utils.profiling import (
        chained_slope_ms,
    )
    from sift_parallel_optimization.utils.runtime import (
        configure_compile_cache,
        gpu_name_and_power_limit,
    )

    configure_compile_cache()
    dev = jax.devices()[0]
    peaks = peaks_for(dev.device_kind)
    card = gpu_name_and_power_limit()

    img = jnp.asarray(
        np.random.default_rng(0).random((SIZE, SIZE), np.float32)
    )

    def step(x):
        out = reference_dog_pyramid(x, S)
        return sum(o.sum() for o in out)

    ms = max(
        chained_slope_ms(
            step, img, chain_lo=CHAIN_LO, chain_hi=CHAIN_HI,
            repeats=5, median_of=3, min_hi_total_ms=60.0,
        ),
        1e-6,
    )

    model = reference_pyramid_model(SIZE, S)
    print(
        json.dumps(
            {
                "metric": "pyramid_dog_ms_per_frame_512",
                "value": round(ms, 4),
                "unit": "ms",
                "vs_baseline": round(BASELINE_BEST_MS / ms, 2),
                "sol_pct": model.sol_pct(ms, peaks),
                "bound": model.bound(peaks),
                "floor_ms": round(model.floor_ms(peaks), 4),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "nvidia_smi": card,
            }
        )
    )


if __name__ == "__main__":
    main()
