"""Direct numerical parity vs the COMPILED C++ reference.

Compiles a tiny driver that #includes the reference's serial header
(read-only at /root/reference — never copied), feeds it a non-constant
integer image, and bit-compares its full pyramid+DoG output against our
REFERENCE mode. This is the strongest possible behavioral-spec gate: the
oracle is the reference binary itself, not a re-implementation.

Skipped when the reference tree or a C++ toolchain is unavailable.
"""

import shutil
import subprocess
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from sift_parallel_optimization.core.pyramid_ref import (
    reference_dog_pyramid,
)

REF = Path("/root/reference")

pytestmark = pytest.mark.skipif(
    not (REF / "GuassDePyramid.h").exists() or shutil.which("g++") is None,
    reason="reference tree or g++ unavailable",
)

_DRIVER = textwrap.dedent(
    """
    #include <cstdio>
    #include <cstdlib>
    #include "GuassDePyramid.h"
    // Reads: n S, then n*n ints. Prints every pyramid value after
    // GenerateDoG as "octave scale row col value". Subclass exposes the
    // protected pyramid storage.
    struct Dumper : public GaussPyramid {
        Dumper(int **p, int n, int S) : GaussPyramid(p, n, S) {}
        void dump(int n, int S) {
            int len = n;
            for (int o = 0; o < layer && len; o++, len /= 2) {
                for (int s = 0; s < S + 3; s++)
                    for (int r = 0; r < len; r++)
                        for (int c = 0; c < len; c++)
                            printf("%d %d %d %d %.9g\\n", o, s, r, c,
                                   GaussPy[o][s][r][c]);
            }
        }
    };
    int main() {
        int n, S;
        if (scanf("%d %d", &n, &S) != 2) return 1;
        int **img = new int*[n];
        for (int i = 0; i < n; i++) {
            img[i] = new int[n];
            for (int j = 0; j < n; j++) scanf("%d", &img[i][j]);
        }
        Dumper g(img, n, S);
        g.GenerateDoG();
        g.dump(n, S);
        return 0;
    }
    """
)


@pytest.fixture(scope="module")
def ref_binary(tmp_path_factory):
    d = tmp_path_factory.mktemp("refbin")
    src = d / "driver.cpp"
    src.write_text(_DRIVER)
    exe = d / "driver"
    subprocess.run(
        ["g++", "-O2", f"-I{REF}", str(src), "-o", str(exe)],
        check=True, capture_output=True,
    )
    return exe


@pytest.mark.parametrize("n,S", [(16, 2), (32, 3)])
def test_matches_compiled_reference(ref_binary, rng, n, S):
    img = rng.integers(0, 256, size=(n, n)).astype(np.int32)
    feed = f"{n} {S}\n" + "\n".join(
        " ".join(str(v) for v in row) for row in img
    )
    out = subprocess.run(
        [str(ref_binary)], input=feed, capture_output=True, text=True,
        check=True,
    ).stdout

    ours = reference_dog_pyramid(jnp.asarray(img.astype(np.float32)), S)
    ours_np = [np.asarray(o) for o in ours]

    checked = 0
    max_rel = 0.0
    for line in out.splitlines():
        o, s, r, c, v = line.split()
        o, s, r, c = int(o), int(s), int(r), int(c)
        v = float(v)
        u = float(ours_np[o][s, r, c])
        denom = max(abs(v), 1e-3)
        max_rel = max(max_rel, abs(u - v) / denom)
        checked += 1
    assert checked == sum(o.size for o in ours_np)
    # f32 (ours) vs the reference's f32 with a different exp()/accum order.
    assert max_rel < 5e-3, f"max rel diff vs compiled reference: {max_rel}"
