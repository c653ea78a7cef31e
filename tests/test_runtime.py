"""Process set-up shared by the entry points: compile-cache placement
and the native library's build."""

import ctypes
import pathlib
import shutil
import subprocess

import jax
import pytest

from sift_parallel_optimization.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def _ignored(path: str) -> bool:
    lines = (REPO / ".gitignore").read_text().split()
    return path in lines


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # not overridden


def test_compile_cache_default_is_fixed_path_in_checkout(
    monkeypatch, restore_cache_dir
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.configure_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert _ignored(".jax_cache/")


def test_native_library_builds_from_source(tmp_path):
    """A clean copy of native/ builds with make into the library path
    that .gitignore lists, and the build exports the C ABI."""
    src = tmp_path / "native"
    shutil.copytree(REPO / "native", src,
                    ignore=shutil.ignore_patterns("*.so", ".build.lock"))
    subprocess.run(["make", "-C", str(src)], check=True,
                   capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(src / "libsift_host.so"))
    for sym in ("sift_render_frame", "sift_loader_create", "sift_has_png"):
        assert hasattr(lib, sym)
    assert _ignored("native/libsift_host.so")


def test_native_library_builds_without_libpng(tmp_path):
    """Where libpng's headers are missing the build still succeeds; PNG
    I/O then reports failure instead of the library failing to load."""
    src = tmp_path / "native"
    shutil.copytree(REPO / "native", src,
                    ignore=shutil.ignore_patterns("*.so", ".build.lock"))
    subprocess.run(["make", "-C", str(src), "HAVE_PNG="], check=True,
                   capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(src / "libsift_host.so"))
    assert lib.sift_has_png() == 0
    lib.sift_read_png.restype = ctypes.c_int
    assert lib.sift_read_png(b"x.png", None, None, None, 0) == -7


def test_read_png_without_libpng_raises_clearly(monkeypatch, tmp_path):
    from sift_parallel_optimization.utils import native

    class NoPng:
        def sift_has_png(self):
            return 0

    monkeypatch.setattr(native, "_load", lambda: NoPng())
    with pytest.raises(RuntimeError, match="libpng"):
        native.read_png(tmp_path / "frame.png")
