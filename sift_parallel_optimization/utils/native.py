"""ctypes bindings to the native host runtime (native/sift_host.cpp).

Builds ``native/libsift_host.so`` (git-ignored) from ``sift_host.cpp``
with the checked-in Makefile on first use, under a file lock so that
concurrent processes build it once (g++ is part of the toolchain;
pybind11 is not available, hence ctypes). Everything degrades
gracefully: ``available()`` is False if the build fails and pure-NumPy
fallbacks are provided for the functional pieces.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsift_host.so"
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            with open(_NATIVE_DIR / ".build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                # make rebuilds only when the source is newer than the lib.
                subprocess.run(
                    ["make", "-C", str(_NATIVE_DIR)],
                    check=True, capture_output=True, text=True,
                )
            lib = ctypes.CDLL(str(_LIB_PATH))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            _build_error = f"{e} {detail}".strip()
            return None

        lib.sift_read_pgm.restype = ctypes.c_int
        lib.sift_read_pgm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
        ]
        lib.sift_write_pgm.restype = ctypes.c_int
        lib.sift_write_pgm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        for name in ("sift_read_ppm", "sift_read_png"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(lib.sift_read_pgm.argtypes)
        lib.sift_write_png.restype = ctypes.c_int
        lib.sift_write_png.argtypes = list(lib.sift_write_pgm.argtypes)
        lib.sift_has_png.restype = ctypes.c_int
        lib.sift_has_png.argtypes = []
        lib.sift_synth_frame.restype = None
        lib.sift_synth_frame.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.sift_render_frame.restype = None
        lib.sift_render_frame.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_uint64,
        ]
        lib.sift_loader_create.restype = ctypes.c_void_p
        lib.sift_loader_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.sift_loader_acquire.restype = ctypes.POINTER(ctypes.c_float)
        lib.sift_loader_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        lib.sift_loader_release.restype = None
        lib.sift_loader_release.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ]
        lib.sift_loader_destroy.restype = None
        lib.sift_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.sift_now_ms.restype = ctypes.c_double
        lib.sift_now_ms.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


# ---------------------------------------------------------------------------
# PGM I/O
# ---------------------------------------------------------------------------


def _pgm_dims(path) -> tuple[int, int]:
    """Parse (w, h) from a P5/P2 header without reading pixel data."""
    with open(path, "rb") as f:
        head = f.read(4096)
    tokens = []
    i = 0
    while i < len(head) and len(tokens) < 3:
        if head[i : i + 1] == b"#":
            while i < len(head) and head[i] not in b"\n":
                i += 1
        elif head[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while j < len(head) and not head[j : j + 1].isspace():
                j += 1
            tokens.append(head[i:j])
            i = j
    if len(tokens) < 3 or tokens[0] not in (b"P5", b"P2"):
        raise IOError(f"{path}: not a PGM header")
    return int(tokens[1]), int(tokens[2])


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Read a P5/P2 PGM into a (H, W) float32 array in [0, 1].

    Dimensions are parsed from the header first so the buffer is allocated
    exactly (no fixed max-size allocation).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    w0, h0 = _pgm_dims(path)
    buf = np.empty(w0 * h0, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.sift_read_pgm(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h),
        ctypes.c_long(w0 * h0),
    )
    if rc != 0:
        raise IOError(f"sift_read_pgm({path}) failed with code {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value)


def write_pgm(path: str | os.PathLike, img: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    img = np.ascontiguousarray(img, np.float32)
    rc = lib.sift_write_pgm(
        str(path).encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[1], img.shape[0],
    )
    if rc != 0:
        raise IOError(f"sift_write_pgm({path}) failed with code {rc}")


# ---------------------------------------------------------------------------
# PPM / PNG + generic image read
# ---------------------------------------------------------------------------


def _pnm_dims(path, magics: tuple[bytes, ...]) -> tuple[int, int]:
    """Parse (w, h) from a PNM header without reading pixel data."""
    with open(path, "rb") as f:
        head = f.read(4096)
    tokens = []
    i = 0
    while i < len(head) and len(tokens) < 3:
        if head[i : i + 1] == b"#":
            while i < len(head) and head[i] not in b"\n":
                i += 1
        elif head[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while j < len(head) and not head[j : j + 1].isspace():
                j += 1
            tokens.append(head[i:j])
            i = j
    if len(tokens) < 3 or tokens[0] not in magics:
        raise IOError(f"{path}: not a {magics} header")
    return int(tokens[1]), int(tokens[2])


def _png_dims(path) -> tuple[int, int]:
    """Parse (w, h) from the PNG IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n":
        raise IOError(f"{path}: not a PNG")
    w = int.from_bytes(head[16:20], "big")
    h = int.from_bytes(head[20:24], "big")
    return w, h


def _read_via(fn_name, path, w0: int, h0: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    buf = np.empty(w0 * h0, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = getattr(lib, fn_name)(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h),
        ctypes.c_long(w0 * h0),
    )
    if rc != 0:
        raise IOError(f"{fn_name}({path}) failed with code {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value)


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Read a P6/P3 PPM as (H, W) float32 grayscale (Rec.601 luma)."""
    w0, h0 = _pnm_dims(path, (b"P6", b"P3"))
    return _read_via("sift_read_ppm", path, w0, h0)


def _require_png() -> None:
    lib = _load()
    if lib is not None and not lib.sift_has_png():
        raise RuntimeError(
            "PNG I/O unavailable: native/libsift_host.so was built without "
            "libpng (its headers were not found); install libpng's "
            "development files and run `make -C native clean all`"
        )


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read a PNG (gray/RGB/RGBA, 8/16-bit) as (H, W) float32 grayscale."""
    _require_png()
    w0, h0 = _png_dims(path)
    return _read_via("sift_read_png", path, w0, h0)


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write [0,1] floats as an 8-bit grayscale PNG."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    _require_png()
    img = np.ascontiguousarray(img, np.float32)
    rc = lib.sift_write_png(
        str(path).encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[1], img.shape[0],
    )
    if rc != 0:
        raise IOError(f"sift_write_png({path}) failed with code {rc}")


_READERS = {
    ".pgm": read_pgm,
    ".ppm": read_ppm,
    ".png": read_png,
}


def imread(path: str | os.PathLike) -> np.ndarray:
    """Read a PGM/PPM/PNG image as (H, W) float32 grayscale in [0, 1]."""
    ext = os.path.splitext(str(path))[1].lower()
    try:
        reader = _READERS[ext]
    except KeyError:
        raise IOError(
            f"{path}: unsupported image extension {ext!r} "
            f"(supported: {sorted(_READERS)})"
        ) from None
    return reader(path)


# ---------------------------------------------------------------------------
# Synthetic frames
# ---------------------------------------------------------------------------


def synth_frame(size: int, frame_idx: int, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic frame (blob field + noise), native path."""
    lib = _load()
    if lib is None:
        return _synth_frame_numpy(size, frame_idx, seed)
    out = np.empty(size * size, np.float32)
    lib.sift_synth_frame(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, frame_idx, ctypes.c_uint64(seed),
    )
    return out.reshape(size, size)


def render_frame(
    size: int,
    rvec: np.ndarray,
    tvec: np.ndarray,
    focal: float,
    seed: int = 0,
) -> np.ndarray:
    """Pinhole view of a deterministic 3-D blob cloud (real parallax)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    out = np.empty(size * size, np.float32)
    rv = np.ascontiguousarray(rvec, np.float32)
    tv = np.ascontiguousarray(tvec, np.float32)
    lib.sift_render_frame(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size,
        rv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(focal), ctypes.c_uint64(seed),
    )
    return out.reshape(size, size)


def _synth_frame_numpy(size: int, frame_idx: int, seed: int) -> np.ndarray:
    """Pure-NumPy fallback (NOT bit-identical to the native generator)."""
    rng = np.random.default_rng(seed * 1000003 + 12345)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), 0.5, np.float32)
    n_blobs = max(8, size * size // 820)
    drift = 0.9 * frame_idx
    for _ in range(n_blobs):
        cy = rng.uniform(0, size)
        cx = (rng.uniform(0, size) - drift) % size
        sig = rng.uniform(2.0, 8.0)
        amp = rng.uniform(-0.4, 0.4)
        img += amp * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sig**2))
    fr = np.random.default_rng(seed * 1000003 + frame_idx)
    img += 0.06 * (fr.random((size, size), np.float32) - 0.5)
    return np.clip(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Prefetching loader
# ---------------------------------------------------------------------------


class FrameLoader:
    """Multithreaded prefetching frame source (native ring of buffers).

    ``next_frame`` yields (frame_idx, array) in STRICT frame order: the
    native workers complete frames in arbitrary order (n_threads > 1), so
    out-of-order completions are buffered here until their turn — sequence
    consumers (e.g. run_sfm registering frame i against i-1) can rely on
    ordering. The workers stay ahead of the consumer, so host frame
    generation overlaps device compute — the host-side analogue of
    double-buffered DMA.
    """

    def __init__(
        self, size: int, n_buffers: int = 4, n_threads: int = 2,
        seed: int = 0,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        self._lib = lib
        self._size = size
        self._next = 0
        self._pending: dict[int, np.ndarray] = {}
        self._handle = lib.sift_loader_create(
            size, n_buffers, n_threads, ctypes.c_uint64(seed)
        )
        if not self._handle:
            raise RuntimeError("sift_loader_create failed")

    def _acquire(self) -> tuple[int, np.ndarray]:
        idx = ctypes.c_int()
        ptr = self._lib.sift_loader_acquire(self._handle, ctypes.byref(idx))
        arr = np.ctypeslib.as_array(ptr, shape=(self._size, self._size))
        out = arr.copy()  # detach before releasing the ring slot
        self._lib.sift_loader_release(self._handle, ptr)
        return idx.value, out

    def next_frame(self) -> tuple[int, np.ndarray]:
        while self._next not in self._pending:
            idx, arr = self._acquire()
            self._pending[idx] = arr
        i = self._next
        self._next += 1
        return i, self._pending.pop(i)

    def close(self) -> None:
        if self._handle:
            self._lib.sift_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def now_ms() -> float:
    lib = _load()
    if lib is None:
        import time

        return time.perf_counter() * 1e3
    return float(lib.sift_now_ms())
