"""ctypes bindings to the repository's native C++ I/O runtime
(``native/vokselis_native.cpp``, shared with the JAX package; no copy here).

The library is built with ``g++`` at first use into ``build/vokselis_torch/``
under the checkout (never into the JAX package's directory), as
``libvokselis_native_<hash>.so``: the hash covers the source and the
compiler flags, so an edited source rebuilds and an unchanged one is reused;
each build writes a temporary file and renames it, so concurrent processes
may build at once. :data:`BUILD_DIR` is where it goes.

:func:`get_lib` raises if the library cannot be built or loaded (no g++,
no zlib). Callers take a ``backend`` of :data:`BACKENDS`, decided by
:func:`use_native`: "native" raises where the library cannot be built,
"auto" takes it where it can (the build tried once) and Python
otherwise, "python" never takes it. The entry points
mirror ``vokselis_tpu/native/__init__.py``: :func:`load_raw_native`,
:func:`write_png_native` and :class:`NativeRecorder`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vokselis_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vokselis_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")

BACKENDS = ("auto", "native", "python")

_lock = threading.Lock()
_libs: dict = {}  # library path -> loaded, bound library
_probe: dict = {}  # library path -> whether get_lib succeeded


def library_path() -> Path:
    """Where the library for this source and these flags lives (in
    :data:`BUILD_DIR`)."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return Path(BUILD_DIR) / f"libvokselis_native_{tag}.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native I/O library cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    for name, args in (("vx_load_raw", [s, p, ctypes.c_int64]),
                       ("vx_write_png", [s, p, i, i, i, i]),
                       ("vx_strip_rows", [p, p, i, i, i]),
                       ("vx_recorder_start_video", [p, s, i, i, i]),
                       ("vx_recorder_push_frame", [p, p, i, i, i]),
                       ("vx_recorder_screenshot", [p, s, p, i, i, i]),
                       ("vx_recorder_finish_video", [p]),
                       ("vx_recorder_free", [p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i  # 0 on success, negative on failure
    lib.vx_recorder_new.argtypes = []
    lib.vx_recorder_new.restype = p
    return lib


def get_lib() -> ctypes.CDLL:
    """Build (unless built) and load the native library in :data:`BUILD_DIR`.
    Raises if g++ or the build fails."""
    so = library_path()
    with _lock:
        if so not in _libs:
            if not so.is_file():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:  # built elsewhere (another libc): build it here
                _build(so)
                lib = ctypes.CDLL(str(so))
            _libs[so] = _bind(lib)
        return _libs[so]


def available() -> bool:
    """Whether :func:`get_lib` succeeds; tried once per library path."""
    key = library_path()
    if key not in _probe:
        try:
            get_lib()
            _probe[key] = True
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _probe[key] = False
    return _probe[key]


def use_native(backend: str) -> bool:
    """Whether a caller with this ``backend`` takes the native library."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend == "native" or (backend == "auto" and available())


def load_raw_native(path: str, size: int) -> np.ndarray:
    """Read ``size`` bytes of a raw file; raises if it is shorter."""
    out = np.empty(size, np.uint8)
    rc = get_lib().vx_load_raw(str(path).encode(), out.ctypes.data, size)
    if rc != 0:
        raise OSError(f"vx_load_raw failed ({rc}) on {path}")
    return out


def write_png_native(path: str, img: np.ndarray, level: int = 1) -> None:
    """Encode an (H, W) or (H, W, C) uint8 image (C in 1, 3, 4) to a PNG file
    with zlib level ``level`` and filter 0, as ``media.png.encode_png``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG encoder wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    rc = get_lib().vx_write_png(str(path).encode(), img.ctypes.data, h, w, c, level)
    if rc != 0:
        raise OSError(f"vx_write_png failed ({rc}) on {path}")


class NativeRecorder:
    """Native worker-thread frame sink (Recorder, recorder.rs:25-72)."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.vx_recorder_new()

    def start_video(self, path: str, width: int, height: int, fps: int = 60) -> bool:
        return self._lib.vx_recorder_start_video(
            self._h, str(path).encode(), width, height, fps) == 0

    def push_frame(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w, c = frame.shape
        self._lib.vx_recorder_push_frame(self._h, frame.ctypes.data, h, w, c)

    def screenshot(self, path: str, frame: np.ndarray):
        """Queue a PNG of ``frame`` to ``path``; written by the time
        :meth:`close` returns."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim == 2:
            frame = frame[:, :, None]
        h, w, c = frame.shape
        self._lib.vx_recorder_screenshot(self._h, str(path).encode(), frame.ctypes.data,
                                         h, w, c)

    def finish_video(self):
        self._lib.vx_recorder_finish_video(self._h)

    def close(self):
        if self._h:
            self._lib.vx_recorder_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
