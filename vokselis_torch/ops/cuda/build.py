"""Build a kernel source of ``vokselis_torch/csrc`` into a plain-C shared
library and load it with ``ctypes``.

Every kernel module calls :func:`load_library` with its source at first use
on a CUDA device (never at import). ``nvcc`` compiles for ``sm_90a`` into
``build/vokselis_torch/`` under the checkout, once per source and flag set:
the library's file name carries a hash of both (and of the headers in
``csrc/``, which sources share), so an edited source, header or flag
rebuilds and an unchanged one is reused. Separate sources may be built
concurrently (one ``nvcc`` each, e.g. from threads).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vokselis_torch"
# --fmad=false: each kernel repeats its plain version's float32 operations one
# by one; a contracted a*b+c would round differently from the two steps the
# plain version (one torch op each) takes
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def load_library(source: Path, flags=NVCC_FLAGS) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (unless its library is already built) and load it.

    Returns the library and the compiler's output of this build (the
    ``ptxas`` register and spill report); the output is empty when the
    library was already built. A failed build raises with the compiler's
    output."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = ""
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.vk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vk_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.vk_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
