"""Build-on-demand for the port's CUDA kernels (``csrc/*.cu``).

The counterpart of ``globalign_tpu/utils/native.py``: on first use the
sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, named by a hash of the sources and flags,
under ``build/globalign_tpu_torch/`` at the root of the checkout; a file
lock keeps concurrent processes from building it twice.  The library is
bound with ``ctypes``.

There is no fallback: a missing toolkit or a failed compile raises, because
only the plain PyTorch version runs without the card, and it runs only for
tensors that lie on the CPU (``ops.fill_cuda``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "globalign_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (cuda_home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found on PATH, under $CUDA_HOME or /usr/local/cuda; "
        "the CUDA kernels cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libglobalign_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    so_path = library_path()
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if so_path.exists():  # built by another process meanwhile
                return so_path
            tmp = so_path.with_name(so_path.name + f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return so_path


def load() -> ctypes.CDLL:
    """The bound kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr = ctypes.c_void_p
            i32 = ctypes.c_int
            lib.gotoh_fill_launch.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # tensors
                i32, i32, i32, i32, i32, i32, i32, i32,  # B M N A gap go T W
                ptr,  # stream
            ]
            lib.gotoh_fill_launch.restype = i32
            lib.gotoh_fill_error_string.argtypes = [i32]
            lib.gotoh_fill_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
