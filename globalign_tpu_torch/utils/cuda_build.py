"""Build-on-demand for the port's CUDA kernels (``csrc/*.cu``).

The counterpart of ``globalign_tpu/utils/native.py``: on first use each
source is compiled by its own ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface — all of them started together —
named by a hash of the source and flags, under ``build/globalign_tpu_torch/``
at the root of the checkout; a file lock keeps concurrent processes from
building them twice.  The libraries are bound with ``ctypes``.

There is no fallback: a missing toolkit or a failed compile raises, because
only the plain PyTorch versions run without the card, and they run only for
tensors that lie on the CPU (``ops.fill_cuda``, ``ops.linear_tb``).
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
from types import SimpleNamespace

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "globalign_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
# Per source: the C entry points and their (argtypes, restype).
SIGNATURES = {
    "gotoh_fill": {
        "gotoh_fill_launch": (
            # tok_a tok_b cost m n row0 col0y_top col0 final3 moves last
            # edge pass_edge
            [_PTR] * 13
            + [_I32] * 9  # B M N A gap go W warps P
            + [_PTR],  # stream
            _I32,
        ),
        "gotoh_fill_ragged_launch": (
            [_PTR] * 5  # desc cost final3 moves pass_edge
            + [_I32] * 9  # B M N A gap go W warps P
            + [_PTR],  # stream
            _I32,
        ),
        "gotoh_fill_clusters": (
            [_I32] * 6  # W warps P moves ragged A
            + [_PTR],  # clusters (int *)
            _I32,
        ),
        "gotoh_fill_error_string": ([_I32], ctypes.c_char_p),
    },
    "gotoh_batch": {
        "gotoh_batch_launch": (
            [_PTR, _I32, _PTR]  # desc B cost
            + [_I32] * 3  # A gap go
            + [_PTR]  # final3
            + [_I32] * 3  # last W warps
            + [_PTR],  # stream
            _I32,
        ),
        "gotoh_batch_error_string": ([_I32], ctypes.c_char_p),
    },
    "gotoh_batch_moves": {
        "gotoh_batch_moves_launch": (
            [_PTR, _I32, _PTR]  # desc B cost
            + [_I32] * 3  # A gap go
            + [_PTR] * 2  # final3 codes
            + [_I32] * 2  # W warps
            + [_PTR],  # stream
            _I32,
        ),
        "gotoh_batch_moves_error_string": ([_I32], ctypes.c_char_p),
    },
    "walk_block": {
        "walk_block_launch": (
            # moves i_entry j_entry level_entry ops count j_exit level_exit
            [_PTR] * 8
            + [_I32] * 4  # B K N L
            + [_PTR],  # stream
            _I32,
        ),
        "walk_ragged_launch": (
            [_PTR] * 6  # desc moves final3 ops count j_exit
            + [_I32] * 2  # B L
            + [_PTR],  # stream
            _I32,
        ),
        "walk_tile_rows": ([], _I32),  # the code tiles' shape
        "walk_tile_cols": ([], _I32),
        "walk_block_error_string": ([_I32], ctypes.c_char_p),
    },
    "gotoh_tile": {
        "gotoh_tile_launch": (
            # tok_a tok_b cost row0 col0y_top meta order pairs final3
            # moves rows_out rowbuf colbuf flags
            [_PTR] * 14
            + [_I32] * 10  # B M N A gap go K tiles H W
            + [_PTR],  # stream
            _I32,
        ),
        "gotoh_tile_error_string": ([_I32], ctypes.c_char_p),
    },
    "tokenize": {
        "tokenize_ragged_launch": (
            [_PTR, _I32, _PTR, _I32, _PTR, _I32, _PTR]  # desc R letters wide
            # table A arena
            + [_PTR],  # stream
            _I32,
        ),
        "tokenize_error_string": ([_I32], ctypes.c_char_p),
    },
    "render": {
        "render_ragged_launch": (
            [_PTR, _PTR, _I64]  # desc ops ld
            + [_PTR] * 4  # count j_exit starts letters
            + [_I32, _PTR, _I64, _I32]  # wide lines stride P
            + [_PTR],  # stream
            _I32,
        ),
        "render_error_string": ([_I32], ctypes.c_char_p),
    },
    "wave_split": {
        "wave_split_launch": (
            [_PTR] * 7  # tok_a tok_b out order rowbuf colbuf flags
            # R m n cmatch cmismatch dcost icost go, the four capture
            # waves, tiles
            + [_I32] * 13
            + [_PTR],  # stream
            _I32,
        ),
        "wave_split_error_string": ([_I32], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None


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


def library_path(src: Path) -> Path:
    """Where the library of one source, at the current flags, lives."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build() -> list[Path]:
    """Compile every source (``sources()``) whose library is missing, one
    ``nvcc`` each, all running at once; returns the libraries in the order
    of the sources."""
    srcs = sources()
    paths = [library_path(src) for src in srcs]
    if all(p.exists() for p in paths):
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            jobs = []
            for src, so_path in zip(srcs, paths):
                if so_path.exists():  # built by another process meanwhile
                    continue
                tmp = so_path.with_name(so_path.name + f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                jobs.append((cmd, proc, tmp, so_path))
            failed = []
            for cmd, proc, tmp, so_path in jobs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
                    )
                else:
                    os.replace(tmp, so_path)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return paths


def load() -> SimpleNamespace:
    """The bound C entry points of every kernel, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            funcs = {}
            for src, so_path in zip(sources(), build()):
                lib = ctypes.CDLL(str(so_path))
                for name, (argtypes, restype) in SIGNATURES[src.stem].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                    funcs[name] = fn
            _lib = SimpleNamespace(**funcs)
        return _lib
