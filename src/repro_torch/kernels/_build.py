"""Build, load and call the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` have a plain C interface.  At first
use each ``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into one shared library in
``repro_torch/build/`` (named by a digest of the sources and flags, so an
edited source never loads a stale build), and the library is bound with
``ctypes``.  Nothing is built while a module is imported, and nothing falls
back: without ``nvcc`` a CUDA call raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.plan import bucket_row_offsets

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load",
           "check", "check_aligned", "aligned_rows", "check_geometry", "row_offsets",
           "dtype_code", "stream_of", "raise_on_error"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: (restype, argtypes) of every exported entry point.
_SIGNATURES = {
    "fo_error_string": (ctypes.c_char_p, [_I]),
    "fo_gemm_q": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "fo_csr_attention": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P]),
    "fo_gemm_o": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P]),
    "fo_csr_attention_bucketed": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P]),
    "fo_gemm_o_bucketed": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fo_symbols_attention": (_I, [_I, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P]),
    "fo_taylor_reuse": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
}

_LIB = None


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or the default toolkit root."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source digest has no library yet) and
    return the shared library's path.  ``nvcc``'s register/shared-memory
    report (``-Xptxas=-v``) is kept beside it as ``ptxas_<digest>.log``."""
    digest = _digest()
    lib_path = BUILD_DIR / f"libflashomni_{digest}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built, and a CUDA tensor has no other path")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(obj) for _, obj, _ in jobs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (BUILD_DIR / f"ptxas_{digest}.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)       # atomic: concurrent builders agree
    return lib_path


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
    return _LIB


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    """The C interface's element-type code (f32 and bf16 are built)."""
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}") from None


def check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA (or ``meta``) tensor of this
    device, dtype and shape."""
    if t.device != device or device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected a tensor on {device} (CUDA or meta), "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    """Raise unless ``t`` starts on an ``nbytes`` boundary (the attention
    kernels copy and store 16 bytes at a time)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected a tensor whose data starts on a {nbytes}-byte "
                         f"boundary, got address {t.data_ptr():#x}")


def aligned_rows(*rows: tuple) -> bool:
    """True when every ``(tensor, row_length)`` pair starts on a 16-byte
    boundary and has rows of a multiple of 16 bytes.  The GEMM tile then
    stages by 16-byte ``cp.async``; otherwise (a bfloat16 row of 100
    elements is 200 bytes) element by element, with the same bits."""
    return all(t.data_ptr() % 16 == 0 and n * t.element_size() % 16 == 0 for t, n in rows)


def check_geometry(geometry, rows: int, slots: int) -> None:
    """Raise unless a bucket geometry lays out ``rows`` rows over ``slots`` slots."""
    if sum(r for r, _ in geometry) != rows or sum(r * w for r, w in geometry) != slots:
        raise ValueError(f"bucket geometry {geometry} does not lay out {rows} rows "
                         f"over {slots} slots")


@functools.lru_cache(maxsize=16)
def row_offsets(geometry, device: torch.device) -> torch.Tensor:
    """(R,) int32 start of each layout row's list, on ``device``, built once
    per geometry and device."""
    return torch.from_numpy(bucket_row_offsets(geometry)).to(device)


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device`` (a Python int)."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = lib.fo_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
