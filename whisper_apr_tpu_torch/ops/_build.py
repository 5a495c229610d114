"""Build and load the port's hand-written CUDA kernels (``csrc/``).

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface, compiled
by ``nvcc`` (one process per ``.cu``, all started together) and linked
into one shared library bound with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The build runs at first use into ``build/kernels/``
at the repository root, keyed by a hash of the sources and flags, so a
fresh checkout builds itself and an edited source rebuilds. ptxas's
register and shared-memory report of each kernel is kept beside the
library (``*.log``).

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from ..utils.trace import annotate, trace_span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

# dtype codes of the C entry points (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_ARG_ERRORS = {-1: "unsupported dtype combination",
               -2: "unsupported shape (head dim must be 64, widths multiples "
                   "of 32, k-quant K a multiple of its group, positions "
                   "inside the cache, kv_valid in [1, Tk])"}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    "wa_self_block": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                      _P, _P, _P],
    "wa_cross_block": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "wa_ffn_block": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P],
    "wa_ffn_scratch": [_I, _I],
    "wa_self_block_batched": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "wa_cross_block_batched": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                               _I, _I, _P, _P, _P],
    "wa_ffn_block_batched": [_P, _I, _I, _I, _I, *[_P] * 9, _I, _I, _I, _P,
                             _P, _P],
    "wa_ffn_b_smem": [_I, _I, _I, _I, _I],
    "wa_greedy_head": [_P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                       _P],
    "wa_qmatvec_stacked": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    "wa_ffn_fused": [_P, _I, _I, _I, _I, *[_P] * 5, _I, _I, _I, _P, _P, _P],
    "wa_kq_matvec": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    "wa_self_block_kq": [_P, _I, _I, _I, _I, *[_P] * 10, _I, _I, _I,
                         *[_P] * 9, _I, _I, _I, _P, _P, _P, _P],
    "wa_cross_block_kq": [_P, _I, _I, _I, _I, *[_P] * 10, _I, _I, _I,
                          *[_P] * 5, _I, _I, _I, _P, _P, _P],
    "wa_ffn_block_kq": [_P, _I, _I, _I, _I, *[_P] * 14],
    "wa_paged_attention": [_P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                           _I, _I, _P],
    "wa_flash_attention": [*[_P, _LL, _LL, _LL] * 4, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _I, _I, _P, _P, _P],
    "wa_int8_matmul": [_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    "wa_int4_matmul": [_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    "wa_probe_int8_mma": [_P, _P, _P, _I, _I, _I, _I, _P],
    "wa_probe_mma_bf16": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                          _P],
    "wa_probe_dot_f32": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P, _P],
    "wa_probe_transpose": [_P, _P, _I, _I, _P],
}

MAX_ROWS = 32          # rows one launch of a batched entry takes (csrc
                       # KM_MAX_M, FF_MAX_ROWS); the wrappers chunk larger
                       # batches

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libwhisper_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        objs = [work / f"{p.stem}.o" for p in srcs]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(p), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for p, o in zip(srcs, objs)]
        logs, failed = [], []
        for p, proc in zip(srcs, procs):
            stdout, stderr = proc.communicate()
            logs.append(f"== {p.name}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{p.name} ({proc.returncode}):\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / out.name
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with trace_span("kernels.load"):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            annotate(build_s=build_seconds)
        _lib = lib
    return _lib


def in_row_chunks(n: int, launch, max_rows: int = MAX_ROWS) -> None:
    """Call ``launch(rows)`` for consecutive slices ``rows`` of at most
    ``max_rows`` of ``n`` rows, in order. Rows (slots) are independent, so
    a wrapper launches its kernel once per chunk: the chunk's rows of a
    contiguous [B, ...] operand (x, positions, outputs, one layer's
    [B, T, D] cache block and [B, T] scales) start at a pointer offset,
    and nothing is gathered or copied."""
    for r0 in range(0, n, max_rows):
        launch(slice(r0, min(n, r0 + max_rows)))


def check(rc: int, what: str) -> None:
    """Raise on a non-zero return of a C entry point."""
    if rc == 0:
        return
    if rc in _ARG_ERRORS:
        raise ValueError(f"{what}: {_ARG_ERRORS[rc]}")
    raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t: Optional[torch.Tensor], offset: int = 0) -> Optional[int]:
    """Device address of ``t`` plus ``offset`` elements (None -> NULL)."""
    if t is None:
        return None
    return t.data_ptr() + offset * t.element_size()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_workspaces: dict = {}


def workspace(st: int, device: torch.device, name: str, n: int,
              dtype: torch.dtype = torch.float32, zero: bool = False) -> int:
    """Device address of a scratch buffer of at least ``n`` elements,
    kept per (stream, name) and grown on demand. Launches on one stream
    run in order, so a kernel's scratch is free again when the next
    launch on that stream starts; the buffer is allocated on that stream
    (the caller's current stream ``st``). ``zero``: a new buffer starts
    zeroed (counters that each launch leaves at zero)."""
    key = (st, name, dtype)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n:
        buf = (torch.zeros if zero else torch.empty)(n, dtype=dtype,
                                                     device=device)
        _workspaces[key] = buf
    return buf.data_ptr()
