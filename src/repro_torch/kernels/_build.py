"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library with
a plain C interface.  The library goes to ``build/repro_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and the flags, so a
changed source builds anew and an unchanged one loads the library already
there.  Only the sources in the checkout are used.

The build raises (never falls back) when ``nvcc`` is missing, when it fails
(the error carries its stderr), or when the library lacks a symbol.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype and activation codes of the C interface (csrc/common.cuh rt::DType,
# rt::Act)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "identity": 0, "gelu": 1, "silu": 2, "relu": 3,
             "relu2": 4, "sigmoid": 5, "tanh": 6}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported symbol -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "conv2d_fused": [_I] + [_P] * 7 + [_I] * 13 + [_P],
    "conv2d_small_ci": [_I] + [_P] * 7 + [_I] * 13 + [_P],
    "conv2d_mid_ci": [_P] * 7 + [_I] * 13 + [_P],
    "conv2d_wgmma": [_P] * 8 + [_I] * 16 + [_P],
    "conv2d_ffma": [_P] * 8 + [_I] * 16 + [_P],
    "matmul_fused": [_I, _I, _P, _P, _P, _P, _P] + [_I] * 5 + [_P],
    "matmul_base": [_I, _I, _P, _P, _P, _P] + [_I] * 5 + [_P],
    "matmul_base_wgmma": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "matmul_base_small_m": [_I, _I] + [_P] * 5 + [_I] * 7 + [_P],
    "matmul_base_ffma": [_I] + [_P] * 5 + [_I] * 7 + [_P],
    "matmul_wgmma": [_I] + [_P] * 5 + [_I] * 6 + [_P],
    "matmul_small_m": [_I] + [_P] * 6 + [_I] * 7 + [_P],
    "matmul_ffma": [_I] + [_P] * 6 + [_I] * 8 + [_P],
    "matmul_ffma_small_m": [_I] + [_P] * 6 + [_I] * 7 + [_P],
    "flash_attention": [_I] + [_P] * 6 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_wgmma": [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P],
    "flash_attention_ffma": [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P],
    "flash_attention_ffma_tiles": [_I, _I, _P],
    "decode_attention": [_I] + [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "decode_attention_mma": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "decode_attention_ffma": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "paged_decode_attention": [_I] + [_P] * 7 + [_I] * 9 + [_F, _I, _P],
    "paged_decode_attention_mma": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _F,
                                                        _I, _P],
    "paged_decode_attention_ffma": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _F,
                                                         _I, _P],
    "decode_core_smem": [_I, _I, _I],
    "copy_block": [_P, _P] + [_I] * 5 + [_P],
    "lru_scan": [_I, _P, _P, _P, _I, _I, _I, _P],
    "lru_scan_chunked": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # the shared bytes a block of each schedule asks for (kernels/
    # workingset.py holds its mirror of them to these on the card)
    "matmul_wgmma_smem": [_I, _I],
    "matmul_small_m_smem": [_I, _I],
    "matmul_ffma_small_m_smem": [_I, _I],
    "matmul_ffma_smem": [_I, _I],
    "matmul_simt_smem": [_I],
    "conv2d_wgmma_smem": [_I],
    "conv2d_ffma_smem": [_I],
    "conv2d_simt_smem": [],
    "conv2d_mid_ci_smem": [_I, _I, _I],
    "conv2d_small_ci_smem": [_I] * 5,
    "flash_attention_wgmma_smem": [_I, _I],
    "flash_attention_simt_smem": [_I],
    "decode_attention_simt_smem": [_I, _I],
    "paged_decode_core_smem": [_I] * 4,
    "paged_decode_attention_simt_smem": [_I, _I],
    "lru_scan_smem": [_I, _I],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float          # wall time of this process's build (0 if loaded)
    built: bool             # False when the library for these sources existed
    log: str                # nvcc's stderr (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, cwd: Path) -> str:
    """Run the commands in parallel; raise with stderr if any fails."""
    procs = [(c, subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    logs, failed = [], []
    for cmd, p in procs:
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the hashed build directory, unless the
    library for these sources is already there."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        log = out_dir / "build.log"
        return BuildInfo(lib, 0.0, False,
                         log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    log = _run_all([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                     str(s), "-o", str(tmp / f"{s.stem}.o")] for s in srcs],
                   tmp)
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                      *[str(tmp / f"{s.stem}.o") for s in srcs]]], tmp)
    (tmp / "build.log").write_text(log)
    if out_dir.exists():           # another process built it meanwhile
        shutil.rmtree(tmp)
    else:
        tmp.rename(out_dir)
    return BuildInfo(lib, time.perf_counter() - t0, True, log)


class _Library:
    """The loaded kernel library, built on first use (one per process)."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self.info: Optional[BuildInfo] = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in SIGNATURES.items():
                if not hasattr(lib, name):
                    raise RuntimeError(f"{info.path} lacks symbol {name!r}")
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib, self.info = lib, info
        return self._lib


LIBRARY = _Library()


def call(name: str, *args) -> None:
    """Launch kernel ``name`` (a C entry point) on the current stream's
    arguments; raise when the launch reports a CUDA error."""
    fn = getattr(LIBRARY.get(), name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err} (cuda_runtime_api.h)")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor (None for an absent operand).  A DTensor
    has no storage of its own: the mesh runtime hands the kernels local
    tensors, and one reaching here raises."""
    if isinstance(t, DTensor):
        raise TypeError("a kernel operand is a DTensor; launch on its "
                        "local tensor")
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
