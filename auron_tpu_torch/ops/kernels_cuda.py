"""Hand-written CUDA kernels and their wrappers.

`hash_partition_ids_i64` replaces the Pallas TPU kernel of the same name
(auron_tpu/ops/kernels_pallas.py).  The CUDA source is
`auron_tpu_torch/csrc/hash_pid.cu`; it is compiled with `nvcc` for sm_90a
into `build/auron_tpu_torch/` at first use and loaded with ctypes (a plain
C interface builds in seconds, where a source including PyTorch's headers
takes minutes).

Each wrapper runs its plain PyTorch version, which lives beside it, only
for tensors on the CPU.  For a CUDA tensor it launches the kernel or
raises; it never falls back.  `LAUNCHES` counts the kernel launches, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from auron_tpu_torch.columnar.batch import DeviceColumn
from auron_tpu_torch.exprs.hashing import hash_columns, pmod
from auron_tpu_torch.ir.schema import DataType

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"hash_pid": _PKG / "csrc" / "hash_pid.cu"}
BUILD_DIR = _PKG.parent / "build" / "auron_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = {"hash_partition_ids_i64": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "auron_tpu_torch need the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile(name: str) -> Path:
    """Compile one source into build/auron_tpu_torch/lib<name>.so unless
    an up-to-date library is there."""
    src = SOURCES[name]
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build() -> None:
    """Build every kernel library (nvcc processes started together) and
    load them."""
    with _build_lock:
        todo = [n for n in SOURCES if n not in _libs]
        errors = []

        def run(name):
            try:
                _compile(name)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        threads = [threading.Thread(target=run, args=(n,)) for n in todo]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for name in todo:
            _libs[name] = _load(name)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    if name == "hash_pid":
        fn = lib.auron_hash_pid_i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


# ---------------------------------------------------------------------------
# hash partition ids of one int64 key
# ---------------------------------------------------------------------------

def hash_partition_ids_i64_plain(data: torch.Tensor, validity: torch.Tensor,
                                 n_parts: int) -> torch.Tensor:
    """The plain version: Spark murmur3 (seed 42) + pmod through the
    engine's hashing module, on whatever device the tensors are."""
    col = DeviceColumn(DataType.int64(), data, validity)
    return pmod(hash_columns([col], seed=42), n_parts)


def hash_partition_ids_i64(data: torch.Tensor, validity: torch.Tensor,
                           n_parts: int) -> torch.Tensor:
    """pid = pmod(murmur3_spark(int64 key, seed=42), n_parts) -> int32[n].

    data: int64[n], validity: bool[n], both 1-D, contiguous, on one
    device.  On a CUDA device this launches the hand-written kernel on the
    current stream without synchronising; on the CPU it runs the plain
    version."""
    if data.dim() != 1 or validity.shape != data.shape:
        raise ValueError(f"want 1-D data and validity of one length, got "
                         f"{tuple(data.shape)} and {tuple(validity.shape)}")
    if data.dtype != torch.int64 or validity.dtype != torch.bool:
        raise TypeError(f"want int64 data and bool validity, got "
                        f"{data.dtype} and {validity.dtype}")
    if data.device != validity.device:
        raise ValueError(f"data on {data.device}, validity on "
                         f"{validity.device}")
    if not (data.is_contiguous() and validity.is_contiguous()):
        raise ValueError("data and validity must be contiguous")
    if not 1 <= n_parts < 2**31:
        raise ValueError(f"n_parts {n_parts} outside [1, 2^31)")
    if data.device.type == "cpu":
        return hash_partition_ids_i64_plain(data, validity, n_parts)
    if data.device.type != "cuda":
        raise ValueError(f"no hash-pid kernel for device {data.device}")
    lib = _library("hash_pid")
    n = data.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.auron_hash_pid_i64(data.data_ptr(), validity.data_ptr(),
                                    out.data_ptr(), n, n_parts, stream)
    if rc != 0:
        raise RuntimeError(f"hash_pid kernel launch failed: CUDA error {rc}")
    LAUNCHES["hash_partition_ids_i64"] += 1
    return out
