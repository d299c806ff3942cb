"""Hand-written CUDA kernels and their wrappers.

Each replaces the Pallas TPU kernel of the same name in
auron_tpu/ops/kernels_pallas.py:
- `hash_partition_ids_i64` (source `auron_tpu_torch/csrc/hash_pid.cu`);
- `radix_bucket_hist` (source `auron_tpu_torch/csrc/radix_hist.cu`).
Each source is compiled with `nvcc` for sm_90a into
`build/auron_tpu_torch/` at first use and loaded with ctypes (a plain C
interface builds in seconds, where a source including PyTorch's headers
takes minutes).  Each `nvcc` run records a `kernel.build` trace event
(cat `compile`, runtime/tracing.py) with the source's name and the
build's host seconds; a library already in the build directory records
none.

Each wrapper runs its plain PyTorch version, which lives beside it, only
for tensors on the CPU.  For a CUDA tensor it launches the kernel or
raises; it never falls back.  `LAUNCHES` counts the kernel launches, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import contextvars
import ctypes
import os
import time
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from auron_tpu_torch.columnar.batch import DeviceColumn
from auron_tpu_torch.exprs.hashing import hash_columns, pmod
from auron_tpu_torch.ir.schema import DataType
from auron_tpu_torch.runtime.tracing import event

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"hash_pid": _PKG / "csrc" / "hash_pid.cu",
           "radix_hist": _PKG / "csrc" / "radix_hist.cu"}
BUILD_DIR = _PKG.parent / "build" / "auron_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = {"hash_partition_ids_i64": 0,
                            "radix_bucket_hist": 0}

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
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    event("kernel.build", cat="compile", kernel=name,
          seconds=time.perf_counter() - t0)
    return lib


def build() -> None:
    """Build every kernel library (nvcc processes started together, each
    thread in a copy of the caller's context, so its `kernel.build`
    event reaches the caller's trace) and load them."""
    with _build_lock:
        todo = [n for n in SOURCES if n not in _libs]
        errors = []

        def run(name):
            try:
                _compile(name)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        threads = [threading.Thread(target=contextvars.copy_context().run,
                                    args=(run, n)) for n in todo]
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
    elif name == "radix_hist":
        fn = lib.auron_radix_bucket_hist
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
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


# ---------------------------------------------------------------------------
# per-tile radix bucket histogram of u32 words
# ---------------------------------------------------------------------------

LANES = 128
MAX_TILE_ROWS = 256
HIST_MAX_BITS = 8            # 2^b_bits <= 256 buckets
HIST_MAX_CLUSTER = 8         # blocks per tile: the portable cluster size
VECTOR_BYTES = 16            # the kernel reads the words as uint4


def hist_tile_rows(cap: int) -> int:
    """The Pallas kernel's tile height for `cap` words: min(cap/128, 256),
    lowered until it divides cap/128."""
    rows = cap // LANES
    tile_rows = min(rows, MAX_TILE_ROWS)
    while rows % tile_rows:
        tile_rows -= 1
    return tile_rows


def hist_launch_shape(cap: int) -> Tuple[int, int]:
    """(tile_rows, cluster) of the kernel's launch for `cap` words: each
    tile of hist_tile_rows(cap) x 128 words is counted by a cluster of
    `cluster` blocks, the largest power of two <= 8 that divides
    tile_rows, each block taking tile_rows * 128 / cluster consecutive
    words (a multiple of 128, so a whole number of 16-byte vectors)."""
    tile_rows = hist_tile_rows(cap)
    cluster = HIST_MAX_CLUSTER
    while tile_rows % cluster:
        cluster //= 2
    return tile_rows, cluster


def radix_bucket_hist_plain(words: torch.Tensor, b_bits: int
                            ) -> torch.Tensor:
    """The plain version, the Pallas body's function: per tile, for each
    bucket, the count of words whose top b_bits bits equal it."""
    cap = words.shape[0]
    tile = hist_tile_rows(cap) * LANES
    u = words.to(torch.int64) & 0xFFFFFFFF
    digit = (u >> (32 - b_bits) if b_bits else torch.zeros_like(u)) \
        .view(cap // tile, tile)
    return torch.stack([(digit == d).sum(1, dtype=torch.int32)
                        for d in range(1 << b_bits)], 1)


def radix_bucket_hist(words: torch.Tensor, b_bits: int) -> torch.Tensor:
    """Per-tile histogram of the top `b_bits` bits of u32 words ->
    int32[n_tiles, 2^b_bits], tiles of hist_tile_rows(cap) x 128 words.

    words: the u32 words as an int32 tensor holding their bits (a bit
    view: a word >= 2^31 is the negative int32 of the same bits), 1-D,
    contiguous, cap % 128 == 0.  b_bits in 0..8, else ValueError, as the
    Pallas kernel.  On a CUDA device this launches the hand-written kernel
    (hist_launch_shape: a cluster of blocks per tile) on the current
    stream without synchronising; the kernel reads 16-byte vectors, so
    there the words must start on a 16-byte boundary, else ValueError
    (every fresh allocation does; a view such as words[1:] does not).  On
    the CPU it runs the plain version."""
    if not 1 <= (1 << b_bits) <= (1 << HIST_MAX_BITS):
        raise ValueError(f"b_bits {b_bits} outside staging range")
    if words.dim() != 1 or words.dtype != torch.int32:
        raise TypeError(f"want 1-D int32 words, got {words.dtype} of "
                        f"shape {tuple(words.shape)}")
    cap = words.shape[0]
    if cap == 0 or cap % LANES:
        raise ValueError(f"word count {cap} is not a positive multiple "
                         f"of {LANES}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no radix-hist kernel for device {words.device}")
    if words.device.type == "cpu":
        return radix_bucket_hist_plain(words, b_bits)
    if words.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"words must start on a {VECTOR_BYTES}-byte "
                         f"boundary")
    lib = _library("radix_hist")
    tile_rows, cluster = hist_launch_shape(cap)
    out = torch.empty((cap // (tile_rows * LANES), 1 << b_bits),
                      dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.auron_radix_bucket_hist(words.data_ptr(), out.data_ptr(),
                                         cap, tile_rows, cluster, b_bits,
                                         stream)
    if rc != 0:
        raise RuntimeError(f"radix_hist kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["radix_bucket_hist"] += 1
    return out
