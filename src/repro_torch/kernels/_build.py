"""Builds and loads the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Every ``csrc/*.cu`` compiles to an object with its own ``nvcc`` process,
all started together, and the objects link into one shared library with a
plain C interface.  The build goes to ``build/repro_torch_kernels/<hash>/``
at the root of the checkout, keyed by a hash of the sources and flags, at
first use; no binary is committed.  Nothing here runs at import time.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry points -> argument types (every pointer and the stream as c_void_p)
SIGNATURES = {
    # x, packed, scale, y, M, N, K, kp, bits, dtype, splits, tiles, stream
    "rq_quant_gemv": [_P] * 4 + [_I] * 8 + [_P],
    # x, packed, scale, y, E, M, N, K, kp, bits, dtype, splits, tiles, sstride, stream
    "rq_quant_gemv_experts": [_P] * 4 + [_I] * 9 + [_L, _P],
    # x, packed, scale, y, M, N, K, kp, bits, dtype, nt, wgs, splits, cluster, stream
    "rq_quant_matmul": [_P, _P, _P, _P] + [_I] * 10 + [_P],
    # x, packed, scale, y, E, M, N, K, kp, bits, dtype, nt, wgs, splits, cluster, sstride,
    # stream
    "rq_quant_matmul_experts": [_P] * 4 + [_I] * 11 + [_L, _P],
    # pos, q, k_new, v_new, k_packed, k_scale, v_packed, v_scale, mask, out,
    # B, n_kv, g, S, hd, block, k_bits, v_bits, cluster, dtype, stream
    "rq_quant_kv_decode_step": [_P] * 10 + [_I] * 10 + [_P],
    # pos, table, q, k_new, v_new, k_pool, k_scale, v_pool, v_scale, mask, out,
    # B, n_kv, g, nb, hd, block, k_bits, v_bits, cluster, dtype, stream
    "rq_quant_kv_decode_step_paged": [_P] * 11 + [_I] * 10 + [_P],
    # table, q, k_pool, k_scale, v_pool, v_scale, mask, out,
    # B, n_kv, g, nb, hd, block, k_bits, v_bits, cluster, dtype, stream
    "rq_quant_kv_attention_paged": [_P] * 8 + [_I] * 10 + [_P],
    # start, acc, table, k_burst, v_burst, k_pool, k_scale, v_pool, v_scale,
    # B, H, nb, hd, block, k_bits, v_bits, J, dtype, stream
    "rq_quant_kv_append_burst_paged": [_P] * 9 + [_I] * 9 + [_P],
    # q, k_packed, k_scale, v_packed, v_scale, mask, out,
    # B, n_kv, g, S, hd, block, k_bits, v_bits, cluster, dtype, stream
    "rq_quant_kv_attention": [_P] * 7 + [_I] * 10 + [_P],
    # start, acc, k_burst, v_burst, k_packed, k_scale, v_packed, v_scale,
    # B, H, S, hd, block, k_bits, v_bits, J, dtype, stream
    "rq_quant_kv_append_burst": [_P] * 8 + [_I] * 9 + [_P],
    # pos, x, w_packed, w_scale, cos, sin, k_packed, k_scale, v_packed, v_scale, mask,
    # out, B, d, n_heads, n_kv, S, hd, block, w_bits, k_bits, v_bits, splits, cluster, dtype,
    # stream
    "rq_quant_kv_decode_step_proj": [_P] * 12 + [_I] * 13 + [_P],
    # w, scale, out, rows, cols, bits, rowwise, dtype, stream
    "rq_fake_quant": [_P] * 3 + [_L, _L, _F, _I, _I, _P],
    # w, scale, g, dw, rows, cols, bits, rowwise, dtype, stream
    "rq_fake_quant_ste_bwd": [_P] * 4 + [_L, _L, _F, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
#: what the last build of this process did (chip_smoke.py prints it)
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if this source hash is not built yet) and return the library path."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.exists():
        BUILD_INFO.update(path=str(so), cached=True, seconds=0.0)
        return so
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                                   "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(cus, objs)]
        logs = []
        failed = []
        for src, proc in zip(cus, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                               str(Path(tmp) / LIB_NAME)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (out_dir / "build.log").write_text(log)
        os.replace(Path(tmp) / LIB_NAME, so)   # atomic: a racing build is harmless
    BUILD_INFO.update(path=str(so), cached=False,
                      seconds=time.perf_counter() - t0, log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` value a launcher returned."""
    if rc:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    """The kernels' activation-type code for ``t`` (f32 0, bf16 1)."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, *, dtype: torch.dtype | None = None,
            shape: tuple[int, ...] | None = None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given type and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
