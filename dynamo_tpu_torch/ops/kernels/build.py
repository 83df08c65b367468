"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared libraries,
bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, for ``sm_90a``, into
``build/kernels/lib<name>_<hash>.so`` at the repository root, where
``<hash>`` covers the source and the flags: a changed source rebuilds, an
unchanged one loads the library already built. All sources compile in
parallel at the first use of any kernel (one ``nvcc`` process each), so a
fresh checkout builds everything in the time of its slowest file. Nothing
includes PyTorch's headers: a file builds in seconds.

The entry points take raw device pointers and the CUDA stream as ``void*``
and return ``cudaGetLastError()`` after the launch; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode", "prefill", "mla")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# C signatures: (name, argtypes) per library. Every pointer and the stream
# are c_void_p — ctypes would otherwise pass a Python int as a 32-bit int.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "decode": {
        # q, pages, out, page_table, total_lens, layer, B, Hq, Hkv, N, ps,
        # P, sm_scale, window, softcap, stream
        "paged_decode_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                                _I, _F, _I, _F, _P],
    },
    "prefill": {
        # q, pages, out, page_table, positions, total_lens, layer, B, S, Hq,
        # Hkv, N, ps, P, sm_scale, window, softcap, stream
        "paged_prefill_launch": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _F, _P],
        "ragged_mixed_launch": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                _I, _I, _I, _F, _I, _F, _P],
    },
    "mla": {
        # q, pages, out, page_table, total_lens, layer, B, nh, dkv, dr, N,
        # ps, P, stream
        "mla_decode_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                              _I, _I, _P],
        # q, pages, out, page_table, positions, total_lens, layer, B, S, nh,
        # dkv, dr, N, ps, P, stream
        "mla_prefill_launch": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# per-source build record: seconds, ptxas report, whether it was cached
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit's nvcc (PATH or "
                       "CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def nvcc_version() -> str:
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[-1] if out else "unknown"


def build_all(names=SOURCES) -> Dict[str, dict]:
    """Compile every source not yet built, all in parallel; load them all.
    Returns ``build_info``. Raises with nvcc's output when a build fails."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return build_info
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                build_info[name] = {"seconds": 0.0, "cached": True,
                                    "ptxas": ""}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "cached": False, "ptxas": log}
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["build_all", "library", "check", "stream_ptr", "build_info",
           "nvcc_version", "BUILD_DIR", "SOURCES"]
