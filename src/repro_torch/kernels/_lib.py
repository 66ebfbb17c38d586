"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is built or
loaded at import: the first call of a kernel wrapper on a CUDA tensor builds
every library (one ``nvcc`` process per source, all started together) into
``repro_torch/_build/``, under a name that carries the hash of the sources
and flags, so an edited source builds anew and an unchanged one is reused.

The codes below are the ``OpCode`` / ``DType`` / ``MapCode`` enums of
``csrc/common.cuh``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core.operators import DeviceMap

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("scan_flat.cu", "scan_channel.cu", "mapreduce.cu", "batched.cu",
           "matvec.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

OP_CODES = {"add": 0, "mul": 1, "max": 2, "min": 3, "affine": 4}
DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
MAP_CODES = {"identity": 0, "masked_select": 1, "times": 2}

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double
# C signatures: name -> (restype, argtypes).
_SIGNATURES = {
    "scan_flat.cu": {
        "rt_scan_flat_tile": (_I, []),
        "rt_scan_flat": (_I, [_I, _I, _P, _P, _P, _P, _L, _I, _P, _P]),
    },
    "scan_channel.cu": {
        "rt_scan_channel_chunk": (_I, []),
        "rt_scan_channel": (_I, [_I, _I, _P, _P, _P, _P, _L, _L, _L, _I, _I,
                                 _P, _P]),
    },
    "mapreduce.cu": {
        "rt_mapreduce_flat_grid": (_L, [_L]),
        "rt_mapreduce_flat": (_I, [_I, _I, _I, _P, _P, _D, _L, _P, _P, _P,
                                   _P]),
    },
    "batched.cu": {
        "rt_mapreduce_batched": (_I, [_I, _I, _I, _P, _P, _D, _L, _L, _P,
                                      _P]),
        "rt_scan_batched_tile": (_I, []),
        "rt_scan_batched": (_I, [_I, _I, _P, _P, _P, _P, _L, _L, _I, _P,
                                 _P]),
    },
    "matvec.cu": {
        "rt_matvec_chunks": (_L, [_L, _L]),
        "rt_vecmat_chunks": (_L, [_L, _L]),
        "rt_matvec": (_I, [_I, _I, _I, _P, _P, _L, _L, _P, _P, _P]),
        "rt_vecmat": (_I, [_I, _I, _I, _P, _P, _L, _L, _P, _P, _P]),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "repro_torch CUDA kernels need nvcc (CUDA toolkit) to build; "
            "none found on PATH or at /usr/local/cuda/bin/nvcc")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(source: str, digest: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build() -> dict[str, Path]:
    """Build every library that is missing; returns source -> library path.

    The sources compile in parallel.  A failed compile raises with nvcc's
    output; the compiler's register and spill report (``-Xptxas -v``) goes
    to ``<library>.log`` beside each library.
    """
    digest = _digest()
    paths = {src: _lib_path(src, digest) for src in SOURCES}
    todo = [src for src, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        tmp = paths[src].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[src].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {src} (exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[src])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if needed)."""
    lib = ctypes.CDLL(str(build()[source]))
    for name, (restype, argtypes) in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA kernel launch failed with cudaError_t {code}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C functions take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Check device and contiguity before a pointer reaches C."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: all operands must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def op_codes(route: str, op, leaves) -> tuple[int, int]:
    """The kernel's (op code, dtype code) for ``op`` over ``leaves``.

    Raises NotImplementedError, naming the route and the op, for an
    operator without a device functor and for leaf structures or dtypes no
    kernel takes: the cuda routes never fall back to the plain version.
    """
    code = OP_CODES.get(op.device_op) if op.device_op else None
    if code is None:
        raise NotImplementedError(
            f"{route}: operator {op.name!r} has no device functor for the "
            f"cuda backend")
    want = 2 if op.device_op == "affine" else 1
    dtypes = {leaf.dtype for leaf in leaves}
    if len(leaves) != want or len(dtypes) != 1:
        raise NotImplementedError(
            f"{route}: the cuda kernel takes {want} leaf(s) of one dtype for "
            f"operator {op.name!r}, got {[str(l.dtype) for l in leaves]}")
    (dtype,) = dtypes
    if dtype not in DTYPE_CODES or (want == 2 and dtype != torch.float32):
        raise NotImplementedError(
            f"{route}: the cuda kernel has no "
            f"{str(dtype).removeprefix('torch.')} form of operator "
            f"{op.name!r}")
    return code, DTYPE_CODES[dtype]


def map_code(route: str, f) -> int:
    """The kernel's map code for ``f``; raise if no kernel can run it."""
    if not isinstance(f, DeviceMap) or f.name not in MAP_CODES:
        raise NotImplementedError(
            f"{route}: map {f!r} has no device form; the cuda backend runs "
            f"the DeviceMaps of core/operators.py ({', '.join(MAP_CODES)})")
    return MAP_CODES[f.name]


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def scratch(elements: int, leaves: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch for ``elements`` kernel elements of ``leaves`` 4-byte leaves
    (8 bytes each for the AFFINE pair), on ``like``'s device."""
    return torch.empty(4 * leaves * elements, dtype=torch.uint8,
                       device=like.device)
