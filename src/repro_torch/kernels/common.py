"""Shared kernel utilities: the build of the CUDA sources, their loader, and
the launch counters.

There are five kernels: one for each TPU kernel of the JAX package
(`histogram`, `segment_spmv`, `multinomial_rows` and `walk_step`), and
`uniform`, the threefry draw behind `prng.uniform`. Every
kernel is CUDA C++ for `sm_90a` with a plain C interface. The
sources are compiled at first use, one `nvcc` per source and all at once,
into shared libraries under `build/kernels/` at the root of the checkout,
and loaded with `ctypes`. A library's file name carries the hash of its
source, of the headers of this tree that the source includes (the threefry
generator of `threefry.cuh`, which `uniform` and `walk_step` share), and
of the flags, so an edited source or header is rebuilt. Nothing here runs at
import: the CPU paths never touch `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

# one source per kernel; the name is also the launch counter's key
SOURCES = {
    "histogram": KERNELS_DIR / "histogram" / "histogram.cu",
    "segment_spmv": KERNELS_DIR / "segment_spmv" / "segment_spmv.cu",
    "multinomial_rows": KERNELS_DIR / "multinomial_rows" / "multinomial_rows.cu",
    "walk_step": KERNELS_DIR / "walk_step" / "walk_step.cu",
    "uniform": KERNELS_DIR / "uniform" / "uniform.cu",
}

# No --use_fast_math, and no FMA contraction: the plain torch versions round
# after every operation, and `multinomial_rows` and `walk_step` must
# reproduce them bit for bit (an FMA in a Binomial chain moves a CDF by an
# ulp and flips draws).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches of each kernel since the last reset, counted by the ops wrappers
launches: Dict[str, int] = {name: 0 for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """The source of kernel `name`, then every header it includes by a
    quoted path, directly or through another header."""
    files = [SOURCES[name]]
    for path in files:
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            found = (path.parent / inc).resolve()
            if found not in files:
                files.append(found)
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in source_files(name))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel whose library is missing, all in parallel.

    Returns each kernel's compiler log ('' when it was already built).
    Raises when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: library_path(name) for name in SOURCES
            if not library_path(name).exists()}
    if not todo:
        return {name: "" for name in SOURCES}
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {name: "" for name in SOURCES}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _libs:
        path = library_path(name)
        if not path.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def check_launch(name: str, err: int) -> None:
    """Raise on a launch error code returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def launch_args(t: torch.Tensor):
    """(stream handle, SM count) for a launch on `t`'s device."""
    props = torch.cuda.get_device_properties(t.device)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    return ctypes.c_void_p(stream), props.multi_processor_count


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
