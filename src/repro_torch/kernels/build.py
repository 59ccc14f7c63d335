"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``src/repro_torch/csrc/`` compiles to its own shared library
with a plain C interface (one ``nvcc`` process per source, all started
together).  The compiler's output, with ptxas's register, shared-memory
and spill report for every kernel, is kept beside each library
(``build_log``).  Libraries go to ``build/repro_torch_kernels/<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gmw_round.cu", "ring_matmul.cu", "ring_matmul_ss.cu", "bitpack.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build_dir(sources: Sequence[str] = SOURCES) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(sources: Sequence[str] = SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every missing library in parallel; returns name -> path.

    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    out_dir = build_dir(sources)
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{pathlib.Path(name).stem}.so" for name in sources}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{output}")
        else:
            libs[name].with_suffix(".log").write_text(output)
            os.replace(tmp, libs[name])
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


def build_log(source: str) -> str:
    """The compiler's output for one source (ptxas's ``-v`` report)."""
    return build()[source].with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of one source, built if needed."""
    return ctypes.CDLL(str(build()[source]))


def build_all() -> float:
    """Build and load every kernel library; returns the seconds it took."""
    t0 = time.perf_counter()
    for name in SOURCES:
        library(name)
    return time.perf_counter() - t0
