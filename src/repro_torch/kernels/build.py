"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, which may
include the shared ``csrc/*.cuh`` headers. It is compiled for Hopper
(``sm_90a``) into a shared library under the checkout's
``build/repro_torch_kernels/`` directory (listed in ``.gitignore``), named
by a hash of its source, the headers and the flags, so an edit rebuilds it
and an unchanged source is built once. ``nvcc`` is found through
``CUDA_HOME`` or, failing that, ``torch.utils.cpp_extension.CUDA_HOME``.

Nothing is built when the module is imported: the first wrapper call that
needs a kernel builds it (``load``), and ``build`` compiles a list of
kernels at once, one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("weighted_aggregate", "robust_aggregate", "flash_attention",
           "decode_attention", "moe_gemm", "ssd_scan", "bi_gemm",
           "bi_reduce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if not home:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` lives once built: named
    by a hash of its source, the headers beside it (``*.cuh``, which the
    sources include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns ``{name: nvcc's output}`` (register and shared-memory use, from
    ``-Xptxas=-v``) for the kernels compiled by this call; raises
    ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
