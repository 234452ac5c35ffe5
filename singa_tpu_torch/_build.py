"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
       -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

at first use, from the sources in this checkout only, into
``singa_tpu_torch/_build/`` (listed in ``.gitignore``). The file name
carries a hash of the source, so an edited source never loads a stale
library. Nothing is built when a module is imported: the CPU tests
import every module, and the CPU has no nvcc.

``nvcc`` is found on ``PATH``, else under ``$CUDA_HOME/bin``, else under
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(
        f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source into a temporary file -> (process,
    temporary path, final path); None if already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc -> its output (the ptxas report: registers,
    shared memory and spills of each kernel)."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict[str, str]:
    """Compile every source not built yet, one nvcc per source, all
    started together. -> {name: nvcc output} of what was built now."""
    started = {n: _start(n) for n in sources()}
    return {
        name: _finish(name, s) for name, s in started.items()
        if s is not None
    }


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built here if needed)."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return ctypes.CDLL(_lib_path(name))
