"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled at first use into ``build/mimm_tpu_torch/lib<name>-<hash>.so``
under the repository root.  The hash covers the source, the ``csrc/*.cuh``
headers and the nvcc flags, so an edited source or header rebuilds;
concurrent builds of one library serialize on ``build/mimm_tpu_torch/<name>.lock``, and ``build_all`` starts
one nvcc for every source at once.  No PyTorch header is included: the library
takes raw device pointers and a ``cudaStream_t`` (all ``c_void_p``), which
keeps a build at seconds instead of minutes.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mimm_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}
_lock = threading.Lock()
# name -> ptxas report (registers / shared memory / spills) of the build
ptxas_reports: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels are built on the machine with the card")


def library_path(name: str) -> str:
    """The hash covers the source, every ``csrc/*.cuh`` it may include,
    and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the current hash is built; returns
    the library path.  A failed build raises with nvcc's stderr."""
    out = library_path(name)
    report = compile_locked(
        name, out, lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                os.path.join(CSRC, f"{name}.cu")])
    if report is not None:
        ptxas_reports[name] = report
        with open(out + ".ptxas.txt", "w") as f:
            f.write(report)
    elif name not in ptxas_reports and os.path.exists(out + ".ptxas.txt"):
        with open(out + ".ptxas.txt") as f:
            ptxas_reports[name] = f.read()
    return out


def compile_locked(name: str, out: str, command) -> str | None:
    """Run ``command(tmp)`` to build ``out`` unless it exists, holding
    ``BUILD_DIR/<name>.lock`` so concurrent builds of one library wait
    for each other; the output is renamed into place only when the
    compiler succeeds.  Returns the compiler's stderr when this call built
    it, else None; a failed build raises with the compiler's stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return None
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = command(tmp)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed for {name} "
                    f"(rc={proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
            return proc.stderr
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def build_all() -> dict:
    """Build every ``csrc/*.cu``, all nvcc processes started together;
    returns {name: library path}."""
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
