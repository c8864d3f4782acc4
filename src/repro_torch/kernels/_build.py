"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface, all sources at once in parallel, and loaded with
``ctypes``.  No source includes PyTorch's headers, so a build takes seconds;
the wrappers pass raw device pointers and PyTorch's current stream.  The
libraries go to ``build/torch_kernels/`` at the repository root, named by a
hash of their source and flags, so an unchanged source is built once.

Nothing is compiled or loaded at import: the first call of :func:`function`
builds every kernel (``python3 chip_smoke.py`` alone builds everything).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
#: the kernels' sources, by library name
SOURCES = ("crm_update", "clique_density", "merge_step", "segment_reduce",
           "packed_lookup")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, and nvcc's output per source
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use")
    return str(path)


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "launch.cuh"):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every missing library, one ``nvcc`` per source, in parallel.

    Returns :data:`BUILD_INFO`; raises ``RuntimeError`` with nvcc's output
    if any source fails to compile.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=sorted(procs),
                      logs=logs)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all of them if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def function(lib_name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A C function of one library with its argument and result types set."""
    fn = getattr(library(lib_name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(lib_name: str, prefix: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        text = function(lib_name, f"{prefix}_error_string", [ctypes.c_int],
                        ctypes.c_char_p)(code)
        raise RuntimeError(
            f"{prefix} kernel launch failed: CUDA error {code}: "
            f"{text.decode(errors='replace')}")
