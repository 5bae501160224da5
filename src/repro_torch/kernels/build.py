"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  Libraries are built from the package's sources at first use
into ``build/`` beside this file, named by a hash of the source, the
headers and the command, so an edited source or header is rebuilt and never
loaded stale.
``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
KERNELS = ("matrix_ingest", "matrix_lookup", "reach_closure", "embedding_bag")
SMS = 132  # streaming multiprocessors of an H100 SXM, for launch plans
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, every
    header in ``csrc/`` (a source may include any of them) and the flags."""
    digest = hashlib.sha1()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict[str, dict]:
    """Compile every named kernel not yet built, all ``nvcc`` runs at once.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the ones compiled
    here; raises with the compiler's output if any build fails.
    """
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)  # atomic publish: a reader never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, building it first if needed.
    Each wrapper loads once and keeps the handle."""
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    return ctypes.CDLL(str(path))


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel's launch count, read and
    zeroed by callers as a plain attribute).  ``+= 1`` is a read, an add and
    a store, so two threads launching at once (an ingest worker and the
    query thread) could lose a count; one lock makes every increment whole."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        err = getattr(lib, f"{prefix}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{prefix} launch failed: {err(code).decode()} (cudaError {code})")


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` current for a launch; yields its current stream
    handle.  Enters a device context only when another device is current."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            yield torch.cuda.current_stream(device).cuda_stream
    else:
        yield torch.cuda.current_stream(device).cuda_stream
