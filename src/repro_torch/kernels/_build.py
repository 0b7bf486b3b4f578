"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source in ``src/repro_torch/csrc/*.cu`` has a plain C interface and
includes no PyTorch header, so one ``nvcc`` per source takes seconds. The
first call of ``library()`` builds all of them at once, one ``nvcc`` process
per source, all started together, for ``sm_90a``, into ``build/repro_torch/``
at the repository root (listed in ``.gitignore``). Each library's file name
carries a hash of its sources and flags, so an edited source is rebuilt and
an unchanged one is reused. A build that fails raises with the compiler's
output; nothing falls back to another implementation.
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
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("nstep_returns", "vtrace", "flash_attention",
           "flash_attention_bf16", "decode_attention", "mla_decode",
           "mla_decode_bf16", "ssd_scan", "ssd_scan_bf16")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # wall seconds of each nvcc this process ran


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from src/repro_torch/csrc at first use")


def target(name: str) -> Path:
    """Path of the shared library for ``csrc/<name>.cu`` at its content hash."""
    h = hashlib.sha256()
    for dep in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of ``name``'s last build."""
    log = target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    ``{name: library path}``. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: target(name) for name in SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for name, out in paths.items():
        if out.is_file():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def error_string(name: str, code: int) -> str:
    """CUDA's text for error ``code``, from ``csrc/<name>.cu``'s
    ``<name>_error_string``."""
    fn = getattr(library(name), f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def call_on(device, fn, *args):
    """``fn(*args, stream)`` with ``stream`` the current CUDA stream of
    ``device``, a torch device of a tensor; enters ``device`` only when it
    is not the thread's current one, since a launch goes to the current
    device."""
    import torch

    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    return fn(*args, torch.cuda.current_stream().cuda_stream)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds all sources first
    if they are not loaded yet."""
    with _lock:
        if not _libs:
            for lib_name, path in build_all().items():
                _libs[lib_name] = ctypes.CDLL(str(path))
        return _libs[name]
