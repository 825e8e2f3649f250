"""Build and load the hand-written CUDA kernels of ``dqc_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded with
ctypes. The libraries go to ``build/dqc_tpu_torch/`` at the root of the
checkout (git-ignored), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. All sources build
in parallel, one ``nvcc`` process each, at the first kernel launch (or on
``build_all()``). A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dqc_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LIBRARIES = ("dual_apply", "high_apply", "gram", "block_backward_dual",
             "block_backward_high", "merged_fact_apply",
             "block_backward_merged_fact", "diag", "dual_multi_apply",
             "high_multi_apply", "block_backward_sublane")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # ptxas report per library of this process


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME, "
                       "default /usr/local/cuda): the CUDA kernels of "
                       "dqc_tpu_torch cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library that is missing, all nvcc processes at once.
    Returns the library paths; raises RuntimeError on a failed build."""
    targets = {name: _target(name) for name in LIBRARIES}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, Path]] = {}
    try:
        for name, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for name, (p, tmp) in procs.items():
            out, _ = p.communicate()
            build_log[name] = out
            if p.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu "
                              f"(exit {p.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for p, tmp in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every library at first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _loaded[name] = lib
        return lib
