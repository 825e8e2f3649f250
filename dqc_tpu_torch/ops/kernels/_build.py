"""Build and load the hand-written CUDA kernels of ``dqc_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded with
ctypes. The libraries go to ``build/dqc_tpu_torch/`` at the root of the
checkout (git-ignored), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. All sources build
in parallel, one ``nvcc`` process each, at the first kernel launch (or on
``build_all()``), each process's output read by a thread of its own (so
that none waits on a full pipe) and its wall time kept in ``build_seconds``.
A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
             "block_backward_high_small", "high_apply_small")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # ptxas report per library of this process
build_seconds: Dict[str, float] = {}   # nvcc wall time per library built


def _short_name(hit: str, mangled: str) -> str:
    """``hit<a,b>``: a function's name and its integer / bool template
    arguments out of its mangled name (``n`` marks a negative one)."""
    args = re.search(re.escape(hit) + r"I((?:L[ib]n?\d+E)+)E", mangled)
    targs = re.findall(r"L[ib](n?\d+)E", args.group(1)) if args else []
    return f"{hit}<{','.join(t.replace('n', '-') for t in targs)}>"


def kernel_resources(substrings) -> Dict[str, list]:
    """From this process's build (``build_log``, nvcc's ``-Xptxas -v``
    report): each kernel whose mangled name holds one of ``substrings``, by
    library, as ``{"kernel", "registers", "spill_stores", "spill_loads"}``
    (bytes) with the kernel's name and template arguments shortened to
    ``name<a,b>``; and each device function the kernels call without
    inlining it whose name holds one, once, as ``{"function",
    "spill_stores", "spill_loads"}`` (it runs within its kernel's
    registers)."""
    out: Dict[str, list] = {}
    for lib, text in build_log.items():
        entry, kernel, found, seen = None, None, [], set()
        for line in text.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
                hit = next((k for k in substrings if k in kernel), None)
                entry = {"kernel": _short_name(hit, kernel)} if hit else None
                if entry:
                    found.append(entry)
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m and m.group(1) != kernel:
                name = m.group(1)
                hit = next((k for k in substrings if k in name), None)
                entry = None
                if hit and name not in seen:
                    seen.add(name)
                    entry = {"function": _short_name(hit, name)}
                    found.append(entry)
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
        if found:
            out[lib] = found
    return out


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
    t0 = time.perf_counter()

    def finish(name: str) -> str:
        out, _ = procs[name][0].communicate()
        build_seconds[name] = time.perf_counter() - t0
        return out

    try:
        for name, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
        with ThreadPoolExecutor(max_workers=len(procs)) as pool:
            outs = dict(zip(procs, pool.map(finish, procs)))
        failed = []
        for name, (p, tmp) in procs.items():
            out = outs[name]
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
