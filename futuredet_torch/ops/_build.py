"""Builds and loads the port's CUDA kernels and its host C++ library.

Each `futuredet_torch/csrc/*.cu` is compiled by `nvcc`, and each
`futuredet_torch/csrc/*.cpp` (host code: the metric engine's matcher) by
`g++ -O3 -shared -fPIC`, into its own shared library with a plain C
interface, named after the hash of its source and flags, under
`build/torch_kernels/` at the root of the checkout, and loaded with
`ctypes`. A source is built at its first use and again when its hash
changes; `build_all` starts one compiler per source at once. Nothing here
runs at import, so importing the package never needs a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nms_kernel.cu must round as its plain PyTorch version: no contraction
EXTRA_FLAGS = {"nms_kernel.cu": ["-fmad=false"]}
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]
SUFFIXES = (".cu", ".cpp")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _cxx() -> str:
    for cxx in (os.environ.get("CXX"), "g++", "c++"):
        found = cxx and shutil.which(cxx)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++) found: the host library "
                       "csrc/*.cpp builds only where one is installed")


def _compiler(name: str) -> str:
    return _nvcc() if name.endswith(".cu") else _cxx()


def _flags(name: str) -> List[str]:
    if name.endswith(".cpp"):
        return CXX_FLAGS
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / name).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{Path(name).stem}_{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Compile every named source (default: all of csrc/*.cu and *.cpp)
    whose library is missing, one compiler process each, all at once.
    Returns the seconds each build took (0 for a library already built);
    the compiler's output (for nvcc, ptxas register and shared-memory
    lines) goes to `<library>.log`."""
    names = names or sorted(p.name for p in CSRC.iterdir()
                            if p.suffix in SUFFIXES)
    secs = {n: 0.0 for n in names if _target(n).exists()}
    todo = [n for n in names if n not in secs]
    if not todo:
        return secs
    compilers = {n: _compiler(n) for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [compilers[name], *_flags(name), "-o", str(tmp),
               str(CSRC / name)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (see {out.with_suffix('.log')})")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError(f"the build failed for {', '.join(failed)}")
    return secs


def build_log(name: str) -> str:
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
