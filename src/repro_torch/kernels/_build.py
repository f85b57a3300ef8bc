"""Build the CUDA sources under ``kernels/csrc/`` at first use and load
them with :mod:`ctypes`.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``build/repro_torch/``
at the repository root, named by a hash of the sources and flags, so an
edited source never loads a stale library.  Nothing is built or loaded
while a module is imported: the wrappers call :func:`load` when they
first launch.

Run ``python -m repro_torch.kernels._build`` to build every kernel (one
``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("stencil7", "fused_cg")
#: where the CUDA toolkit installs nvcc when neither CUDA_HOME nor PATH
#: names it
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[Tuple[str, str], Callable] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch cannot be "
        "built; CPU tensors take the plain PyTorch path instead")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _command(compiler: str, name: str, out: Path) -> List[str]:
    return [compiler, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES) -> Dict[str, Tuple[Path, str]]:
    """Compile every missing library among ``names`` in parallel.

    Returns ``{name: (library path, compiler output)}``; a library that
    was already built reports an empty output.  Raises ``RuntimeError``
    with the compiler's output when any build fails."""
    done: Dict[str, Tuple[Path, str]] = {}
    missing = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            done[name] = (out, "")
        else:
            missing.append((name, out))
    if not missing:
        return done
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, out in missing:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs[name] = (out, tmp, subprocess.Popen(
            _command(compiler, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (out, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """C function ``symbol`` of ``csrc/<name>.cu`` with its ``ctypes``
    signature declared (pointers and the stream as ``c_void_p``, so
    64-bit addresses are not cut to C ints)."""
    key = (name, symbol)
    fn = _FUNCTIONS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCTIONS[key] = fn
    return fn


if __name__ == "__main__":
    for lib_name, (lib_path, output) in build().items():
        print(f"{lib_name}: {lib_path}")
        if output:
            print(output)
