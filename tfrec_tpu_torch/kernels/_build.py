"""Build the port's native sources and load them with ``ctypes``.

Each CUDA source ``kernels/csrc/<name>.cu`` has a plain C interface
(``extern "C"`` functions taking raw pointers, sizes and a stream,
returning ``cudaGetLastError()``) and compiles alone with ``nvcc`` into
``build/tfrec_tpu_torch/lib<name>.so`` under the checkout, for ``sm_90a``
(Hopper). No source includes PyTorch's headers, so a build takes seconds.
The repository's host parsers, ``csrc/<name>.cpp``, compile the same way
with ``g++`` (``load_host``). That directory is the port's own, apart from
the JAX package's ``build/``, so the two packages never write the same
library. A library is rebuilt when it is missing or older than its source;
it is compiled under a temporary name and renamed, so a process never
loads a half-written file, and a lock keeps the threads of one process from
building it twice. Nothing is compiled while a module is imported, only
when a library is first used (or ``build()`` is called).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
HOST_CSRC_DIR = REPO_ROOT / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "tfrec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """A host parser could not be built or loaded (no g++, or it failed)."""


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of tfrec_tpu_torch are compiled "
        "with the CUDA toolkit's nvcc at first use (put nvcc on PATH or set "
        "CUDA_HOME)"
    )


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def _stale(src: Path, lib: Path) -> bool:
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _compile(command: Callable[[Path], List[str]], src: Path, out: Path) -> str | None:
    """Run ``command(tmp)``, which compiles ``src`` into ``tmp``, then rename
    ``tmp`` to ``out``; returns the compiler's output on failure, else
    None."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
    except FileNotFoundError as e:  # no compiler
        return f"{src.name}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{src.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
    os.replace(tmp, out)
    return None


def build(names: Iterable[str] | None = None) -> float:
    """Compile the named sources (all by default) that are missing or
    stale, one ``nvcc`` process per source, all started together. Returns
    the seconds it took; raises with nvcc's output if any source fails."""
    todo = [n for n in (sources() if names is None else names)
            if _stale(CSRC_DIR / f"{n}.cu", library_path(n))]
    start = time.perf_counter()
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            errors = [e for e in pool.map(
                lambda n: _compile(lambda tmp: nvcc_command(nvcc, n, tmp), CSRC_DIR / f"{n}.cu",
                                   library_path(n)), todo) if e]
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp`` (a plain C
    interface), built with g++ first if needed; raises ``NativeUnavailable``
    with the compiler's output if it cannot be built or loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src, out = HOST_CSRC_DIR / f"{name}.cpp", library_path(name)
        if _stale(src, out):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            err = _compile(lambda tmp: ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)], src, out)
            if err:
                raise NativeUnavailable(f"failed to build {out}: {err}")
        try:
            lib = _loaded[name] = ctypes.CDLL(str(out))
        except OSError as e:
            raise NativeUnavailable(f"failed to load {out}: {e}") from e
        return lib


def function(name: str, symbol: str, argtypes: List[type]):
    """C function ``symbol`` of ``csrc/<name>.cu``, returning an int error
    code. Pointers and the stream must be declared ``c_void_p`` and sizes
    ``c_longlong``: undeclared, ctypes would pass them as 32-bit ints.
    Looked up once; later calls return the same declared function."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch was refused (the C side returns cudaGetLastError();
    a refused launch never runs, and synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
