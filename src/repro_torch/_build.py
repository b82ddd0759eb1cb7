"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, into an object under ``build/repro_torch/`` at the
root of the checkout; the objects are linked into one shared library with
a plain C interface and loaded with :mod:`ctypes`. The build runs at the
first launch of a kernel (never at import, so the CPU-only tests import
every module without a compiler) and is reused while the sources are
unchanged: the library's name carries a hash of them. A table that both
Python and the kernels need has one source, in Python: the module that
owns it registers a header in :data:`GENERATED` at import, and the build
writes it beside the objects.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# headers generated from Python tables: file name -> text
GENERATED: dict[str, str] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, text in sorted(GENERATED.items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def compile_command(src: Path, obj: Path, compiler: str = "nvcc",
                    include: Path | None = None) -> list[str]:
    """The ``nvcc`` line that compiles one source for Hopper (sm_90a),
    finding the generated headers in ``include``."""
    inc = ["-I", str(include)] if include is not None else []
    return [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", *inc, "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]


def link_command(objs: list[Path], lib: Path, compiler: str = "nvcc") -> list[str]:
    return [compiler, *ARCH_FLAGS, "-shared", "-o", str(lib),
            *map(str, objs)]


class Library:
    """The compiled kernels of the port: built once, loaded once.

    ``path`` is the loaded library's file, ``build_seconds`` the wall
    time of the last build (0 when an up-to-date library was found),
    ``ptxas_log`` what ``ptxas -v`` said about registers, shared memory
    and spills.
    """

    def __init__(self):
        self._lib = None
        self.path = None
        self.build_seconds = 0.0
        self.ptxas_log = ""

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            self.path = self._build()
            self._lib = self._load(self.path)
        return self._lib

    def _build(self) -> Path:
        key = _source_hash()
        lib = BUILD_DIR / f"libssam_{key}.so"
        if lib.exists():
            return lib
        cc = nvcc()
        include = BUILD_DIR / f"include_{key}_{os.getpid()}"
        include.mkdir(parents=True, exist_ok=True)
        for name, text in GENERATED.items():
            (include / name).write_text(text)
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sources():
            obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                compile_command(src, obj, cc, include),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        self.ptxas_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{self.ptxas_log}")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(link_command(objs, tmp, cc), capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
        for obj in objs:
            obj.unlink()
        shutil.rmtree(include)
        self.build_seconds = time.perf_counter() - t0
        return lib

    @staticmethod
    def _load(path: Path) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        ints, floats = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(
            ctypes.c_float)
        # the epilogue: bias, residual, ops, values, count
        epi = [p, p, ints, floats, i]
        lib.ssam_window_launch.argtypes = [p, p, i, p, p, ints, i] + epi + [p]
        lib.ssam_window_launch.restype = i
        lib.ssam_scan_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.ssam_scan_launch.restype = i
        lib.ssam_window_reduce_launch.argtypes = (
            [p, p, i, p, p, i] + epi + [i] * 22 + [p])
        lib.ssam_window_reduce_launch.restype = i
        lib.ssam_wgrad_launch.argtypes = ([p, p, i, p, p] + [i] * 22
                                          + [ctypes.POINTER(ctypes.c_int), p])
        lib.ssam_wgrad_launch.restype = i
        lib.ssam_wgrad_tc_launch.argtypes = (
            [p, p, i, p, p] + [i] * 24 + [ctypes.POINTER(ctypes.c_int)] * 4
            + [i] * 4 + [p])
        lib.ssam_wgrad_tc_launch.restype = i
        lib.ssam_mxu_tc_launch.argtypes = (
            [p, p, i, p, p] + epi + [i] * 24 + [p])
        lib.ssam_mxu_tc_launch.restype = i
        lib.ssam_mxu_window_launch.argtypes = ([p, p, i, p, p, ints, i]
                                               + epi + [p])
        lib.ssam_mxu_window_launch.restype = i
        lib.ssam_window_perlane_launch.argtypes = (
            [p, p, i, p, ints, i] + epi + [i] * 5 + [p])
        lib.ssam_window_perlane_launch.restype = i
        lib.ssam_mxu_perlane_launch.argtypes = (
            [p, p, i, p, ints, i] + epi + [i] * 6 + [p])
        lib.ssam_mxu_perlane_launch.restype = i
        lib.ssam_wgrad_perlane_launch.argtypes = [p, p, i, p, p] + [i] * 8 + [p]
        lib.ssam_wgrad_perlane_launch.restype = i
        return lib


LIBRARY = Library()
