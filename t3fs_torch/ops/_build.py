"""Build and load the CUDA kernel libraries (nvcc by hand, bound with ctypes).

Each source in t3fs_torch/csrc/ becomes one shared library with a plain C
interface, compiled for sm_90a at first use into t3fs_torch/_build/ (listed
in .gitignore), under a name keyed by a hash of the source, the shared
headers and the flags, so an edited source or header rebuilds and an
unchanged one loads.  All missing libraries compile in parallel, one nvcc
each.  The one host library is built the same way by the host compiler
(host_library): the native chunk engine with the host CRC32C, the
io_uring read engine, the usrbio shm rings and the io_uring frame pump of
the native transport (csrc/chunk_engine.cpp, csrc/aio_reader.cpp,
csrc/usrbio.cpp and csrc/net_pump.cpp, with the flags of the reference's
t3fs/native/build.py, its sanitizer switch T3FS_SANITIZE included).
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_LIB = "native_storage"
HOST_SOURCES = ("chunk_engine.cpp", "aio_reader.cpp", "usrbio.cpp",
                "net_pump.cpp")
HOST_CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                  *(("-msse4.2",) if platform.machine() in ("x86_64", "AMD64")
                    else ()))
# linked with -lrt as t3fs/native/build.py links it: shm_open and shm_unlink
# (usrbio.cpp) live in librt before glibc 2.34
HOST_LDFLAGS = ("-lrt",)
SANITIZERS = ("thread", "address")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# every exported function of each library: name -> argument types
SIGNATURES: dict[str, dict[str, list]] = {
    "crc_words": {
        "t3fs_crc_seg_words": [_P, _LL, _P, _P, _P],
        "t3fs_crc32c_words_raw": [_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P],
    },
    "rs_raid6_words": {
        "t3fs_rs_raid6_words": [_P, _P, _LL, _I, _LL, _I, _P],
    },
    "rs_reconstruct_words": {
        "t3fs_rs_reconstruct_words": [_P, _P, _LL, _I, _I, _LL, _P, _I, _P],
    },
    "repair_words": {
        "t3fs_repair_words": [_P, _P, _LL, _I, _I, _I, _LL, _P, _I, _I, _I, _P],
    },
    "rs_bitmatmul": {
        "t3fs_rs_bitmatmul": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _LL, _I,
                              _P],
    },
    "crc_bytes": {
        "t3fs_crc32c_bytes_raw": [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P],
    },
    "copy3d": {
        "t3fs_copy3d": [_P, _P, _LL, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) of this process's builds
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, of every header
    in csrc/ (a header edit rebuilds whatever may include it) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every library that is not built yet, all nvcc runs at once."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    procs = []
    for name in SIGNATURES:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            errors.append(f"{name}.cu (nvcc rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.t3fs_error_string.argtypes = [ctypes.c_int]
            lib.t3fs_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if rc:
        msg = lib.t3fs_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def host_flags() -> tuple[tuple[str, ...], str]:
    """The host compiler's flags and the host library's name, from
    T3FS_SANITIZE: unset or empty gives HOST_CXX_FLAGS; "thread" or
    "address" builds at -O1 with that sanitizer and frame pointers, under a
    name of its own (python itself is not instrumented, so the process needs
    the sanitizer's runtime loaded first:
    LD_PRELOAD=$(g++ -print-file-name=libtsan.so)).  Any other value raises
    rather than build an uninstrumented library under a sanitizer run."""
    mode = os.environ.get("T3FS_SANITIZE", "")
    if not mode:
        return HOST_CXX_FLAGS, HOST_LIB
    if mode not in SANITIZERS:
        raise ValueError(f"T3FS_SANITIZE={mode!r}: use 'thread' or 'address'")
    flags = tuple("-O1" if f == "-O2" else f for f in HOST_CXX_FLAGS)
    return ((*flags, f"-fsanitize={mode}", "-fno-omit-frame-pointer"),
            f"{HOST_LIB}.{mode[0]}san")


def _host_target() -> Path:
    flags, name = host_flags()
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update((SRC_DIR / src).read_bytes())
    h.update(" ".join((*flags, *HOST_LDFLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def host_library() -> ctypes.CDLL:
    """The loaded host library (HOST_SOURCES), built first by the host C++
    compiler if needed (raises RuntimeError where there is none)."""
    with _lock:
        lib = _libs.get(HOST_LIB)
        if lib is None:
            out = _host_target()
            if not out.exists():
                cxx = os.environ.get("CXX") or shutil.which("g++") \
                    or shutil.which("c++")
                if cxx is None:
                    raise RuntimeError("no host C++ compiler (g++, c++, $CXX)")
                BUILD_DIR.mkdir(exist_ok=True)
                tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
                proc = subprocess.run(
                    [cxx, *host_flags()[0], "-o", str(tmp),
                     *(str(SRC_DIR / src) for src in HOST_SOURCES), *HOST_LDFLAGS],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                build_logs[HOST_LIB] = proc.stdout
                if proc.returncode:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{', '.join(HOST_SOURCES)} "
                                       f"(rc={proc.returncode}):\n{proc.stdout}")
                os.replace(tmp, out)
            lib = _libs[HOST_LIB] = ctypes.CDLL(str(out))
        return lib
