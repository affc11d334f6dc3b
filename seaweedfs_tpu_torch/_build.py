"""First-use build of the port's native sources into shared libraries.

Five libraries, each built from `csrc/` by its own compiler and loaded
with ctypes through a plain C interface:

  gf_matmul        csrc/gf_matmul.cu   nvcc, sm_90a  the GF(2^8) apply
                                                     kernel, default tile
  gf_matmul_tiled  csrc/gf_matmul_     nvcc, sm_90a  the same kernel with
                   tiled.cu (includes                the tiled loop, for
                   gf_matmul.cu)                     every other tile
  crc32c           csrc/crc32c.cc      g++           the needle checksum
  gf_native        csrc/gf_native.cc   g++           the host GF(2^8) codec
                                                     (AVX2; GFNI by CPUID)
  aes_gcm          csrc/aes_gcm.cc     g++           the chunk cipher
                                                     (AES-NI by CPUID)

A library is built the first time it is loaded, into `build/torch_kernels/`
at the repository root (git-ignored), under a name keyed by a hash of its
source, the sources it includes and its command line, so an edited
source rebuilds and a stale library is never loaded.  `build()` starts
every missing compile at once and waits for all of them; `start()` and
`finish()` are its halves, for a caller with other work to do
meanwhile.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

_SOURCES = {"gf_matmul": "gf_matmul.cu",
            "gf_matmul_tiled": "gf_matmul_tiled.cu", "crc32c": "crc32c.cc",
            "gf_native": "gf_native.cc", "aes_gcm": "aes_gcm.cc"}
# sources a library's source includes: they key its build too
_INCLUDES = {"gf_matmul_tiled": ("gf_matmul.cu",)}

_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
_SIGNATURES = {
    "gf_matmul": {
        "gf_apply_u8": (ctypes.c_int, [
            _PTR, ctypes.c_int, ctypes.c_int,   # tables, m, k
            _PTR, _I64, _I64,                   # x, unit stride, row stride
            _PTR, _I64, _I64,                   # out, unit stride, row stride
            _I64, ctypes.c_int, ctypes.c_int,   # n, units, launch tile
            _PTR]),                             # stream
    },
    "crc32c": {
        "wn_crc32c": (ctypes.c_uint32,
                      [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]),
    },
    "gf_native": {
        "wn_gf_init": (None, []),
        "wn_gf_matmul_ptrs": (None, [
            _PTR, ctypes.c_int, ctypes.c_int,   # mat, rows, k
            ctypes.POINTER(_PTR), ctypes.POINTER(_PTR),  # in, out rows
            ctypes.c_size_t]),                  # n
        "wn_gf_set_impl": (None, [ctypes.c_int]),
        "wn_gf_impl": (ctypes.c_int, []),
    },
    "aes_gcm": {
        "wn_aes256_gcm_seal": (None, [
            _PTR, _PTR, _PTR, ctypes.c_size_t,  # key, nonce, aad, aad bytes
            _PTR, _PTR, ctypes.c_size_t,        # in, out, bytes
            _PTR]),                             # tag
        "wn_aes256_gcm_open": (ctypes.c_int, [
            _PTR, _PTR, _PTR, ctypes.c_size_t,
            _PTR, _PTR, ctypes.c_size_t, _PTR]),
    },
}
_SIGNATURES["gf_matmul_tiled"] = _SIGNATURES["gf_matmul"]  # the same entry
# the g++ libraries' ISA flags on x86-64
_ISA = {"crc32c": ["-msse4.2"], "gf_native": ["-mavx2", "-mssse3"],
        "aes_gcm": []}

# called once, under the load lock, right after a library is loaded: the
# host codec's tables must be built before any thread multiplies
_INIT = {"gf_native": "wn_gf_init"}

# compiler output of the builds this process ran (ptxas register and
# shared-memory report for the kernel), by library name
LOG: dict[str, str] = {}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the GF(2^8) kernel")


def _command(name: str, out: str) -> list[str]:
    src = str(CSRC / _SOURCES[name])
    if name in ("gf_matmul", "gf_matmul_tiled"):
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", out, src]
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: needed to build the {name} "
                           f"library")
    # fixed ISA flags, never -march=native: the library's name is keyed by
    # this command line, which must mean the same code on every host.  The
    # host codec's GFNI path and the cipher's AES-NI path have their own
    # `target` attribute and a CPUID check, so the codec needs nothing past
    # AVX2 to load, and the cipher nothing past the x86-64 baseline
    isa = []
    if platform.machine() in ("x86_64", "AMD64"):
        isa = _ISA[name]
    return [gxx, "-O3", *isa, "-shared", "-fPIC", "-o", out, src]


def library_path(name: str) -> Path:
    """Where `name` lives once built: keyed by source bytes + flags."""
    h = hashlib.sha256((CSRC / _SOURCES[name]).read_bytes())
    for inc in _INCLUDES.get(name, ()):
        h.update((CSRC / inc).read_bytes())
    h.update(" ".join(_command(name, "OUT")[1:]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(_SOURCES)) -> dict[str, float]:
    """Build every library in `names` that is not built yet, all compiles
    running at once.  Returns {name: seconds} for the ones it built;
    raises RuntimeError with the compiler's output if any compile fails."""
    return finish(start(names))


def start(names=tuple(_SOURCES)) -> dict:
    """Start the compile of every library in `names` that is not built
    yet, all at once, and return without waiting: `finish` waits for
    them, `stop` ends them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = []  # every command first: a missing compiler starts nothing
    for name in names:
        target = library_path(name)
        if not target.exists():
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            todo.append((name, target, tmp, _command(name, tmp)))
    return {name: (target, tmp, time.perf_counter(), subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, target, tmp, cmd in todo}


def stop(procs: dict) -> None:
    """End the compiles `start` began and remove what they wrote."""
    for _, tmp, _, proc in procs.values():
        proc.kill()
        proc.communicate()
        if os.path.exists(tmp):
            os.remove(tmp)


def finish(procs: dict) -> dict[str, float]:
    """Wait for the compiles `start` began; {name: seconds from its start}
    for each, or RuntimeError with the compiler's output if any failed."""
    took: dict[str, float] = {}
    failed = []
    for name, (target, tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a racing process sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The built library `name` with its C signatures declared, built on
    first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            if name in _INIT:
                getattr(lib, _INIT[name])()
            _loaded[name] = lib
    return lib
