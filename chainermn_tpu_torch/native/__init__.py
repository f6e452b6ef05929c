"""Host-side native code of the port: the threaded batch assembler
(``dataloader.cpp``, a copy of the JAX package's
``_native/dataloader.cpp``) behind :class:`~chainermn_tpu_torch.iterators.
PrefetchIterator`.

Compiled with ``g++`` the first time it is needed (a plain C interface,
loaded by :mod:`ctypes`), keyed by a hash of the source, into
``chainermn_tpu_torch/_build/`` (listed in ``.gitignore``).  Nothing is
compiled at import.  Unlike the JAX package, a failed build raises
:class:`NativeBuildError`: the iterator never falls back to assembling
batches on the consumer thread in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCE = _DIR / "dataloader.cpp"

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused the source."""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"dataloader-{digest}.so"


def build() -> Path:
    """Compile ``dataloader.cpp`` unless this source's library exists;
    returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not build {SOURCE.name}: {e}") \
            from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_dataloader() -> ctypes.CDLL:
    """The loader library with its C signatures declared (built on first
    use; raises :class:`NativeBuildError` if it cannot be built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_submit.restype = ctypes.c_int64
        lib.loader_submit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.loader_slot_ptr.restype = ctypes.c_void_p
        lib.loader_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.loader_release.restype = None
        lib.loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
