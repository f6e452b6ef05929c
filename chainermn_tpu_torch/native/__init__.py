"""Host-side native code of the port: the threaded batch assembler
(``dataloader.cpp``, a copy of the JAX package's
``_native/dataloader.cpp``) behind :class:`~chainermn_tpu_torch.iterators.
PrefetchIterator`, and the TCP object-plane transport (``hostcomm.cpp``,
a copy of ``_native/hostcomm.cpp``) behind
:class:`~chainermn_tpu_torch.hostcomm.HostComm`.

Each is compiled with ``g++`` the first time it is needed (a plain C
interface, loaded by :mod:`ctypes`), keyed by a hash of the source, into
``chainermn_tpu_torch/_build/`` (listed in ``.gitignore``).  Nothing is
compiled at import.  Unlike the JAX package, a failed build raises
:class:`NativeBuildError`: the iterator never falls back to assembling
batches on the consumer thread in silence, and the object plane has no
other transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCE = _DIR / "dataloader.cpp"
HOSTCOMM_SOURCE = _DIR / "hostcomm.cpp"

_lock = threading.Lock()
_lib = None
_hostcomm = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused the source."""


def library_path(source: Optional[Path] = None) -> Path:
    source = SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (default ``dataloader.cpp``) unless its
    library exists; returns the library's path."""
    source = SOURCE if source is None else source
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not build {source.name}: {e}") \
            from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed on {source.name}:\n"
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


def load_hostcomm() -> ctypes.CDLL:
    """The object-plane transport with its C signatures declared (built on
    first use; raises :class:`NativeBuildError` if it cannot be built)."""
    global _hostcomm
    with _lock:
        if _hostcomm is not None:
            return _hostcomm
        lib = ctypes.CDLL(str(build(HOSTCOMM_SOURCE)))
        lib.hostcomm_init.restype = ctypes.c_void_p
        lib.hostcomm_init.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.hostcomm_send.restype = ctypes.c_int
        lib.hostcomm_send.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.hostcomm_recv.restype = ctypes.c_int64
        lib.hostcomm_recv.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.hostcomm_destroy.restype = None
        lib.hostcomm_destroy.argtypes = [ctypes.c_void_p]
        _hostcomm = lib
        return lib
