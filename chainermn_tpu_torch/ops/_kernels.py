"""Build and load the port's hand-written CUDA kernels.

Each source under ``chainermn_tpu_torch/csrc/`` exposes a plain C
interface.  It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library the first time a wrapper needs it, keyed by a hash of the
source, the headers it includes and the flags, under
``chainermn_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded
with :mod:`ctypes`; ``nvcc``'s output is kept beside the library as
``lib<name>_<hash>.log``.  Nothing is compiled when
this module is imported: the CPU tests import every module of the port and
never build anything.

Building through ``torch.utils.cpp_extension.load`` would include
PyTorch's headers and take minutes per build; a plain C interface builds in
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: set to ``1`` to build the kernels with their hang watchdog: an
#: ``mbarrier`` wait that lasts about ten seconds traps, so a broken
#: pipeline fails its launch instead of hanging the card.  The trap ends
#: the CUDA context, so production builds leave it out; the card tests
#: turn it on.
WATCHDOG_ENV = "CMN_KERNEL_WATCHDOG"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s diagnostics per source built by this process (``-Xptxas
#: -v`` prints each kernel's registers, shared memory and spills).
build_logs: Dict[str, str] = {}


def refuse_export(name: str) -> None:
    """Raise when a ``torch.export`` trace reaches kernel ``name``'s
    wrapper: the kernels are ``ctypes`` launches an exported program
    cannot record, and tracing the plain version in their place would
    export a different program (``utils/export.py``)."""
    import torch

    is_exporting = getattr(torch.compiler, "is_exporting", None)
    if is_exporting is not None and is_exporting():
        raise RuntimeError(
            f"{name}: a hand-written kernel cannot be exported with "
            "torch.export; export a forward that does not reach it")


def nvcc_flags() -> tuple:
    """:data:`NVCC_FLAGS`, with the watchdog's macro when
    :data:`WATCHDOG_ENV` is set to ``1``."""
    if os.environ.get(WATCHDOG_ENV) == "1":
        return NVCC_FLAGS + ("-DCMN_KERNEL_WATCHDOG",)
    return NVCC_FLAGS


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source on the card's host"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    recursively (the headers sit beside it in ``csrc/``)."""
    todo, seen = [CSRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC_DIR / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    """The library's path, keyed by the source, its headers and the
    flags: a changed header rebuilds it."""
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, all
    ``nvcc`` processes started together; returns each library's path.
    Raises with the compiler's output if any build fails."""
    names = list(names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    flags = nvcc_flags()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *flags, "-o", tmp, str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"nvcc failed for csrc/{n}.cu:\n{log}")
        else:
            # Atomic publish: another process building at the same time
            # never loads a partial library, and a published library
            # always has its log.
            log_tmp = tmp + ".log"
            Path(log_tmp).write_text(log)
            os.replace(log_tmp, out[n].with_suffix(".log"))
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_log(name: str):
    """``nvcc``'s output for the current library of ``csrc/<name>.cu``:
    this process's build, else the log kept beside the library by the
    process that built it; None if neither exists."""
    if name in build_logs:
        return build_logs[name]
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


#: the instructions :func:`sass_counts` counts: Hopper's warpgroup product,
#: the warp-level product of earlier generations, the TMA tile load, the
#: 1-D bulk copy (``cp.async.bulk``, no tensor map) and the per-thread
#: asynchronous copy (``cp.async``).
SASS_OPCODES = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "LDGSTS")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.MULTILINE)
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def sass_counts(text: str) -> Dict[str, Dict[str, int]]:
    """Per function of a ``cuobjdump -sass`` listing, how many of its
    instructions are each of :data:`SASS_OPCODES` (by the opcode before
    its first ``.``)."""
    out: Dict[str, Dict[str, int]] = {}
    marks = list(_FUNCTION.finditer(text))
    for i, m in enumerate(marks):
        end = marks[i + 1].start() if i + 1 < len(marks) else len(text)
        counts = dict.fromkeys(SASS_OPCODES, 0)
        for op in _OPCODE.findall(text, m.end(), end):
            if op in counts:
                counts[op] += 1
        out[m.group(1)] = counts
    return out


_SERIALIZED = re.compile(
    r"\(C75\d\d\) Potential Performance Loss: wgmma\.mma_async "
    r"instructions are serialized[^']*'([^']+)'")


def serialized_wgmma(log: str) -> List[str]:
    """The functions whose ``wgmma`` instructions ptxas serialized (each
    waited for before the next issues), from the C75xx warnings of an
    ``nvcc -Xptxas -v`` log such as :func:`build_log` returns."""
    return sorted(set(_SERIALIZED.findall(log)))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_resources(log: str) -> Dict[str, Dict[str, int]]:
    """Per entry function of an ``nvcc -Xptxas -v`` log (such as
    :func:`build_log` returns): its registers, stack frame and spill
    bytes (None where ptxas printed no such line)."""
    out: Dict[str, Dict[str, int]] = {}
    marks = list(_ENTRY.finditer(log))
    for i, m in enumerate(marks):
        end = marks[i + 1].start() if i + 1 < len(marks) else len(log)
        frame = _FRAME.search(log, m.end(), end)
        regs = _REGS.search(log, m.end(), end)
        out[m.group(1)] = {
            "registers": int(regs.group(1)) if regs else None,
            "stack_bytes": int(frame.group(1)) if frame else None,
            "spill_stores": int(frame.group(2)) if frame else None,
            "spill_loads": int(frame.group(3)) if frame else None,
        }
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    lib = build([name])[name]
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
