"""Model export of the port (``chainermn_tpu/utils/export.py``): a
trained forward frozen into one portable ``torch.export`` artifact.

:func:`export_forward` traces ``fn`` at the example arguments' shapes
and dtypes (parameters closed over are baked in as constants of the
program) and serializes the ``ExportedProgram``; :func:`load_forward`
turns the bytes back into a callable that needs none of the model code.
``poly_batch=True`` makes the leading dimension of every tensor argument
symbolic (``torch.export.Dim``), so one artifact serves any batch size;
without it the artifact accepts only the traced shapes.

The port's hand-written kernels are ``ctypes`` launches that
``torch.export`` cannot record, so a forward that reaches one of them
(the flash-attention, decode-attention or fused-conv wrappers) is
refused at export time, on the card and on the CPU alike, rather than
exported through the kernel's plain PyTorch version.  What holds today:
an exported forward reaches no port kernel (the example's classifier is
an MLP).
"""

from __future__ import annotations

import io
import os
from typing import Any, Callable

import torch
from torch.export import Dim, export


class _Forward(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_forward(fn: Callable, *example_args: Any,
                   poly_batch: bool = False) -> bytes:
    """Trace ``fn(*example_args)`` and serialize it (``torch.export.
    save``).  ``poly_batch=True`` exports a symbolic leading dimension
    on every tensor argument; the example arguments still give the
    trailing dimensions and the dtypes."""
    args = tuple(torch.as_tensor(a) for a in example_args)
    wrapped = not isinstance(fn, torch.nn.Module)
    module = _Forward(fn) if wrapped else fn
    dynamic = None
    if poly_batch:
        batch = Dim("batch")
        dynamic = tuple({0: batch} if a.dim() else None for a in args)
        if wrapped:  # one ``*args`` parameter
            dynamic = (dynamic,)
    program = export(module, args, dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_forward(blob: bytes) -> Callable:
    """The inverse of :func:`export_forward`: a callable that runs the
    serialized program."""
    return torch.export.load(io.BytesIO(blob)).module()


def save_forward(path: str, fn: Callable, *example_args: Any,
                 poly_batch: bool = False) -> str:
    """:func:`export_forward` to a file (written whole, then renamed)."""
    blob = export_forward(fn, *example_args, poly_batch=poly_batch)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def load_forward_file(path: str) -> Callable:
    with open(path, "rb") as f:
        return load_forward(f.read())


__all__ = ["export_forward", "load_forward", "load_forward_file",
           "save_forward"]
