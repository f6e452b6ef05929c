"""Communicator factory of the port (``chainermn_tpu/comm/__init__.py``
``create_communicator``).

Every name of the JAX package is accepted.  ``hierarchical`` and
``two_dimensional`` lay the ranks out as the ``(inter, intra)`` grid of
their hosts (host names gathered over the process group at creation) and
reduce gradients within each host and then across hosts; the flat names
give the world group as one line; ``naive`` a gloo group (on a card its
tensors are staged through host memory, so several ranks may share one
card); ``dummy`` identity gradient reductions.  NCCL refuses two ranks on
one card, so the NCCL names raise when two ranks name the same device.
"""

from __future__ import annotations

import itertools
import os
import socket
from typing import Optional, Union

import torch
import torch.distributed as dist

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.comm import mesh as mesh_lib
from chainermn_tpu_torch.comm.base import CommunicatorBase
from chainermn_tpu_torch.comm.mesh import (
    RankMesh,
    Topology,
    flat_mesh,
    hybrid_mesh,
    topology_mesh,
)
from chainermn_tpu_torch.comm.process_group import (
    DummyCommunicator,
    ProcessGroupCommunicator,
)
from chainermn_tpu_torch.comm.ragged import (
    ragged_allreduce,
    ragged_permute,
    ragged_send,
    round_up_to_bucket,
)
from chainermn_tpu_torch.distributed import init_distributed, rendezvous
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["CommunicatorBase", "DummyCommunicator",
           "ProcessGroupCommunicator", "RankMesh", "Topology",
           "create_communicator", "flat_mesh", "hybrid_mesh",
           "ragged_allreduce", "ragged_permute", "ragged_send",
           "round_up_to_bucket",
           "topology_mesh"]

_HIERARCHICAL = {"hierarchical", "two_dimensional", "non_cuda_aware"}
_FLAT = {"xla", "pure_nccl", "flat", "single_node"}
NAMES = _HIERARCHICAL | _FLAT | {"naive", "dummy"}

#: Numbers each creation's store keys: every rank creates its
#: communicators in the same order, so the counts agree.
_created = itertools.count()


def _wire_dtype(d) -> Optional[torch.dtype]:
    if d is None or isinstance(d, torch.dtype):
        return d
    name = getattr(d, "__name__", None) or getattr(d, "name", None) or str(d)
    dt = getattr(torch, str(name).replace("torch.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"allreduce_grad_dtype {d!r} is not a torch dtype")
    return dt


def _device_key(dev: torch.device) -> str:
    """What names a card across processes: its UUID."""
    return str(torch.cuda.get_device_properties(dev).uuid)


def _check_one_rank_per_card(dev: torch.device, n: int) -> None:
    """Raise when two ranks of the NCCL group would name the same card
    (NCCL would fail at its first collective with "Duplicate GPU
    detected").  The UUIDs go over the rendezvous store before the NCCL
    default group exists, so a refused rank has no group yet and may go
    on to create a ``naive`` one."""
    store, rank, size = rendezvous()
    key = f"cmn_torch/device/{n}"
    store.set(f"{key}/{rank}", _device_key(dev))
    seen = {}
    for r in range(size):
        uuid = store.get(f"{key}/{r}").decode()
        if uuid in seen:
            raise ValueError(
                f"ranks {seen[uuid]} and {r} run on the same card "
                f"({uuid}): NCCL needs one card per rank.  Give each rank "
                "its own card, or create_communicator('naive', device=...) "
                "for a gloo group whose ranks may share a card")
        seen[uuid] = r


def create_communicator(communicator_name: str = "hierarchical",
                        device: Union[str, torch.device, None] = None,
                        allreduce_grad_dtype=None,
                        mesh: Optional[RankMesh] = None,
                        hosts=None) -> CommunicatorBase:
    """A communicator over the default process group, which this call
    creates if none exists (NCCL for a CUDA device, gloo for the CPU and
    for ``naive``).

    ``device`` None means this rank's CUDA device (``LOCAL_RANK`` under
    ``torchrun`` or :mod:`chainermn_tpu_torch.launch`) and raises where
    there is none; pass ``device="cpu"`` for the CPU.
    ``allreduce_grad_dtype`` (e.g. ``torch.bfloat16``) is the gradient
    wire dtype, for any name.  ``mesh`` is the rank grid the communicator
    spans (``hybrid_mesh({"data": D, "model": S})``; its axes name
    :meth:`~ProcessGroupCommunicator.sub`'s lines); the hierarchical names
    default to ``topology_mesh(hosts)`` and the rest to a flat line.
    ``hosts`` (the host of each rank) defaults to each rank's host name,
    gathered over the group.  With more than one rank, the global except
    hook is installed (``CHAINERMN_TPU_NO_EXCEPT_HOOK=1`` opts out)."""
    name = communicator_name
    if name not in NAMES:
        raise ValueError(f"unknown communicator name {name!r}")
    if device is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(device, "create_communicator")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    nccl = dev.type == "cuda" and name != "naive"
    n = next(_created)
    if nccl and (not dist.is_initialized() or dist.get_backend() == "nccl"):
        _check_one_rank_per_card(dev, n)
    init_distributed("nccl" if nccl else "gloo")
    group = None
    if name == "naive" and dist.get_backend() != "gloo":
        group = dist.new_group(backend="gloo")
    size = dist.get_world_size(group)
    if hosts is None:
        hosts = [None] * size
        dist.all_gather_object(hosts, socket.gethostname(), group=group)
    if mesh is None:
        mesh = topology_mesh(hosts) if name in _HIERARCHICAL \
            else flat_mesh(size)
    elif mesh.size != size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks; the "
                         f"group has {size}")
    cls = DummyCommunicator if name == "dummy" else ProcessGroupCommunicator
    comm = cls(dev, group=group,
               allreduce_grad_dtype=_wire_dtype(allreduce_grad_dtype),
               name=name, mesh=mesh, hosts=hosts)
    if name in ("hierarchical", "two_dimensional") and \
            comm.axes == (mesh_lib.INTER_AXIS, mesh_lib.INTRA_AXIS) and \
            comm.intra_size > 1 and comm.inter_size > 1:
        comm._levels()  # every rank builds the level groups now, together
    if size > 1:
        global_except_hook.add_hook_if_enabled()
    return comm
