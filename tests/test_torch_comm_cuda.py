"""The rest of the communicator on the card.  Every test here needs a
CUDA device and skips without one; the module imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_comm_cuda.py

Checked: on one NCCL rank every new collective, its differentiable form
and the ragged functions are identities on card tensors, and a gloo
step refuses capture; two ranks sharing the card (started through the
port's launcher) are refused by the NCCL names with a message naming
``naive`` before an NCCL group exists, so the default group is gloo and a
barrier on it returns; over gloo their collectives and the point-to-point
gradient come back on the card with the values they have on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import functions as F
from chainermn_tpu_torch.comm import (
    create_communicator,
    ragged_allreduce,
    ragged_permute,
)
from chainermn_tpu_torch.models import MLP, classification_loss
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the staged gloo wire "
                    "of card tensors run only there")
    return torch.device("cuda", 0)


def test_one_nccl_rank_collectives_are_identities(dev):
    comm = create_communicator("xla", device=dev)
    assert comm.backend == "nccl" and comm.capturable
    x = torch.arange(6.0, device=dev).reshape(2, 3)
    pairs = [(comm.allgather(x), x[None]), (comm.alltoall(x[None]), x[None]),
             (comm.permute(x, [(0, 0)]), x),
             (comm.permute(x, []), torch.zeros_like(x)),
             (comm.gather(x, 0), x[None]), (comm.scatter(x[None], 0), x),
             (comm.reduce(x, 0), x), (comm.broadcast(x, 0), x),
             (comm.split([3])[3].allreduce(x), x),
             (ragged_permute(comm, x, [(0, 0)]), x),
             (ragged_allreduce(comm, x), x)]
    for got, want in pairs:
        assert got.is_cuda and torch.equal(got, want)
    leaf = x.clone().requires_grad_()
    y = F.bcast(comm, F.allgather(comm, leaf)[0], root=0)
    (2.0 * y).sum().backward()
    assert torch.equal(leaf.grad, torch.full_like(x, 2.0))


def test_a_gloo_step_refuses_capture(dev):
    comm = create_communicator("naive", device=dev)
    model = MLP(hidden=(8,), in_features=4, n_out=3, device=dev)
    opt = create_multi_node_optimizer(sgd(0.1), comm)
    state = opt.init(model)
    step = opt.make_train_step(classification_loss(model), has_aux=True,
                               capture=True)
    batch = (np.zeros((4, 4), np.float32), np.zeros((4,), np.int32))
    with pytest.raises(ValueError, match="capture=False"):
        step(state, batch)
    auto = opt.make_train_step(classification_loss(model), has_aux=True)
    auto(state, batch)
    assert auto.graphs == {}


def test_two_ranks_share_the_card_over_gloo(dev, tmp_path):
    ranks = run_ranks("card_pair", tmp_path, 2, env={
        "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0")})
    x = [np.array([r + 1.0, -r], np.float32) for r in range(2)]
    for r in range(2):
        got = ranks[r]
        assert "same card" in got["nccl"] and "naive" in got["nccl"]
        assert got["default_backend"] == "gloo"
        assert got["devices"] == ["cuda"]
        np.testing.assert_array_equal(got["allgather"], np.stack(x))
        np.testing.assert_array_equal(got["permute"], x[1 - r])
        np.testing.assert_array_equal(
            got["alltoall"], np.stack([x[0], x[1]]) * (10 if r else 1))
        np.testing.assert_array_equal(got["broadcast"], x[1])
        np.testing.assert_array_equal(got["allreduce"], x[0] + x[1])
    np.testing.assert_array_equal(ranks[0]["p2p_grad"],
                                  8.0 * np.array([[0.5, -1.0]], np.float32))
    assert ranks[1]["p2p_grad"] is None
