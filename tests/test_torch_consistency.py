"""The port's consistency vote against the JAX package's
(``chainermn_tpu/resilience/consistency.py``;
``tests/resilience_tests/test_consistency.py``).

``majority_vote`` on the same digest lists as JAX's (unanimous, one or
two divergent ranks, a 2-rank disagreement, even and 3-way splits, one
rank) gives the same groups, majority, divergent ranks, ``no_majority``,
description and ``RankDivergedError``; a desynchronized exchange raises
the same error.  ``tree_digest`` on torch state hashes each tensor with
its name, dtype and shape in ``named_parameters`` order (its value need
not equal the JAX digest: the bridged layouts differ): equal for equal
state, changed by one flipped bit, by a reshape, a dtype or a name.

One 3-rank job (``torch_rank_bodies.consistency``): equal digests and a
clean vote over the process group, one flipped bit on rank 2 named by a
vote over the launcher's ``HostComm``, and a vote at different steps,
which raises on every rank.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu.resilience import consistency as jax_cons
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.resilience import (
    PeerFailedError,
    RankDivergedError,
    majority_vote,
    tree_digest,
)
from chainermn_tpu_torch.resilience.consistency import (
    exchange_and_vote,
    exchange_digests,
)

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

VOTES = {
    "unanimous": ["d"] * 4,
    "one_divergent": ["good", "good", "BAD", "good"],
    "two_divergent": ["a", "b", "a", "c", "a"],
    "two_ranks": ["x", "y"],
    "even_split": ["x", "x", "y", "y"],
    "three_way": ["x", "y", "z"],
    "one_rank": ["only"],
}


def _fields(v):
    return (v.step, v.groups, v.majority, v.divergent, v.no_majority,
            v.clean, v.describe())


@pytest.mark.parametrize("case", list(VOTES))
def test_majority_vote_matches_jax(case):
    digests = VOTES[case]
    got, want = majority_vote(digests, step=9), jax_cons.majority_vote(
        digests, step=9)
    assert _fields(got) == _fields(want)
    if want.clean:
        got.raise_if_diverged(rank=1)
        return
    errors = []
    for v in (got, want):
        with pytest.raises(TimeoutError) as e:
            v.raise_if_diverged(rank=1)
        err = e.value
        errors.append((type(err).__name__, str(err), err.peer, err.op,
                       err.kind, err.divergent, err.step, err.no_majority))
        if v is got:
            assert isinstance(err, PeerFailedError)
    assert errors[0] == errors[1]
    assert errors[0][0] == "RankDivergedError"


def test_empty_vote_raises_as_jax():
    for vote in (majority_vote, jax_cons.majority_vote):
        with pytest.raises(ValueError, match="at least one"):
            vote([])


class _Plane:
    """A fake object plane: ``allgather_obj`` returns scripted pairs."""

    def __init__(self, pairs):
        self.pairs, self.size = pairs, len(pairs)

    def allgather_obj(self, obj):
        return self.pairs


def test_exchange_matches_jax_and_refuses_a_desynchronized_vote():
    plane = _Plane([(4, "a"), (4, "a"), (4, "b")])
    assert exchange_digests(plane, "a", 4) == \
        jax_cons.exchange_digests(plane, "a", 4) == ["a", "a", "b"]
    bad = _Plane([(4, "a"), (5, "a")])
    errors = []
    for fn in (exchange_digests, jax_cons.exchange_digests):
        with pytest.raises(RuntimeError) as e:
            fn(bad, "a", 4)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "desynchronized" in errors[0]
    # One process: a trivially clean vote, no exchange.
    model = MLP(hidden=(4,), n_out=2, in_features=3, device="cpu")
    v = exchange_and_vote(None, model, 3)
    assert v.clean and v.groups == {tree_digest(model): [0]}


def test_tree_digest_sees_every_bit_name_shape_and_dtype():
    a = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu", seed=1)
    b = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu", seed=1)
    d = tree_digest(a)
    assert d == tree_digest(b) == tree_digest(dict(a.named_parameters()))
    assert len(d) == 32
    with torch.no_grad():
        b.layers[1].bias.view(torch.int32)[0] ^= 1      # one bit
    assert tree_digest(b) != d
    x = torch.zeros(2, 3)
    base = tree_digest({"x": x})
    assert base != tree_digest({"x": x.reshape(3, 2)})
    assert base != tree_digest({"x": x.to(torch.int32)})
    assert base != tree_digest({"y": x})
    h = torch.arange(6, dtype=torch.bfloat16)
    h2 = h.clone()
    h2.view(torch.int16)[3] ^= 1
    assert tree_digest([h]) != tree_digest([h2])
    assert tree_digest({"x": x}) == tree_digest({"x": np.zeros((2, 3),
                                                               np.float32)})


def test_rank_diverged_error_without_majority_names_no_peer():
    for cls in (RankDivergedError, jax_cons.RankDivergedError):
        e = cls([0, 1], step=4, rank=0, no_majority=True)
        assert (e.peer, e.kind, e.op) == (-1, "diverged", "consistency_vote")
        assert "no majority at step 4" in str(e)


# ----------------------------------------------------------- across ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("consistency", tmp_path_factory.mktemp("consistency"),
                     3)


def test_equal_state_votes_clean_on_every_rank(ranks):
    assert len({r["digest"] for r in ranks}) == 1
    for r in ranks:
        assert r["clean"]["clean"] and r["clean"]["divergent"] == []
        assert r["clean"]["groups"] == {ranks[0]["digest"]: [0, 1, 2]}


def test_one_flipped_bit_is_named_by_the_vote(ranks):
    assert ranks[2]["flipped_digest"] != ranks[2]["digest"]
    assert ranks[0]["flipped_digest"] == ranks[0]["digest"]
    for r in ranks:
        v = r["flip"]
        assert (v["clean"], v["divergent"], v["no_majority"]) == \
            (False, [2], False)
        assert v["describe"] == \
            "vote@2: rank(s) [2] diverged from majority (2/3)"


def test_desynchronized_vote_raises_on_every_rank(ranks):
    for r in ranks:
        assert r["desync"] == (
            "consistency vote desynchronized: ranks voted at steps [3, 4] "
            "(vote cadence must be identical on every rank)")
