"""The port's host object plane (``chainermn_tpu_torch.hostcomm`` over its
copy of ``native/hostcomm.cpp``) across four processes, against the JAX
package's (``tests/native_tests/test_hostcomm.py``).

One job of four ranks (``torch_rank_bodies.hostcomm``) exchanges a ring
of frames, then runs barrier, bcast, gather, allgather and allreduce, an
8 MiB frame echoed between ranks 0 and 1, a receive that times out (an
attributed ``PeerFailedError``), and a decode slot migrated from rank
0's engine to rank 1's through ``serving.MigrationTransport`` over the
``HostComm`` (the KV blocks arrive byte for byte).  The JAX test's
expected values are exact and are the same here.
"""

import pytest

from chainermn_tpu_torch import native

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("hostcomm", tmp_path_factory.mktemp("hostcomm"), N)


def test_transport_is_the_ports_copy_of_the_jax_source():
    """The port builds its own copy (same wire: the C bodies agree line
    for line below the header comment)."""
    from pathlib import Path

    import chainermn_tpu

    jax_src = Path(chainermn_tpu.__file__).parent / "_native" / "hostcomm.cpp"

    def body(p):
        text = p.read_text()
        return text[text.index("#include"):]

    assert native.HOSTCOMM_SOURCE.resolve().parent == \
        Path(native.__file__).resolve().parent
    assert body(native.HOSTCOMM_SOURCE) == body(jax_src)
    assert native.library_path(native.HOSTCOMM_SOURCE).parent.resolve() \
        == native.BUILD_DIR.resolve()


def test_point_to_point_and_composites_match_the_reference(ranks):
    for r in range(N):
        out = ranks[r]
        src = (r - 1) % N
        assert out["ring"] == (src, 3 + 3 * src)
        assert out["bcast"] == {"payload": "hello", "rank": 2 % N}
        assert out["allgather"] == [(q, q ** 2) for q in range(N)]
        assert out["allreduce"] == N * (N + 1) // 2
        assert out["gather"] == ([q * 10 for q in range(N)] if r == 0
                                 else None)


def test_large_frames_and_timeouts(ranks):
    assert ranks[0]["big_echo"] is True
    kind, peer, op, why, waited = ranks[0]["timeout"]
    assert (kind, peer, op, why) == ("PeerFailedError", 1, "recv_obj",
                                     "timeout")
    assert 0.15 <= waited < 5.0
    assert ranks[1]["late"] == "done"


def test_detector_is_not_ported_yet(ranks):
    for r in range(N):
        assert "ROADMAP Queue 1 item 12" in ranks[r]["detector"]


def test_migration_transport_moves_a_slot_between_processes(ranks):
    sent, got = ranks[0]["migration"], ranks[1]["migration"]
    assert got["installed"] == 1 and got["eof"] == "eof"
    assert got["pos"] == sent["pos"] > 0
    assert len(sent["blocks"]) >= 2
    assert got["blocks"] == sent["blocks"]
    assert ranks[2]["migration"] is None
