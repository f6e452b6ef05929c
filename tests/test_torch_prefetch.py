"""The port's prefetching iterators against the JAX package's
(``chainermn_tpu/iterators/prefetch.py``, ``device_prefetch.py``) and its
own ``SerialIterator``.

``PrefetchIterator`` runs the port's copy of the native loader
(``chainermn_tpu_torch/native/dataloader.cpp``, built into the port's
``_build`` directory): for a seed its batches equal ``SerialIterator``'s
and the JAX ``PrefetchIterator``'s exactly, over epoch wraps (``n`` not a
multiple of the batch), ``SubDataset`` views, zero-copy slots and a
non-repeating pass with a short tail; its checkpoint cursor equals the
JAX one tick by tick and restores to the same stream.  A loader that
cannot be built raises.  ``DevicePrefetchIterator`` (a pass-through on
the CPU) reports the CONSUMED batch's epoch, ``is_new_epoch``,
``iteration`` and ``epoch_detail`` as the JAX one does over its lookahead,
and its checkpoint cursor replays its queue exactly.
"""

import pathlib

import numpy as np
import pytest

import chainermn_tpu as cmn
from chainermn_tpu.datasets import ArrayDataset as JaxArrayDataset
from chainermn_tpu.datasets import SubDataset as JaxSubDataset
from chainermn_tpu.iterators import PrefetchIterator as JaxPrefetch
from chainermn_tpu.iterators import (
    create_device_prefetch_iterator as jax_device_prefetch,
)
from chainermn_tpu_torch import native
from chainermn_tpu_torch.datasets import ArrayDataset, SubDataset
from chainermn_tpu_torch.iterators import (
    PrefetchIterator,
    SerialIterator,
    create_device_prefetch_iterator,
    create_multi_node_iterator,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1


def _arrays(n=44, dim=6):
    rng = np.random.RandomState(0)
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.randint(0, 10, size=(n,)).astype(np.int32))


def _same(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)


def _bookkeeping(it):
    return (it.epoch, it.is_new_epoch, it.iteration,
            round(float(it.epoch_detail), 9))


@pytest.mark.parametrize("view,copy", [(False, True), (True, True),
                                       (False, False)])
def test_prefetch_equals_serial_and_jax(view, copy):
    arrays = _arrays()
    if view:
        idx = np.random.RandomState(1).permutation(44)[:30]
        ds, jds = (SubDataset(ArrayDataset(*arrays), idx),
                   JaxSubDataset(JaxArrayDataset(*arrays), idx))
    else:
        ds, jds = ArrayDataset(*arrays), JaxArrayDataset(*arrays)
    serial = SerialIterator(ds, 8, seed=3)
    port = PrefetchIterator(ds, 8, seed=3, depth=3, copy=copy)
    ref = JaxPrefetch(jds, 8, seed=3, depth=3)
    for step in range(17):  # several epoch wraps (44 or 30 rows, batch 8)
        want = next(serial)
        got = next(port)
        _same(got, want, f"serial step {step}")
        _same(got, next(ref), f"jax step {step}")
        assert _bookkeeping(port) == _bookkeeping(ref)
        assert (port.epoch, port.is_new_epoch) == \
            (serial.epoch, serial.is_new_epoch)
        st, jst = port.checkpoint_loop_state(), ref.checkpoint_loop_state()
        assert st["pos"] == jst["pos"]
        np.testing.assert_array_equal(st["order"], jst["order"])
        np.testing.assert_array_equal(st["rng_keys"], jst["rng_keys"])
    port.close()
    ref.close()


def test_prefetch_no_repeat_short_tail_and_restore():
    arrays = _arrays(n=21)
    it = PrefetchIterator(ArrayDataset(*arrays), 8, repeat=False,
                          shuffle=False)
    sizes = [len(b[0]) for b in it]
    assert sizes == [8, 8, 5] and it.epoch == 1
    it.close()
    # A mid-epoch cursor restores into another iterator to the same stream.
    ds = ArrayDataset(*_arrays(n=20))
    a = PrefetchIterator(ds, 8, seed=21, depth=3)
    for _ in range(4):
        next(a)
    state = a.checkpoint_loop_state()
    want = [next(a) for _ in range(5)]
    b = PrefetchIterator(ds, 8, seed=999, depth=3)
    b.restore_loop_state(a.epoch, state)
    for w, g in zip(want, (next(b) for _ in range(5))):
        _same(g, w, "restored stream")
    a.close()
    b.close()


def test_device_prefetch_bookkeeping_matches_jax():
    arrays = _arrays(n=40, dim=8)
    comm = cmn.create_communicator("xla")
    port = create_device_prefetch_iterator(
        PrefetchIterator(ArrayDataset(*arrays), 16, seed=5, copy=False),
        _CpuComm(), depth=3)
    ref = jax_device_prefetch(
        JaxPrefetch(JaxArrayDataset(*arrays), 16, seed=5), comm, depth=3)
    for step in range(11):
        got, want = next(port), next(ref)
        _same(got, want, f"step {step}")
        assert _bookkeeping(port) == _bookkeeping(ref), step
        st, jst = port.checkpoint_loop_state(), ref.checkpoint_loop_state()
        assert st["pos"] == jst["pos"], step
        np.testing.assert_array_equal(st["order"], jst["order"])
    # The cursor replays the queue: restore it into a fresh pipeline.
    state, epoch = port.checkpoint_loop_state(), port.epoch
    want = [next(port) for _ in range(6)]
    fresh = create_device_prefetch_iterator(
        PrefetchIterator(ArrayDataset(*arrays), 16, seed=77, copy=False),
        _CpuComm(), depth=3)
    fresh.restore_loop_state(epoch, state)
    for w, g in zip(want, (next(fresh) for _ in range(6))):
        _same(g, w, "restored device pipeline")
    for it in (port, ref, fresh):
        it.close()


class _CpuComm:
    device = "cpu"
    rank, size = 0, 1

    def bcast_obj(self, obj, root=0):
        return obj


def test_multi_node_iterator_passes_the_masters_batches():
    ds = ArrayDataset(*_arrays(n=16))
    it = create_multi_node_iterator(SerialIterator(ds, 4, seed=2),
                                    _CpuComm())
    want = SerialIterator(ds, 4, seed=2)
    for _ in range(6):
        _same(next(it), next(want), "multi-node")
    assert it.epoch == want.epoch


def test_loader_builds_from_the_ports_copy_and_a_failed_build_raises(
        monkeypatch, tmp_path):
    pkg = pathlib.Path(native.__file__).resolve().parent.parent
    assert native.SOURCE == pkg / "native" / "dataloader.cpp"
    assert native.library_path().parent == pkg / "_build"
    native.load_dataloader()
    assert native.library_path().exists()
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        PrefetchIterator(ArrayDataset(*_arrays()), 8)
