"""The training loop on the card: the device-prefetch stage's copies and
the fused 1x1-conv kernel (K6) under the ``Trainer``.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_train_loop_cuda.py

Checked:

* ``DevicePrefetchIterator`` over the native ring (``copy=False``: the
  host batch is a view into a ring slot) hands out device batches equal
  byte for byte to ``SerialIterator``'s host batches for the same seed,
  over several ring wraps and epochs, while the card runs matrix products
  between the draws, and with every batch held until the end (a slot, a
  pinned staging buffer or a device allocation reused too early would
  show as a changed batch);
* a ``ResNetTiny`` with ``bn="frozen", conv1="pallas"`` trained through
  the ``Trainer`` and the device-prefetch stage runs K6 12 times per
  training step and 12 times per evaluator batch: the step is captured
  as a CUDA graph, so its wrapper counts the launches of the first,
  eager, step and of the capture's warm-ups, the capture records 12, and
  each later step replays them;
* a checkpoint restored into a fresh model on the card equals the saved
  tensors byte for byte.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import ArrayDataset
from chainermn_tpu_torch.extensions import (
    Evaluator,
    create_multi_node_checkpointer,
)
from chainermn_tpu_torch.iterators import (
    PrefetchIterator,
    SerialIterator,
    create_device_prefetch_iterator,
)
from chainermn_tpu_torch.models import ResNetTiny, resnet_loss
from chainermn_tpu_torch.ops import conv_fused
from chainermn_tpu_torch.optimizers import (
    CAPTURE_WARMUP,
    create_multi_node_optimizer,
    sgd,
)
from chainermn_tpu_torch.training import Trainer

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def comm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned staging, side-stream "
                    "copies and K6 run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return create_communicator("xla", device=torch.device("cuda", 0))


def _pool(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 3), dtype=np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_device_prefetch_equals_host_batches_under_load(comm):
    arrays = _pool(200, 64)
    ds = ArrayDataset(*arrays)
    want = SerialIterator(ds, 24, seed=3)
    it = create_device_prefetch_iterator(
        PrefetchIterator(ds, 24, seed=3, depth=3, copy=False), comm, depth=2)
    a = torch.randn(2048, 2048, device=comm.device)
    held = []
    for step in range(40):  # 200 rows / 24: a wrap every epoch, 4.8 epochs
        got = next(it)
        host = next(want)
        assert all(t.is_cuda for t in got)
        assert (it.epoch, it.is_new_epoch) == (want.epoch, want.is_new_epoch)
        for _ in range(4):  # keep the card busy while copies run
            a = torch.tanh(a @ a * 1e-3)
        held.append((got, host))
    torch.cuda.synchronize()
    for step, (got, host) in enumerate(held):
        for g, h in zip(got, host):
            assert g.cpu().numpy().tobytes() == np.asarray(h).tobytes(), step
    assert len(it.h2d_ms) > 0 and all(ms > 0 for ms in it.h2d_ms)
    it.close()


def test_k6_launches_are_counted_under_the_trainer(comm):
    dev = comm.device
    model = ResNetTiny(num_classes=10, width=16, bn="frozen", conv1="pallas",
                       device=dev, seed=0)
    model.scale_residual_branches(0.1)
    opt = create_multi_node_optimizer(sgd(0.01, 0.9), comm)
    ds = ArrayDataset(*_pool(24, 32))
    it = create_device_prefetch_iterator(
        PrefetchIterator(ds, 8, seed=0, copy=False), comm, depth=2)
    tr = Trainer(opt, opt.init(model), resnet_loss(model), it,
                 stop=(3, "iteration"), stateful=True)
    conv_fused.matmul_affine_fwd.launches = 0
    tr.run()
    torch.cuda.synchronize()
    (step,) = opt._step_cache.values()
    (graph,) = step.graphs.values()
    assert graph.captured["matmul_affine_fwd"] == 12
    assert step.program.replays == 3 - 1
    assert conv_fused.matmul_affine_fwd.launches == 12 * (1 + CAPTURE_WARMUP)
    assert np.isfinite(float(tr.last_metrics["loss"]))
    ev = Evaluator(lambda: SerialIterator(ArrayDataset(*_pool(20, 32, 1)), 8,
                                          repeat=False, shuffle=False),
                   lambda m, b: {"acc": (m(b[0], train=False).argmax(-1)
                                         == torch.as_tensor(b[1], device=dev)
                                         ).float()}, comm)
    conv_fused.matmul_affine_fwd.launches = 0
    res = ev.evaluate(model)
    assert ev.batches == 3
    assert conv_fused.matmul_affine_fwd.launches == 12 * 3
    assert 0.0 <= res["acc"] <= 1.0
    it.close()


def test_checkpoint_restore_on_the_card_is_byte_exact(comm, tmp_path):
    dev = comm.device
    model = ResNetTiny(num_classes=10, width=16, device=dev, seed=0)
    opt = create_multi_node_optimizer(sgd(0.1, 0.9), comm,
                                      grad_compression="int8_ef")
    st = opt.init(model)
    x, y = _pool(8, 32)
    opt.update(st, (x, y), resnet_loss(model), stateful=True)
    ck = create_multi_node_checkpointer("c", comm, path=str(tmp_path))
    ck.save(st)
    ck.finalize()

    def tensors(state):
        out = {f"m:{k}": v for k, v in state.model.state_dict().items()}
        out.update({f"r:{k}": v for k, v in state.ef_residual.items()})
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    saved = tensors(st)
    fresh = ResNetTiny(num_classes=10, width=16, device=dev, seed=5)
    st2, _ = ck.maybe_load(opt.init(fresh))
    got = tensors(st2)
    assert sorted(got) == sorted(saved)
    for k in saved:
        assert got[k].numpy().tobytes() == saved[k].numpy().tobytes(), k
    assert all(t.is_cuda for t in st2.model.state_dict().values())
