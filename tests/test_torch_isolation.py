"""The port stands alone: no file of ``chainermn_tpu_torch`` imports JAX,
Flax or the JAX package, and its entry points refuse to fall back to the
CPU silently."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import chainermn_tpu_torch

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

PKG = pathlib.Path(chainermn_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chainermn_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)
        ) in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(
    [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_root_match_is_exact():
    """``chainermn_tpu_torch`` itself must not count as the JAX
    package."""
    roots = {r for r, _ in _imported_roots(
        PKG / "serving" / "scheduler.py")}
    assert "chainermn_tpu_torch" in roots
    assert "chainermn_tpu" not in roots


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine
    from chainermn_tpu_torch.utils import params_from_flax

    kw = dict(vocab=32, n_layers=1, d_model=32, n_heads=2, d_ff=64,
              max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**kw)
    model = TransformerLM(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="DecodeEngine"):
        DecodeEngine(model, capacity=2, num_blocks=4)
    with pytest.raises(RuntimeError, match="params_from_flax"):
        params_from_flax({"embed": {"embedding": np.zeros((2, 2))}})


def test_training_entry_points_raise_without_cuda(no_cuda, monkeypatch):
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.examples import train_lm
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="create_communicator"):
        create_communicator("xla")
    # The default --device is the card: no silent CPU run.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])
    # A model and a communicator on different devices do not mix.
    comm = create_communicator("xla", device="cpu")
    comm.device = torch.device("cuda", 0)
    model = TransformerLM(vocab=32, n_layers=1, d_model=32, n_heads=2,
                          d_ff=64, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="communicator reduces on cuda"):
        create_multi_node_optimizer(adamw(1e-3), comm).init(model)


def test_flash_wrappers_refuse_other_devices():
    from chainermn_tpu_torch.ops import flash_attention_fwd

    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="q is on the CPU"):
        flash_attention_fwd(torch.zeros(1, 4, 2, 32), q, q)


def test_model_and_engine_devices_must_agree():
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine

    model = TransformerLM(vocab=32, n_layers=1, d_model=32, n_heads=2,
                          d_ff=64, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="parameters are on"):
        DecodeEngine(model, capacity=2, num_blocks=4, device="meta")


def test_native_sources_are_the_ports_own():
    """The port builds only sources inside its package: the CUDA kernels
    from ``csrc/`` and the batch loader from its copy of the JAX
    package's ``_native/dataloader.cpp``, into its own ``_build``; none
    of them includes anything of the JAX package's tree."""
    import re

    from chainermn_tpu_torch import native
    from chainermn_tpu_torch.ops import _kernels

    sources = [native.SOURCE, *sorted(_kernels.CSRC_DIR.glob("*.c*"))]
    assert native.SOURCE.read_bytes() != b""
    for src in sources:
        assert PKG in src.resolve().parents, src
        for inc in re.findall(r'#\s*include\s+"([^"]+)"', src.read_text()):
            assert (src.parent / inc).resolve().is_relative_to(PKG), inc
    assert native.library_path().parent == PKG / "_build"
    assert _kernels.BUILD_DIR == PKG / "_build"


def test_training_entry_points_of_the_loop_raise_without_cuda(no_cuda,
                                                               monkeypatch):
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.models import MLP

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLP()
    with pytest.raises(RuntimeError, match="create_communicator"):
        train_mnist.main([])


def test_zoo_entry_points_raise_without_cuda(no_cuda, monkeypatch):
    """The seq2seq models, ViT, their bridges and the seq2seq twin run on
    the card by default and raise without one."""
    from chainermn_tpu_torch.examples import seq2seq
    from chainermn_tpu_torch.models import Seq2Seq, TransformerSeq2Seq, ViT
    from chainermn_tpu_torch.utils import (
        lora_params_from_flax,
        seq2seq_params_from_flax,
        vit_params_from_flax,
    )

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for build in (lambda: Seq2Seq(8, 8),
                  lambda: TransformerSeq2Seq(8, 8),
                  lambda: ViT(num_classes=2, image_size=32, n_layers=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    for bridge in (seq2seq_params_from_flax, vit_params_from_flax,
                   lora_params_from_flax):
        with pytest.raises(RuntimeError, match=bridge.__name__):
            bridge({})
    with pytest.raises(RuntimeError, match="create_communicator"):
        seq2seq.main([])
