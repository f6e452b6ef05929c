"""chainermn_tpu_torch: the PyTorch and CUDA port of ``chainermn_tpu``.

The package sits beside the JAX package and mirrors its layout (``ops/``,
``models/``, ``serving/``, ``comm/``, ``optimizers/``, ``training/``,
``extensions/``, ``datasets/``, ``iterators/``, ``observability/``,
``resilience/``, ``utils/``, ``examples/``; ``native/`` holds the
batch loader's C++ source).  It imports ``torch`` and numpy only: nothing of JAX and
nothing of the JAX package.  Its hot ops are kernels written by hand for
NVIDIA Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; on a host without CUDA they raise instead of quietly
running on the CPU.

Ported so far: generation (``models.lm_generate``) and continuous-batching
serving (``serving.DecodeEngine`` + ``serving.Scheduler``) over the paged
and fused decode-attention kernels; ``TransformerLM`` training, single
card and data-parallel (``comm.create_communicator``,
``optimizers.create_multi_node_optimizer``, ``models.lm_loss``,
``python -m chainermn_tpu_torch.examples.train_lm``), over the
flash-attention forward and backward kernels; ResNet data-parallel
training with cross-rank sync-BN (``models.ResNet50``,
``models.resnet_loss``, ``optimizers.sgd``, ``make_train_step(...,
stateful=True)``, ``python -m chainermn_tpu_torch.examples.train_imagenet``),
whose frozen-BN arm runs the fused 1×1-conv + affine + ReLU kernel; and
the ChainerMN training loop (``training.Trainer`` and its extensions,
``extensions`` (evaluator, checkpointer), ``iterators.PrefetchIterator``
over ``native/dataloader.cpp`` and ``DevicePrefetchIterator``, the
optimizer's double buffering, int8 error feedback, EMA and augmentation,
``ops.max_pool_fused``, ``models.MLP``,
``python -m chainermn_tpu_torch.examples.train_mnist``).
"""

__version__ = "0.1.0"
