"""chainermn_tpu_torch: the PyTorch and CUDA port of ``chainermn_tpu``.

The package sits beside the JAX package and mirrors its layout (``ops/``,
``models/``, ``serving/``, ``observability/``, ``resilience/``,
``utils/``).  It imports ``torch`` and numpy only: nothing of JAX and
nothing of the JAX package.  Its hot ops are kernels written by hand for
NVIDIA Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; on a host without CUDA they raise instead of quietly
running on the CPU.

Ported so far: generation (``models.lm_generate``) and continuous-batching
serving (``serving.DecodeEngine`` + ``serving.Scheduler``) over the paged
and fused decode-attention kernels.
"""

__version__ = "0.1.0"
