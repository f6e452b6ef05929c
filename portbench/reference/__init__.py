"""Plain PyTorch references of the benchmark's configurations, their
optimizers and the lower-precision rounding of the controls.  Nothing
here imports the program."""

import contextlib


@contextlib.contextmanager
def exact_fp32(torch):
    """float32 products and convolutions without TF32 for the block
    (PyTorch's own setting for products, not for cuDNN's convolutions),
    the settings put back after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
