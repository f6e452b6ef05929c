"""A module-scoped fixture for the port's test files that build a
``torch.distributed`` process group in the test process.

``create_communicator(..., device="cpu")`` builds a one-rank default group
when none exists, and ``torch.distributed.init_process_group`` replaces
``sys.excepthook`` with its own wrapper.  Both would outlive the test file
and change what later files in the same worker process see (the JAX
package's ``test_checkpoint.py::test_except_hook_installed`` reads the
hook).  Importing :func:`restore_process_state` into a test module makes
the module leave the process as it found it.
"""

import sys

import pytest
import torch.distributed as dist


@pytest.fixture(scope="module", autouse=True)
def restore_process_state():
    hook = sys.excepthook
    had_group = dist.is_available() and dist.is_initialized()
    yield
    if dist.is_available() and dist.is_initialized() and not had_group:
        dist.destroy_process_group()
    sys.excepthook = hook
