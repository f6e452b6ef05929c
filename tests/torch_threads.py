"""Caps PyTorch's intra-op threads in each pytest-xdist worker.

PyTorch starts one intra-op thread per core in every process.  Under the
tier-1 command's six xdist workers that is six pools of that many
threads on the same cores, and the port's CPU tests then spend most of
their wall time waiting for cores.  Importing this module sets each
worker's pool to its share of the cores (at least one thread); outside
xdist (one process, or the card's runs) it changes nothing.  The port's
test files import it, directly or through ``torch_process_state``; every
worker imports every test file while collecting, so one import caps the
whole worker.
"""

import os

import torch


def cap_threads() -> int:
    """Set this worker's share of the cores; returns the thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


cap_threads()
