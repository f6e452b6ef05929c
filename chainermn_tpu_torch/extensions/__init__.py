"""Trainer extensions of the port: the multi-node evaluator and the
multi-node checkpointer (``chainermn_tpu/extensions``; reference anchors
``chainermn/evaluators.py`` and ``chainermn/extensions/checkpoint.py``).
"""

from chainermn_tpu_torch.extensions.checkpoint import (
    MultiNodeCheckpointer,
    apply_loop_state,
    capture_loop_state,
    create_multi_node_checkpointer,
)
from chainermn_tpu_torch.extensions.evaluator import (
    Evaluator,
    create_multi_node_evaluator,
)

__all__ = ["Evaluator", "MultiNodeCheckpointer", "apply_loop_state",
           "capture_loop_state", "create_multi_node_checkpointer",
           "create_multi_node_evaluator"]
