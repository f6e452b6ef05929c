"""Parallelism building blocks of the port.  So far only the MoE routing
(:func:`~chainermn_tpu_torch.parallel.moe._topk_dispatch`) that the
single-device MoE FFN of ``models.TransformerLM`` runs; the
expert-parallel ``MoELayer`` and the sequence-parallel attentions are not
ported yet."""
