"""Train, freeze, serve: the port's twin of ``examples/export_serving.py``.

Trains a small classifier data-parallel, freezes the trained forward into
one batch-polymorphic ``torch.export`` artifact (``utils.export``), then
serves it from a fresh callable that needs no model code, at batch sizes
the trace never saw.  The classifier is an MLP: it reaches no
hand-written kernel (an export that did would be refused)::

    python -m chainermn_tpu_torch.examples.export_serving --device cpu
    python -m chainermn_tpu_torch.examples.export_serving   # on the card
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--out", default="result/served_model.pt2")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card) or 'cpu'")
    p.add_argument("--communicator", default="xla")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import make_synthetic_classification
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.utils.export import (
        load_forward_file,
        save_forward,
    )

    comm = create_communicator(
        args.communicator, device=None if args.device == "cuda"
        else args.device)
    dev = comm.device
    model = MLP(hidden=(64,), n_out=10, in_features=32, device=dev, seed=0)
    x, y = make_synthetic_classification(4096, 32, seed=1).arrays
    opt = create_multi_node_optimizer(adamw(1e-3, weight_decay=0.0), comm)
    state = opt.init(model)
    loss_fn = classification_loss(model)
    bs = 256
    for i in range(args.steps):
        j = (i * bs) % (len(x) - bs)
        state, m = opt.update(state, (x[j:j + bs], y[j:j + bs]), loss_fn,
                              has_aux=True)
    if comm.rank == 0:
        print(f"trained: loss {float(m['loss']):.4f} "
              f"acc {float(m['accuracy']):.4f}", flush=True)

    # Freeze: parameters baked in, batch dimension symbolic.
    model.eval()

    def forward(inp):
        return model(inp)

    xt = torch.as_tensor(x, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    path = save_forward(args.out, forward, xt[:8], poly_batch=True)

    # Serve: reload without the model, at odd batch sizes.
    serve = load_forward_file(path)
    with torch.no_grad():
        for b in (1, 7, 64):
            np.testing.assert_allclose(serve(xt[:b]).cpu().numpy(),
                                       forward(xt[:b]).cpu().numpy(),
                                       atol=1e-6)
        acc = float((serve(xt).argmax(-1).cpu().numpy() == y).mean())
    if comm.rank == 0:
        print(f"served artifact: {path} ({os.path.getsize(path)} bytes)  "
              f"train-set acc {acc:.4f}", flush=True)
    return {"path": path, "bytes": os.path.getsize(path), "accuracy": acc,
            "loss": float(m["loss"])}


if __name__ == "__main__":
    main()
