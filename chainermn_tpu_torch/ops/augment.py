"""Device-side data augmentation: the port of ``chainermn_tpu/ops/augment.py``
(random pad-crop and horizontal flip, the classic ResNet recipe; SURVEY.md
§2.9's host-side transforms moved onto the card).

PyTorch cannot reproduce JAX's PRNG streams, so each transform is split
into its **draw** (offsets or flags from a ``torch.Generator``) and its
**apply** (:func:`crop`, :func:`flip`: deterministic given the draw, and
equal to the JAX package's transform given the same draw).  The train
step seeds the generator from ``(augment_seed, step, rank)``
(``optimizers.augment_generator``), the role of the JAX package's
``_augment_key``, so every rank augments its shard differently and the
run is reproducible.

Use through the optimizer hook::

    aug = random_crop_flip(padding=4)     # build ONCE, outside the loop
    step = opt.make_train_step(loss_fn, augment=aug, augment_seed=0)

(``opt.update`` caches one step per ``augment`` callable, so a fresh
closure per call would build a fresh step every call.)
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate"}


def _pad_nhwc(images: torch.Tensor, padding: int, mode: str):
    if mode not in _PAD_MODES:
        raise ValueError(f"mode={mode!r}: expected one of "
                         f"{sorted(_PAD_MODES)}")
    if mode == "constant":
        return F.pad(images, (0, 0, padding, padding, padding, padding))
    x = images.permute(0, 3, 1, 2)
    x = F.pad(x, (padding,) * 4, mode=_PAD_MODES[mode])
    return x.permute(0, 2, 3, 1)


def crop(images: torch.Tensor, offsets: torch.Tensor, padding: int = 4,
         mode: str = "constant") -> torch.Tensor:
    """Pad ``images`` (B, H, W, C) spatially by ``padding`` (``jnp.pad``'s
    ``mode``: constant zeros, reflect or edge), then crop each image back
    to (H, W) at its ``offsets`` row ``(dy, dx)``, each in ``[0, 2 *
    padding]``."""
    B, H, W, C = images.shape
    padded = _pad_nhwc(images, padding, mode)
    offsets = offsets.to(device=images.device, dtype=torch.long)
    rows = offsets[:, 0:1] + torch.arange(H, device=images.device)
    cols = offsets[:, 1:2] + torch.arange(W, device=images.device)
    b = torch.arange(B, device=images.device)[:, None, None]
    return padded[b, rows[:, :, None], cols[:, None, :]]


def flip(images: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """``images`` (B, H, W, C) with the rows of ``flags`` (bool, (B,))
    mirrored horizontally."""
    flags = flags.to(device=images.device, dtype=torch.bool)
    return torch.where(flags[:, None, None, None], images.flip(2), images)


def draw_offsets(g: torch.Generator, batch: int, padding: int,
                 device) -> torch.Tensor:
    """(B, 2) crop offsets, uniform in ``[0, 2 * padding]``."""
    return torch.randint(0, 2 * padding + 1, (batch, 2), generator=g,
                         device=device)


def draw_flags(g: torch.Generator, batch: int, device) -> torch.Tensor:
    """(B,) flip flags, each true with probability 1/2."""
    return torch.rand((batch,), generator=g, device=device) < 0.5


def random_crop(g: torch.Generator, images: torch.Tensor, padding: int = 4,
                mode: str = "constant") -> torch.Tensor:
    """Pad by ``padding`` then crop back at a random offset per image."""
    return crop(images, draw_offsets(g, images.shape[0], padding,
                                     images.device), padding, mode)


def random_flip(g: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip with probability 1/2 per image."""
    return flip(images, draw_flags(g, images.shape[0], images.device))


def random_crop_flip(padding: int = 4, mode: str = "constant") -> Callable:
    """``augment(generator, batch)`` for ``(images, labels, ...)``
    classification batches: random pad-crop, then horizontal flip, of the
    images (on the images' device); the other leaves untouched.  Pass to
    ``make_train_step(..., augment=...)``."""

    def augment(g: torch.Generator, batch: Tuple) -> Tuple:
        x, *rest = batch
        x = torch.as_tensor(x)
        x = random_flip(g, random_crop(g, x, padding=padding, mode=mode))
        return (x, *rest)

    return augment
