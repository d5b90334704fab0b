"""PyTorch / CUDA port of ``openpsg_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/segmenter``, ``models/relation``, ``models/llm``,
``models/detectors``, ``data/``) so each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or ``openpsg_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and
    there is none: the port has no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "openpsg_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly for the CPU path"
        )
    return dev
