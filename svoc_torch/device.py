"""Device resolution for the port's entry points (no ``svoc_tpu``
counterpart: JAX places arrays on its default backend).

``None`` means CUDA.  Without a CUDA device that default raises; it
never drops to the CPU, so a run that meant to use the card cannot
quietly measure the CPU instead.  Callers that want the CPU (the tests)
pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda`` (raises when CUDA is absent); anything else →
    ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "svoc_torch defaults to CUDA and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    return torch.device(device)
