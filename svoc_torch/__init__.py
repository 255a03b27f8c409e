"""PyTorch/CUDA port of :mod:`svoc_tpu`, built for an NVIDIA H100.

The port mirrors the JAX package module by module; each module's
docstring names the ``svoc_tpu`` module it mirrors.  It imports
``torch`` and numpy only, never ``jax``, ``flax`` or anything of
``svoc_tpu`` (``tests/test_torch_guard.py`` holds it to that).

Entry points take ``device=None``, which means CUDA and raises when no
CUDA device is present (:func:`svoc_torch.device.resolve_device`).  The
plain PyTorch version of each kernel runs only for tensors that lie on
the CPU, as the tests pass them; on a CUDA tensor a wrapper launches its
hand-written kernel (``svoc_torch/csrc``) or raises.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # Lazy, so that ``import svoc_torch`` does not import torch: a fuzz
    # child times its interpreter start and torch's import apart.
    if name == "resolve_device":
        from svoc_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'svoc_torch' has no attribute {name!r}")
