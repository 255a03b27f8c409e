"""Forward resolution shared by the pipeline and the serving steps.

Mirrors :mod:`svoc_tpu.models.forward` (``validate_quant``,
``resolve_forward``; ``forward.py:18-58``): one place owns the
(quant × packed) dispatch and its validation.  The float forwards are
the two encoder modules; the int8 forward (``svoc_tpu/models/quant.py``)
is not ported yet (ROADMAP A12), and asking for it raises rather than
run a float forward in its place.
"""

from __future__ import annotations

from typing import Optional, Type

from torch import nn

from svoc_torch.models.configs import EncoderConfig


def validate_quant(cfg: EncoderConfig, quant: Optional[str]) -> None:
    """The quant-option contract, raised identically by every entry."""
    if quant not in (None, "int8"):
        raise ValueError(f"quant must be None or 'int8', got {quant!r}")
    if quant == "int8" and cfg.attention != "dense":
        raise ValueError(
            "int8 serving uses the dense attention path — set "
            f"cfg.attention == 'dense' (got {cfg.attention!r})"
        )


def resolve_forward(
    cfg: EncoderConfig, quant: Optional[str] = None, packed: bool = False
) -> Type[nn.Module]:
    """The encoder module class for a serving/pipeline configuration:
    :class:`~svoc_torch.models.encoder.SentimentEncoder` (``(ids, mask) →
    logits``) or, with ``packed``,
    :class:`~svoc_torch.models.packing.PackedSentimentEncoder` (``(ids,
    pos, seg, cls_pos) → logits``).  Both load one state dict."""
    validate_quant(cfg, quant)
    if quant == "int8":
        raise NotImplementedError(
            "the int8 (W8A8) forward is not ported yet (ROADMAP A12): "
            "svoc_torch runs the float forwards only"
        )
    if packed:
        from svoc_torch.models.packing import PackedSentimentEncoder

        return PackedSentimentEncoder
    from svoc_torch.models.encoder import SentimentEncoder

    return SentimentEncoder
