"""Training-state checkpoints.

Mirrors ``save_train_state`` and ``restore_train_state`` of
:mod:`svoc_tpu.utils.checkpoint` (``checkpoint.py:59-85``), which write
a :class:`TrainState` with orbax and restore it onto a template state.
Here one ``torch.save`` file holds the step and the model's and the
optimizer's state dicts.  The simulation and service snapshots of that
module are not ported yet.
"""

from __future__ import annotations

import os

import torch

from svoc_torch.train.trainer import TrainState


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` to the file ``path``."""
    torch.save(
        {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        },
        os.path.abspath(path),
    )


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template``'s model and optimizer, in place
    (e.g. a fresh ``init_state(...)`` of the same model and ``tx``), and
    return it at the saved step.  The file is read to the host; the two
    ``load_state_dict`` calls place each tensor as the template keeps
    it (the optimizer keeps its step counts on the host)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    template.model.load_state_dict(saved["model"])
    template.optimizer.load_state_dict(saved["optimizer"])
    return TrainState(saved["step"], template.model, template.optimizer)
