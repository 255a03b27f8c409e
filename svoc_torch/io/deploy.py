"""Contract deployment calldata.

Mirrors :mod:`svoc_tpu.io.deploy` (``deploy.py:18-116``).  The consensus
configuration is frozen in the Cairo constructor's calldata
(``contract/src/contract.cairo:236-265``), in this order:

``[n_admins, *admins, enable_oracle_replacement, required_majority,
n_failing_oracles, constrained, unconstrained_max_spread(fwsad),
dimension, n_oracles, *oracles]``

:func:`constructor_calldata` builds it from a :class:`DeployConfig`,
:func:`parse_constructor_calldata` inverts it, and
:func:`simulator_from_calldata` deploys the local contract simulator
from it, passing ``device`` (where the batched commit's sweep runs)
through to :class:`svoc_torch.consensus.state.OracleConsensusContract`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from svoc_torch.ops.fixedpoint import fwsad_to_float, float_to_fwsad


@dataclass(frozen=True)
class DeployConfig:
    admins: Sequence[int]
    oracles: Sequence[int]
    enable_oracle_replacement: bool = True
    required_majority: int = 2
    n_failing_oracles: int = 2
    constrained: bool = True
    unconstrained_max_spread: float = 0.0
    dimension: int = 2


def constructor_calldata(cfg: DeployConfig) -> List[int]:
    """``cfg`` → felt calldata list (``contract.cairo:236-265`` order)."""
    return [
        len(cfg.admins),
        *[int(a) for a in cfg.admins],
        int(cfg.enable_oracle_replacement),
        int(cfg.required_majority),
        int(cfg.n_failing_oracles),
        int(cfg.constrained),
        float_to_fwsad(cfg.unconstrained_max_spread),
        int(cfg.dimension),
        len(cfg.oracles),
        *[int(o) for o in cfg.oracles],
    ]


def constructor_args(cfg: DeployConfig) -> dict:
    """``cfg`` → ABI-typed constructor kwargs for ``starknet.py``'s
    ``deploy_v3`` (the typed view of :func:`constructor_calldata` —
    starknet.py serializes the Spans with their length prefixes, so the
    wire calldata equals the felt list)."""
    return {
        "admins": [int(a) for a in cfg.admins],
        "enable_oracle_replacement": bool(cfg.enable_oracle_replacement),
        "required_majority": int(cfg.required_majority),
        "n_failing_oracles": int(cfg.n_failing_oracles),
        "constrained": bool(cfg.constrained),
        "unconstrained_max_spread": float_to_fwsad(cfg.unconstrained_max_spread),
        "dimension": int(cfg.dimension),
        "oracles": [int(o) for o in cfg.oracles],
    }


def parse_constructor_calldata(calldata: Sequence[int]) -> DeployConfig:
    """Inverse of :func:`constructor_calldata` (validates lengths)."""
    data = [int(x) for x in calldata]
    i = 0
    n_admins = data[i]; i += 1
    admins = data[i : i + n_admins]; i += n_admins
    enable = bool(data[i]); i += 1
    majority = data[i]; i += 1
    n_failing = data[i]; i += 1
    constrained = bool(data[i]); i += 1
    max_spread = fwsad_to_float(data[i]); i += 1
    dimension = data[i]; i += 1
    n_oracles = data[i]; i += 1
    oracles = data[i : i + n_oracles]; i += n_oracles
    if i != len(data):
        raise ValueError(
            f"calldata has {len(data)} felts, layout consumed {i}"
        )
    return DeployConfig(
        admins=admins,
        oracles=oracles,
        enable_oracle_replacement=enable,
        required_majority=majority,
        n_failing_oracles=n_failing,
        constrained=constrained,
        unconstrained_max_spread=max_spread,
        dimension=dimension,
    )


def simulator_from_calldata(calldata: Sequence[int], device=None):
    """Deploy an in-memory contract simulator from chain calldata — the
    local twin of a real deployment.  ``device``: where its batched
    commit's sweep runs (``None``: CUDA)."""
    from svoc_torch.consensus.state import OracleConsensusContract

    cfg = parse_constructor_calldata(calldata)
    return OracleConsensusContract(
        admins=list(cfg.admins),
        oracles=list(cfg.oracles),
        enable_oracle_replacement=cfg.enable_oracle_replacement,
        required_majority=cfg.required_majority,
        n_failing_oracles=cfg.n_failing_oracles,
        constrained=cfg.constrained,
        unconstrained_max_spread=cfg.unconstrained_max_spread,
        dimension=cfg.dimension,
        device=device,
    )
