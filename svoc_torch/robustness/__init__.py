"""Byzantine-oracle hardening of the port: attacks, the breakdown
certificate and the input-integrity quarantine gate.

Mirrors :mod:`svoc_tpu.robustness` and exports what it exports; the
reference's tensor twins ``quarantine_reasons_jax`` and
``quarantine_mask_jax`` are :func:`quarantine_reasons` and
:func:`quarantine_mask` here.

- :mod:`svoc_torch.robustness.attacks`: the five seeded Byzantine
  strategies;
- :mod:`svoc_torch.robustness.certify`: the empirical breakdown-point
  sweep behind ``python -m svoc_torch.tools.robustness_cert``;
- :mod:`svoc_torch.robustness.sanitize`: the quarantine gate ahead of the
  consensus and the commit path.
"""

from svoc_torch.robustness.attacks import (  # noqa: F401
    ATTACK_NAMES,
    apply_attack,
)
from svoc_torch.robustness.certify import (  # noqa: F401
    BreakdownCell,
    breakdown_sweep,
    certificate,
)
from svoc_torch.robustness.sanitize import (  # noqa: F401
    QUARANTINE_REASONS,
    QuarantinedInputError,
    QuarantineGate,
    QuarantineReport,
    SanitizeConfig,
    quarantine_mask,
    quarantine_reasons,
)
