"""Oracle fleet simulation of the port: generators, the bootstrap model and
the Monte-Carlo benchmarks.

Mirrors :mod:`svoc_tpu.sim` and exports what it exports.
"""

from svoc_torch.sim.generators import (  # noqa: F401
    FLEET_CLAIM_SALT,
    beta_mode,
    claim_fleet_keys,
    generate_beta_oracles,
    generate_gaussian_oracles,
    generate_kumaraswamy_oracles,
    kumaraswamy_mode,
)
from svoc_torch.sim.montecarlo import (  # noqa: F401
    benchmark,
    benchmark_unconstrained,
    launch_benchmark,
)
from svoc_torch.sim.multimodal import (  # noqa: F401
    benchmark_multimodal,
    em_mixture,
    generate_multimodal_oracles,
    multimodal_breakdown_curve,
    multimodal_consensus,
    select_k,
)
from svoc_torch.sim.oracle import gen_oracle_predictions  # noqa: F401
