"""Byzantine robustness certification as a gate, on the card by default.

The twin of ``tools/robustness_cert.py`` (``robustness_cert.py:1-163``;
``make robustness-smoke`` is its ``--smoke``): the empirical
breakdown-point sweep (:mod:`svoc_torch.robustness.certify`) for BOTH
consensus configurations (8 oracles, ``n_failing`` 2, 0–4 colluders) on
``--device`` (default CUDA, raising without a card; every cell's
consensus one launch of the gated claim-cube kernel there), and the
seeded Byzantine chaos scenario twice (host work, no device), then the
reference's 10 checks:

- every attack strategy tolerates a colluder fraction of at least
  ``n_failing / N`` at bounded essence deviation, constrained and
  unconstrained;
- the Byzantine scenario replays fingerprint-identically, quarantines
  every injected malformed vector with zero false quarantines, never
  duplicates a tx, and votes the colluders and the injector out.

``--smoke`` runs 8 trials at one magnitude a config; the full mode 64
trials at three.  :data:`REFERENCE` holds the JAX package's Byzantine
fingerprint and certificates at seed 0 (the card's machine has no JAX;
``tests/test_torch_robustness.py`` rechecks them against a live run).

Usage::

    python -m svoc_torch.tools.robustness_cert [--smoke] [--seed 0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

#: The JAX package's ``tools/robustness_cert.py [--smoke] --seed 0``:
#: the Byzantine scenario's fingerprint (the same in both modes) and
#: each certificate's ``certified`` and tolerated colluders by attack.
REFERENCE = {
    "byzantine_fingerprint": "e46af2f0a4112b1b8966dd6f6cfe401e05ad22d23ece7e8a06d6ca487aafc8da",
    "smoke": {
        "constrained": {"certified": True, "tolerated": {
            "cluster": 3, "shift": 4, "sign_flip": 4, "straddle": 4, "drift": 4}},
        "unconstrained": {"certified": True, "tolerated": {
            "cluster": 4, "shift": 4, "sign_flip": 4, "straddle": 3, "drift": 4}},
    },
    "full": {
        "constrained": {"certified": True, "tolerated": {
            "cluster": 3, "shift": 3, "sign_flip": 4, "straddle": 4, "drift": 4}},
        "unconstrained": {"certified": True, "tolerated": {
            "cluster": 4, "shift": 4, "sign_flip": 4, "straddle": 2, "drift": 4}},
    },
}


def _jsonable_sweep(sweep):
    out = dict(sweep)
    out["cells"] = [dataclasses.asdict(c) for c in sweep["cells"]]
    out["benign_deviation"] = {str(k): v for k, v in sweep["benign_deviation"].items()}
    return out


def certificate_summary(certs: dict) -> dict:
    """``{config: {"certified": bool, "tolerated": {attack: count}}}``,
    what :data:`REFERENCE` pins of each certificate."""
    return {
        name: {
            "certified": cert["certified"],
            "tolerated": {a: d["tolerated_colluders"] for a, d in cert["attacks"].items()},
        }
        for name, cert in certs.items()
    }


def run(seed: int, smoke: bool, device=None) -> dict:
    from svoc_torch.consensus.kernel import ConsensusConfig
    from svoc_torch.device import resolve_device
    from svoc_torch.resilience.chaos import run_byzantine_scenario
    from svoc_torch.robustness.certify import breakdown_sweep, certificate
    from svoc_torch.sim import prng

    device = resolve_device(device)
    n_oracles, n_failing = 8, 2
    counts = list(range(0, 5))  # 0 … N/2 colluders
    if smoke:
        trials, magnitudes_c, magnitudes_u = 8, [0.45], [5.0]
    else:
        trials = 64
        magnitudes_c = [0.2, 0.45, 0.9]
        magnitudes_u = [2.5, 5.0, 10.0]  # fractions of max_spread=10

    k_con, k_unc = prng.split(prng.PRNGKey(seed, device), 2).unbind(-2)
    sweeps = {}
    certs = {}
    for name, cfg, mags, bound in (
        ("constrained", ConsensusConfig(n_failing=n_failing, constrained=True), magnitudes_c, 0.05),
        ("unconstrained", ConsensusConfig(n_failing=n_failing, constrained=False, max_spread=10.0),
         magnitudes_u, 0.5),
    ):
        sweep = breakdown_sweep(
            k_con if cfg.constrained else k_unc,
            cfg,
            n_oracles=n_oracles,
            colluder_counts=counts,
            magnitudes=mags,
            n_trials=trials,
        )
        sweeps[name] = sweep
        certs[name] = certificate(sweep, bound_abs=bound)

    byz = run_byzantine_scenario(seed)
    byz_replay = run_byzantine_scenario(seed)

    checks = {
        "constrained_certified": certs["constrained"]["certified"],
        "unconstrained_certified": certs["unconstrained"]["certified"],
        "byzantine_replayable": byz["fingerprint"] == byz_replay["fingerprint"],
        "all_injections_quarantined": byz["missed_injections"] == 0 and byz["injections"] > 0,
        "zero_false_quarantines": byz["false_quarantines"] == 0,
        "quarantine_reasons_as_expected": byz["reason_mismatches"] == 0,
        "colluders_voted_out": byz["colluders_voted_out"],
        "injector_voted_out": byz["injector_voted_out"],
        "no_duplicate_txs": byz["duplicate_txs"] == 0,
        "consensus_held": byz["consensus_active"] and byz["essence_in_band"],
    }
    mode = "smoke" if smoke else "full"
    summary = certificate_summary(certs)
    mismatches = {}
    if seed == 0 and REFERENCE[mode] is not None:
        if byz["fingerprint"] != REFERENCE["byzantine_fingerprint"]:
            mismatches["byzantine_fingerprint"] = byz["fingerprint"]
        if summary != REFERENCE[mode]:
            mismatches["certificates"] = summary
    return {
        "seed": seed,
        "mode": mode,
        "device": str(device),
        "checks": checks,
        "ok": all(checks.values()),
        "certificates": certs,
        "certificate_summary": summary,
        "reference_mismatches": mismatches,
        "byzantine": byz,
        "byzantine_replay_fingerprint": byz_replay["fingerprint"],
        "sweeps": {k: _jsonable_sweep(v) for k, v in sweeps.items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    t0 = time.monotonic()
    artifact = run(args.seed, args.smoke, args.device)
    artifact["elapsed_s"] = round(time.monotonic() - t0, 2)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    print(json.dumps({
        "robustness_cert": "ok" if artifact["ok"] else "FAILED",
        "mode": artifact["mode"],
        "device": artifact["device"],
        "checks": artifact["checks"],
        "tolerated": {
            name: {a: d["tolerated_fraction"] for a, d in cert["attacks"].items()}
            for name, cert in artifact["certificates"].items()
        },
        "reference_mismatches": artifact["reference_mismatches"],
        "elapsed_s": artifact["elapsed_s"],
    }), flush=True)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
