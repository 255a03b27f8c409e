"""Input integrity ahead of the consensus (the port's counterpart of
:mod:`svoc_tpu.robustness`)."""
