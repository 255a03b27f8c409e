"""The multi-claim consensus fabric (the port's counterpart of
:mod:`svoc_tpu.fabric`): many claims, one consensus dispatch."""
