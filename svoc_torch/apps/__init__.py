"""Application layer (the port's counterpart of :mod:`svoc_tpu.apps`):
the session (``session.py``), the operator console (``commands.py``),
its CLI (``cli.py``) and its web UI (``web.py``)."""
