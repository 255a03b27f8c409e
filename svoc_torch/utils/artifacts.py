"""Atomic, durable JSON artifact writes.

Mirrors :func:`svoc_tpu.utils.artifacts.atomic_write_json`
(``artifacts.py:30-41``) and :func:`svoc_tpu.utils.events.fsync_dir`: the
port's own copy.  The probe tools publish their records through it after
every probe, so that a reader never sees a torn file and a killed run
keeps what it had finished.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any


def fsync_dir(path: str) -> None:
    """fsync the directory that holds ``path``: a rename is metadata, and
    until the directory entry is durable a crash can bring back the
    layout from before it.  Best effort: a platform without directory
    descriptors cannot do it at all."""
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        with contextlib.suppress(OSError):
            os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, payload: Any, indent: int = 1) -> None:
    """Write ``payload`` as JSON at ``path``: whole or absent (tmp file,
    then rename) and durable (the file fsynced before the rename, the
    directory after it)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path)
