"""Build and ctypes bindings of the port's native host runtime: the batch
tokenizer and the sequence packer.

Mirrors :mod:`svoc_tpu.runtime.native` (``native.py:58-90`` the C
signatures, ``NativeHashingTokenizer``, ``native_pack_tokens_raw``) over
copies of its sources, ``tokenizer.cpp`` and ``packer.cpp``.  It differs
in three ways:

- a build that fails raises ``RuntimeError``: there is no Python
  fallback, so a serving feed never runs the slow tokenizer by accident;
- the build follows :mod:`svoc_torch.ops._build`: ``g++ -O3 -shared
  -fPIC -std=c++17`` at first use into ``svoc_torch/_build/``
  (git-ignored), the library named by a hash of the sources and the
  flags, so an edited source builds anew and a stale library is never
  loaded;
- the library is written to a temporary file and put in place with
  ``os.replace``, so processes that build at once (test workers) never
  load half a file.

There is no ``-march=native``: the code hashes and copies integers and
gives the same bits without it, and a library named by the same hash
then stays valid on any host of the architecture.

ctypes releases the GIL during the two batch calls, so tokenizing and
packing overlap the device in :class:`svoc_torch.io.pipeline.PrefetchPipeline`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from svoc_torch.ops._build import BUILD_DIR
from svoc_torch.utils.artifacts import fsync_dir

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("tokenizer.cpp", "packer.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict = {}


def library_path() -> Path:
    """Where the runtime builds to: named by a hash of the sources and
    the flags."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode() + (SRC_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsvoc_runtime-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless its library exists; returns its path.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.stem + ".", suffix=".tmp")
    os.close(fd)
    try:
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, *(str(SRC_DIR / name) for name in SOURCES)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"the native runtime did not build ({CXX}): {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(
                f"the native runtime did not build ({CXX}, exit {res.returncode}):\n{res.stderr}"
            )
        # Durably: the file before the rename, the directory after it, so
        # that a crash cannot leave an empty library under the final name.
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        fsync_dir(str(out))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.svoc_tokenize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # texts
        ctypes.c_int,  # n_texts
        ctypes.c_int,  # seq_len
        ctypes.c_int64,  # vocab_size
        ctypes.c_int32,  # pad_id
        ctypes.c_int32,  # bos_id
        ctypes.c_int32,  # eos_id
        ctypes.POINTER(ctypes.c_int32),  # ids out
        ctypes.POINTER(ctypes.c_int32),  # mask out
    ]
    lib.svoc_tokenize_batch.restype = None
    lib.svoc_pack_tokens.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # flat tokens
        ctypes.POINTER(ctypes.c_int64),  # offsets [n+1]
        ctypes.c_int,  # n_lists
        ctypes.c_int,  # seq_len
        ctypes.c_int,  # max_segments
        ctypes.c_int32,  # pad_id
        ctypes.c_int,  # rows_cap
        *[ctypes.POINTER(ctypes.c_int32)] * 6,  # ids, pos, seg, cls_pos, seg_valid, owner out
        ctypes.POINTER(ctypes.c_int32),  # out counts [2]
    ]
    lib.svoc_pack_tokens.restype = None
    return lib


def load_native_library() -> ctypes.CDLL:
    """The bound library, built on first use; raises when it cannot be
    built."""
    path = library_path()
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = _bind(ctypes.CDLL(str(build())))
        return lib


def _int32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_pack_tokens_raw(
    token_lists: Sequence[Sequence[int]],
    seq_len: int,
    max_segments: int,
    pad_id: int,
    rows: Optional[int] = None,
) -> tuple:
    """The C++ greedy next-fit packer (``packer.cpp``), GIL-free during
    the pack: ``(ids, pos, seg, cls_pos, seg_valid, owner, n_consumed)``
    as :func:`svoc_torch.models.packing.pack_tokens` gives them."""
    lib = load_native_library()
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    if rows is not None and rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    n = len(token_lists)
    arrs = [np.asarray(t, dtype=np.int32) for t in token_lists]
    lengths = np.fromiter((a.size for a in arrs), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = (
        np.ascontiguousarray(np.concatenate(arrs), dtype=np.int32)
        if n and offsets[-1]
        else np.zeros(0, dtype=np.int32)
    )
    rows_cap = rows if rows is not None else max(1, n)
    t, s = seq_len, max_segments
    ids = np.full((rows_cap, t), pad_id, dtype=np.int32)
    pos = np.full((rows_cap, t), pad_id, dtype=np.int32)
    seg = np.zeros((rows_cap, t), dtype=np.int32)
    cls_pos = np.zeros((rows_cap, s), dtype=np.int32)
    seg_valid = np.zeros((rows_cap, s), dtype=np.int32)
    owner = np.full((rows_cap, s), -1, dtype=np.int32)
    counts = np.zeros(2, dtype=np.int32)
    lib.svoc_pack_tokens(
        _int32_ptr(flat), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, t, s,
        pad_id, rows_cap, _int32_ptr(ids), _int32_ptr(pos), _int32_ptr(seg),
        _int32_ptr(cls_pos), _int32_ptr(seg_valid), _int32_ptr(owner), _int32_ptr(counts),
    )
    if rows is None:
        # copy() the trims: a bare slice would keep the whole [n, T]
        # allocation alive for the batch's lifetime.
        used = max(1, int(counts[0]))
        ids, pos, seg, cls_pos, seg_valid, owner = (
            a[:used].copy() for a in (ids, pos, seg, cls_pos, seg_valid, owner)
        )
    return ids, pos, seg, cls_pos, seg_valid, owner, int(counts[1])


class NativeHashingTokenizer:
    """The native twin of :class:`svoc_torch.models.tokenizer.HashingTokenizer`:
    the same special-id layout (pad/bos/eos among ids 0..3) and FNV-1a
    word hashing, bit-identical on ASCII text; raises ``RuntimeError`` at
    construction when the library cannot be built."""

    N_SPECIAL = 4

    def __init__(self, vocab_size: int, pad_id: int = 1, max_len: int = 512):
        self._lib = load_native_library()
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.max_len = max_len
        specials = list(range(self.N_SPECIAL))
        self.bos_id = next(i for i in specials if i != pad_id)
        self.eos_id = next(i for i in specials if i not in (pad_id, self.bos_id))

    def __reduce__(self):  # pickled by its arguments: a worker process loads the library itself
        return type(self), (self.vocab_size, self.pad_id, self.max_len)

    def __call__(
        self, texts: Sequence[str], seq_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize a batch → ``(ids [B, T], mask [B, T])`` int32."""
        t = seq_len or self.max_len
        b = len(texts)
        ids = np.empty((b, t), dtype=np.int32)
        mask = np.empty((b, t), dtype=np.int32)
        arr = (ctypes.c_char_p * b)(*(s.encode("utf-8") for s in texts))
        self._lib.svoc_tokenize_batch(
            arr, b, t, self.vocab_size, self.pad_id, self.bos_id, self.eos_id,
            _int32_ptr(ids), _int32_ptr(mask),
        )
        return ids, mask
