"""Durable comment store + circular window reader.

Mirrors :mod:`svoc_tpu.io.comment_store` (``comment_store.py:1-118``),
the whole module: sqlite3 only.

Schema parity with the reference scraper's sqlite table
(``client/scraper.py:44-55``): ``comments(id INTEGER PRIMARY KEY
AUTOINCREMENT, comment TEXT NOT NULL, timestamp DATETIME DEFAULT
CURRENT_TIMESTAMP)``, so an existing reference database file can be
opened directly.

The circular window reader mirrors ``read_window_from_db``
(``client/oracle_scheduler.py:44-69``) including its quirks, which are
kept because the simulation cursor semantics depend on them:

- the cursor first advances by ``window`` *before* reading
  (``position = (position + PREDICTION_WINDOW) % N``),
- wraps to 0 whenever another full window would run past the end,
- the SQL fetch is capped at ``limit`` rows (the reference hard-codes
  ``LIMIT 30`` against a window constant of 50 — both are explicit
  parameters here, with the reference values as defaults).

``:memory:`` stores work too (handy for tests and the synthetic
pipeline); the connection is per-store and thread-confined like the
reference's short-lived connections.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import List, Optional, Sequence, Tuple

#: Reference constants (``client/common.py:15-16``, ``oracle_scheduler.py:61``).
PREDICTION_WINDOW = 50
SQL_FETCH_LIMIT = 30


class CommentStore:
    """SQLite-backed comment store with the reference's schema."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._init_db()

    def _init_db(self) -> None:
        with self._lock:
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS comments (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    comment TEXT NOT NULL,
                    timestamp DATETIME DEFAULT CURRENT_TIMESTAMP
                )
                """
            )
            self._conn.commit()

    def save(self, comments: Sequence[str]) -> int:
        """``save_to_db`` (``scraper.py:57-62``); returns rows inserted."""
        rows = [(c,) for c in comments if c]
        with self._lock:
            self._conn.executemany(
                "INSERT INTO comments (comment) VALUES (?)", rows
            )
            self._conn.commit()
        return len(rows)

    def count(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(id) FROM comments"
            ).fetchone()
        return int(n)

    def last_timestamp(self) -> Optional[str]:
        """Latest ingest time — the scraper's catch-up cursor
        (``scraper.py:78-86``)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT timestamp FROM comments ORDER BY id DESC LIMIT 1"
            ).fetchone()
        return row[0] if row else None

    def read_window(
        self,
        position: int,
        window: int = PREDICTION_WINDOW,
        limit: int = SQL_FETCH_LIMIT,
    ) -> Tuple[List[str], List[str], int]:
        """Circular window read (``oracle_scheduler.py:44-69``).

        Returns ``(comments, timestamps, new_position)``; the caller
        stores ``new_position`` as the simulation cursor
        (``globalState.simulation_step`` semantics).
        """
        n = self.count()
        if n == 0:
            return [], [], 0
        position = (position + window) % n
        if position + window >= n:
            position = 0
        with self._lock:
            rows = self._conn.execute(
                "SELECT comment, timestamp FROM comments "
                "WHERE id >= ? ORDER BY id ASC LIMIT ?",
                (position, limit),
            ).fetchall()
        return [r[0] for r in rows], [r[1] for r in rows], position

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "CommentStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
