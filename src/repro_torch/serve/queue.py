"""Micro-batch accumulation for the secure serving path.

Queries arrive one at a time; field GEMMs want batches.  The queue
accumulates up to `batch_size` queries or `window_ms` milliseconds --
whichever comes first -- then drains ONE zero-padded (batch_size, d)
batch, so the server scores every window at one shape (ragged tails
are padded).  A plain copy of the JAX package's serve/queue.py.

Secrecy note: queries and predictions are the *client's* data on the
serving path -- the queue never touches model shares, so it carries no
field/share invariants.  Determinism note: the clock is injectable
(`clock=` returns seconds, default time.monotonic) so the window policy
is testable without sleeping (the serving tests drive a fake clock).
"""

from __future__ import annotations

import time

import numpy as np


class MicroBatchQueue:
    """Accumulate queries; flush on batch-full or window-expired.

    submit() returns a monotonically increasing ticket; drain() returns
    the tickets of the drained window in submission order, so callers
    can re-associate predictions with queries (order preservation is a
    property test, not a convention).
    """

    def __init__(self, batch_size: int, window_ms: float,
                 clock=time.monotonic):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        self.batch_size = int(batch_size)
        self.window_ms = float(window_ms)
        self.clock = clock
        self._rows: list = []        # (ticket, (d,) float32 row)
        self._next_ticket = 0
        self._window_start: float | None = None

    def __len__(self) -> int:
        return len(self._rows)

    def submit(self, query) -> int:
        """Enqueue one (d,) query; returns its ticket."""
        row = np.asarray(query, np.float32)
        if row.ndim != 1:
            raise ValueError(f"expected a (d,) query row, got {row.shape}")
        if self._rows and row.shape != self._rows[0][1].shape:
            raise ValueError(
                f"query dim {row.shape} != pending {self._rows[0][1].shape}")
        if not self._rows:
            self._window_start = self.clock()
        ticket = self._next_ticket
        self._next_ticket += 1
        self._rows.append((ticket, row))
        return ticket

    def ready(self, now: float | None = None) -> bool:
        """True when a window should flush: batch full, or the oldest
        pending query has waited >= window_ms."""
        if not self._rows:
            return False
        if len(self._rows) >= self.batch_size:
            return True
        now = self.clock() if now is None else now
        return (now - self._window_start) * 1e3 >= self.window_ms

    def drain(self) -> tuple:
        """Pop one window: (tickets, batch, n_valid).

        batch is ALWAYS (batch_size, d) float32 -- ragged tails are
        zero-padded so every window hits the same compiled scorer;
        n_valid says how many leading rows are real queries."""
        if not self._rows:
            raise ValueError("drain() on an empty queue")
        take = self._rows[: self.batch_size]
        self._rows = self._rows[self.batch_size:]
        self._window_start = self.clock() if self._rows else None
        tickets = tuple(tk for tk, _ in take)
        d = take[0][1].shape[0]
        batch = np.zeros((self.batch_size, d), np.float32)
        for i, (_, row) in enumerate(take):
            batch[i] = row
        return tickets, batch, len(take)
