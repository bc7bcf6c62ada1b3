"""SecureServer: micro-batched scoring against a secret-shared model.

Ties the two halves of the serving subsystem together: a CodedModel
(serve/coded.py -- the encode-once share artifact) and a MicroBatchQueue
(serve/queue.py -- the batching window).  Three engine kinds:

  eager, jit  one path here: every window is quantize, one field GEMM
              (ops.modmatmul) and a reconstruct on the model's device.
  sharded     the client axis split over a core/meshutil ClientMesh: each
              rank scores its own clients' shares, and only the opened
              logits cross ranks (serve/coded.sharded_scorer).

All three give the bits of the quantized reference scorer.

The model stays secret-shared for the server's whole lifetime; the only
declassification is `coded.open_logits` on per-query scores.  Predictions
follow the workload's objective: argmax for matrix models, sign for
binary logistic, raw scores for regression.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import obs
from ..core import quantize
from . import coded
from .queue import MicroBatchQueue

#: engine kinds a SecureServer runs (api.serving validates the spec)
SERVE_KINDS = ("eager", "jit", "sharded")


def check_kind(kind: str) -> None:
    """Raise unless `kind` is one of SERVE_KINDS."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"engine kind {kind!r} cannot serve (supported: "
                         f"{SERVE_KINDS}); proc:N serving is future work")


@dataclasses.dataclass
class SecureServer:
    """A live serving endpoint over one encoded model.

    Construct via `api.serve(workload, result, engine)`.  `stats` is
    cumulative across serve() calls: queries / batches / padded rows /
    serve_s wall seconds / queries_per_s, plus the one-time encode_s."""
    workload: str             # workload name the model was trained on
    protocol: str             # protocol that produced the TrainResult
    engine: str               # engine label ("jit", "sharded:4", ...)
    kind: str                 # engine kind: eager | jit | sharded
    batch_size: int           # micro-batch window size
    window_ms: float          # micro-batch window in milliseconds
    model: coded.CodedModel   # the encode-once share artifact
    objective: object         # the workload's SecureObjective
    mesh: object | None = None          # ClientMesh (sharded only)
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        check_kind(self.kind)
        if self.kind == "sharded" and self.mesh is None:
            raise ValueError("sharded serving needs a mesh")
        self._sharded = None if self.kind != "sharded" else \
            coded.sharded_scorer(self.model, self.mesh)
        self.stats.update({"queries": 0, "batches": 0, "padded": 0,
                           "serve_s": 0.0, "queries_per_s": 0.0,
                           "encode_s": self.model.encode_s})

    # ------------------------------------------------------------ scoring

    def _score(self, queries):
        """queries float (B, d) -> Opened field logits (B, C') on the
        model's device."""
        if self._sharded is not None:
            return self._sharded(queries)
        xq = coded.quantize_queries(self.model, queries)
        return coded.open_logits(coded.score_shares(self.model, xq),
                                 self.model)

    def score_field(self, queries) -> np.ndarray:
        """Exact field-domain logits (B, C') int32 at scale lx + lw --
        the value tests compare bit for bit against
        `coded.reference_scores` of the opened model."""
        return self._score(queries).cpu().numpy()

    def logits(self, queries) -> np.ndarray:
        """Dequantized float logits (B, C'), brought to the host (span
        `serve.fetch`: the dequantize and the copy that waits for the
        window's kernels)."""
        z = self._score(queries)
        with obs.span("serve.fetch"):
            return quantize.dequantize(z, self.model.lz).cpu().numpy()

    def predict(self, queries) -> np.ndarray:
        """Per-query decisions on an un-queued batch (see _decide)."""
        return self._decide(self.logits(queries))

    def _decide(self, logits: np.ndarray) -> np.ndarray:
        """(B, C') float logits -> per-query outputs: argmax class index
        for matrix models, {0,1} sign decision for binary logistic, raw
        scores for regression."""
        if self.model.out_shape:
            return np.argmax(logits, axis=1)
        if getattr(self.objective, "dataset_kind", "binary") == "regression":
            return logits[:, 0]
        return (logits[:, 0] > 0).astype(np.int32)

    # ------------------------------------------------------- the serve loop

    def serve(self, queries, clock=None) -> tuple:
        """Stream `queries` (Q, d) through the micro-batch window.

        Returns (predictions (Q,) in submission order, stats).  Windows
        flush when full or when `window_ms` expires between submissions
        (the injectable `clock` makes the expiry testable); the stream's
        tail flushes unconditionally, zero-padded to batch_size."""
        q = MicroBatchQueue(self.batch_size, self.window_ms,
                            clock=clock if clock is not None
                            else time.monotonic)
        rows = np.asarray(queries, np.float32)
        assert rows.ndim == 2 and rows.shape[1] == self.model.d, (
            rows.shape, self.model.d)
        out: dict = {}
        t0 = time.perf_counter()
        for row in rows:
            q.submit(row)
            if q.ready():
                self._flush(q, out)
        while len(q):                       # end of stream: drain the tail
            self._flush(q, out)
        elapsed = time.perf_counter() - t0
        self.stats["serve_s"] += elapsed
        self.stats["queries_per_s"] = (
            self.stats["queries"] / max(self.stats["serve_s"], 1e-9))
        preds = np.asarray([out[i] for i in range(len(rows))])
        return preds, dict(self.stats)

    def _flush(self, q: MicroBatchQueue, out: dict) -> None:
        tickets, batch, n_valid = q.drain()
        logits = self.logits(batch)
        decisions = self._decide(logits[:n_valid])
        for ticket, value in zip(tickets, decisions):
            out[ticket] = value
        self.stats["queries"] += n_valid
        self.stats["batches"] += 1
        self.stats["padded"] += len(batch) - n_valid

    def summary(self) -> str:
        s = self.stats
        return (f"{self.workload} x {self.protocol} x {self.engine}: "
                f"{s['queries']} queries in {s['batches']} batches "
                f"({s['padded']} padded rows), "
                f"{s['queries_per_s']:.0f} q/s, "
                f"encode {s['encode_s'] * 1e3:.1f}ms")
