"""Training jobs back to back on ten-class rows.

The mix is train_jobs' (the same closed loop of one user, the same job
records and judgement, by import), on rows of `n_classes` planted classes
made from the seed (`yardstick/classes.class_rows`) in place of the
binary planted-separator rows: integer labels in [0, n_classes), which
the program embeds one-hot as the targets of its (d, C) model.

Mix parameters: train_jobs'.
"""

from __future__ import annotations

import types

from drivers import train_jobs
from yardstick import classes, data

judge = train_jobs.judge


def run(h) -> dict:
    n_classes = int(h.cfg["n_classes"])

    def rows(m, d, margin, seed, device):
        return classes.class_rows(m, d, n_classes, margin, seed, device)

    saved = train_jobs.data
    train_jobs.data = types.SimpleNamespace(planted_rows=rows,
                                            program_key=data.program_key)
    try:
        return train_jobs.run(h)
    finally:
        train_jobs.data = saved
