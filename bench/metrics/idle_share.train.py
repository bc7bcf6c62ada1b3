"""idle_share.train: the share of the traced job's wall time in which no
operation ran on the device (1 - union of device operations over the
traced window), in percent."""

from yardstick import readings


def read(ctx):
    return readings.idle_pct(ctx)
