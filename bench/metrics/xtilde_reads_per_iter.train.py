"""xtilde_reads_per_iter.train: full passes over the coded rows X~ a step,
from the program's own counts of each job's coded gradients
(`timings["counts"]`, ops.gradient_counts taken across the job): one for
each gradient on the body route (the gradient kernel's launches,
"fused_step" and "coded_gradient*") or on the cluster route ("cluster"),
two for each on the wide route ("gradient"), over the job's steps, mean
over the window's jobs that the profiler did not record.  It reads 1.0
where every step reads X~ once.  None where the program keeps no counts,
or counted no gradient (a run on the CPU)."""

from yardstick import readings

ONCE = ("fused_step", "coded_gradient_batched", "coded_gradient_matrix",
        "coded_gradient", "cluster")
TWICE = ("gradient",)


def read(ctx):
    jobs = readings.untraced_jobs(ctx)
    counts = [j["timings"].get("counts") for j in jobs]
    if not jobs or not all(counts):
        return None
    reads = sum(sum(c[k] for k in ONCE) + 2 * sum(c[k] for k in TWICE)
                for c in counts)
    if not reads:
        return None
    return reads / (ctx.cfg["iters"] * len(jobs))
