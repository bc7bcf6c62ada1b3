#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port of COPML (`src/repro_torch`).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on the machine it is started on and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device` and, traced,
`breakdown`; its last key, `limits`, gives each number the check compared
with its limit, and the same lines end standard error.

A cell's configuration, traffic mix and metrics are files found by name
(see yardstick/registry.py).  Set-up runs from process start to the
window's start: imports, the CUDA context, the rows made from the seed, the
warm-up (whose first run in a checkout builds the kernels).  After the
window the program's state is freed and the plain reference judges what the
window produced.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is present, when the checkout lacks the program, or when a forbidden
module was loaded (yardstick/guard.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_ENTRY = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "out"


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_ENTRY


AGE_AT_ENTRY = process_age_s()
PHASES = {"interpreter": AGE_AT_ENTRY}   # set-up phases before a cell


def since_start() -> float:
    return AGE_AT_ENTRY + time.perf_counter() - T_ENTRY


def _prepare_environment() -> None:
    """Caches inside the checkout at fixed paths; the program's own kernel
    build lives in src/repro_torch/kernels/build, inside it too."""
    cache = OUT / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


class Refused(RuntimeError):
    """The run cannot be measured here; no result is printed."""


class Harness:
    """What a driver is given: the cell's files, the run's arguments, and
    the two calls that bracket the window."""

    def __init__(self, spec, cell, seed, seconds, trace, device, root,
                 overrides=None):
        from yardstick import registry
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.root = bool(trace), device, root
        self.cfg = dict(registry.config(cell["config"], root),
                        **(overrides or {}))
        self.mix = registry.traffic(cell["traffic"], root)
        self.driver = registry.driver(self.mix["driver"], root)
        self.system = registry.system(self.cfg["system"], root)
        self.reference = registry.reference(self.cfg["reference"], root)
        self.spec = spec
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.phases = {}          # set-up phase -> seconds since start

    def mark(self, phase: str) -> None:
        """Record the end of a set-up phase."""
        self.phases[phase] = since_start()

    def guard(self, when: str) -> None:
        from yardstick import guard
        found = guard.offending(checkout=ROOT)
        if found:
            raise Refused(f"forbidden modules loaded {when}: "
                          f"{', '.join(found)}")

    def before_window(self) -> None:
        self.guard("by set-up")
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.setup_s = since_start()
        self.mark("window")

    def setup_phases(self) -> dict:
        """Seconds of each set-up phase, in order."""
        out, last = {}, 0.0
        for name, t in self.phases.items():
            out[name] = t - last
            last = t
        return out

    def after_window(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        self.guard("once the window closed")


class Context:
    """What a metric's reader reads."""

    def __init__(self, h: Harness, record: dict):
        from yardstick import roofline
        self.cfg, self.mix, self.record = h.cfg, h.mix, record
        self.setup_s = h.setup_s
        self.trace = record.get("trace")
        self.roofline = roofline


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, root: Path = BENCH,
             overrides: dict | None = None) -> dict:
    """One run of a cell on `device`; returns the result object.
    `overrides` replaces fields of the cell's configuration (the control
    runs the reference in the program's place this way)."""
    import torch
    from yardstick import registry

    cell = registry.cell(spec, cell_name)
    h = Harness(spec, cell, seed, seconds, trace, device, root, overrides)
    h.phases.update(PHASES)
    record = h.driver.run(h)
    numbers = h.driver.judge(h, record)
    limits = {k: {"value": v, "limit": h.reference.LIMITS[k]}
              for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in limits.values())

    ctx = Context(h, record)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(spec, cell_name, kind):
        value = registry.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": h.memory_peak_bytes}
    result = {"correct": bool(correct and record["failed"] == 0),
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev}
    dtrace = record.get("trace")
    h.guard("by the end of the run")
    notes = result["notes"] = record.get("notes", {})
    if trace and dtrace is not None:
        lo, hi = dtrace.window("bench.window")
        dev["busy_s"] = dtrace.busy_ns(lo, hi) * 1e-9
        dev["window_s"] = (hi - lo) * 1e-9
        result["breakdown"] = {
            "device_ops": dtrace.device_seconds_by_name(lo, hi),
            "idle_gaps": dtrace.idle_gaps(lo, hi)}
        notes["trace_linked_share"] = dtrace.linked_share()
    notes["setup_phases_s"] = h.setup_phases()
    result["limits"] = limits
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_environment()
    try:
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise Refused("the checkout has no src/repro_torch")
        import torch
        PHASES["torch_import"] = since_start()
        from yardstick import registry
        spec = registry.load_spec(ROOT / "BENCHMARK.json")
        chips = int(registry.cell(spec, args.workload)["chips"])
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count()} present")
        torch.zeros(1, device="cuda")
        PHASES["cuda_context"] = since_start()
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda"))
    except Refused as exc:
        print(f"bench: refused: {exc}", file=sys.stderr)
        return 2
    for name, v in result["limits"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
