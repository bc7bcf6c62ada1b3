"""Communication/computation cost model (paper Table II + Appendix C/D).

A verbatim copy of the JAX package's core/cost_model.py (pure Python host
arithmetic; nothing here runs on a device): api.fit fills
TrainResult.cost from it for copml and mpc_baseline.  These are MODELED
wire costs on the paper's EC2-like WAN parameters (40 Mbps, m3.xlarge):
the port simulates all N clients on one device and exchanges nothing, so
a device time measured beside them is simulated compute only.

All counts are per-client, per the paper's Section V-C accounting, in field
elements (multiply by ~bytes_per_elem for bytes; the paper's 64-bit impl
ships 8 B/elem, our int32 impl ships 4 B/elem).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WanParams:
    bandwidth_mbps: float = 40.0       # paper Section V-A
    latency_s: float = 0.05            # WAN RTT ~ 100 ms
    # measured on this host by benchmarks/kernel_micro.py; the paper's
    # m3.xlarge achieves a similar order for 64-bit modular matmul
    field_macs_per_s: float = 2.0e8
    bytes_per_elem: int = 8


@dataclasses.dataclass(frozen=True)
class Workload:
    m: int
    d: int
    n: int
    k: int
    t: int
    iters: int
    r: int = 1
    c: int = 1       # model columns (1 = vector model; C for one-vs-rest)


def copml_costs(w: Workload, hw: WanParams = WanParams()) -> dict:
    """Per-client costs of COPML (Table II row).

    comm elements:  (m/K)dN  (dataset coded slices, paid ONCE regardless of
                    the model width C)  +  dCNJ (model encodings)
                    + dCNJ (local computation shares)
    compute MACs:   2(m/K)dC J     (Eq. 7 matmul pair, dominant)
    encoding MACs:  (m/K)dN(K+T)   +  dCN(K+T)J

    The C > 1 terms are what the `multiclass` benchmark stage compares
    against C independent binary runs: encode-once amortizes the dominant
    dataset-sharing term across all C classes.
    """
    m, d, n, k, t, j, c = w.m, w.d, w.n, w.k, w.t, w.iters, w.c
    comm_elems = m * d * n / k + 2 * d * c * n * j
    # X~ w~  +  X~^T g  as matvec chain: 2*(m/K)*d*C MACs per iteration.
    # (The paper prices the Gram form O(m d^2 / K); the matvec chain is
    # strictly cheaper for J < d/2 and is what our implementation does.)
    comp_macs = 2.0 * (m / k) * d * c * j
    enc_macs = (m / k) * d * n * (k + t) + d * c * n * (k + t) * j
    return _price(comm_elems, comp_macs, enc_macs, hw, rounds=3 * j + 2)


def mpc_baseline_costs(w: Workload, hw: WanParams = WanParams(),
                       scheme: str = "bh08", groups: int = 3) -> dict:
    """Per-client costs of the optimized Appendix-D baselines.

    The baselines perform degree reduction PER MULTIPLICATION GATE (the
    paper: "intensive communication and computation to carry out a degree
    reduction step for secure multiplication").  Gates per iteration per
    subgroup: z = Xw has (m/G)*d scalar gates, the degree-r Horner chain
    r*(m/G), X^T ghat another (m/G)*d.  Per client per gate: BH08 masks +
    opens one value (~2 elements on the wire); BGW re-shares to all N_g.
    This accounting reproduces the paper's Table I within ~2x:
    BGW 21142 s, BH08 6812 s comm at N=50/CIFAR-10.
    """
    m, d, n, j = w.m, w.d, w.n, w.iters
    n_g = max(1, n // groups)
    gates_per_iter = (2.0 * (m / groups) * d + w.r * (m / groups)) * w.c
    per_gate = float(n_g) if scheme == "bgw" else 2.0
    comm_elems = (m / n) * d * n_g                 # initial data sharing
    comm_elems += gates_per_iter * per_gate * j
    comp_macs = 2.0 * (m / groups) * d * w.c * j   # local share matmuls
    enc_macs = gates_per_iter * n_g * j            # reduction encode/decode
    return _price(comm_elems, comp_macs, enc_macs, hw,
                  rounds=(2 + w.r) * j + 1)


def _price(comm_elems, comp_macs, enc_macs, hw: WanParams, rounds: int) -> dict:
    comm_s = comm_elems * hw.bytes_per_elem * 8 / (hw.bandwidth_mbps * 1e6)
    comm_s += rounds * hw.latency_s
    comp_s = comp_macs / hw.field_macs_per_s
    enc_s = enc_macs / hw.field_macs_per_s
    return {"comm_s": comm_s, "comp_s": comp_s, "enc_s": enc_s,
            "total_s": comm_s + comp_s + enc_s}


def speedup(w: Workload, hw: WanParams = WanParams(),
            scheme: str = "bh08") -> float:
    base = mpc_baseline_costs(w, hw, scheme)["total_s"]
    ours = copml_costs(w, hw)["total_s"]
    return base / ours


def proc_net_frames(procs: int, iters: int, history: bool = False) -> dict:
    """Exact per-phase SENT frame counts of one clean proc:P run.

    The analytic side of the modeled-vs-measured story for the
    multi-process engine: commlint (COM009) cross-checks these closed
    forms against the frame budget derived from the choreography spec in
    analysis/choreography.py, and the procnet benchmark + engine tests
    compare both against the live measured_comm["frames_by_phase"]
    counters bit-for-bit.  Frames are counted at the SEND side (sends
    never block), so the totals are timing-invariant: stale frames a
    slow worker's recv_any later drops are still counted here and only
    show up separately in measured_comm["dropped_frames"].

    Closed forms (P = procs, J = iters):
      setup      = P(P-1)/2 + 6P   HELLO mesh + coordinator dials, then
                                   LISTEN/SESSION/READY/START/BYE and
                                   the per-worker HELLO to the coord
      encode     = P(P-1) * J      ENC all-to-all
      exchange   = P(P-1) * J      SHARE all-to-all
      trunc_open = 2P * J          OPEN gather + OPENED broadcast
      open_model = P*J [history] + P   per-step opening + RESULT
    Zero-count phases are omitted so the dict compares directly with
    measured_comm["frames_by_phase"] at any P.
    """
    p, j = int(procs), int(iters)
    out = {
        "setup": p * (p - 1) // 2 + 6 * p,
        "encode": p * (p - 1) * j,
        "exchange": p * (p - 1) * j,
        "trunc_open": 2 * p * j,
        "open_model": (p * j if history else 0) + p,
    }
    return {phase: n for phase, n in out.items() if n}
