"""The proc-engine protocol as data: roles, rounds, and frame budgets.

This module is commlint's ground truth.  Every wire interaction of the
multi-process runtime (launch/runtime/{worker,session,net}.py) is
declared here as a `Round`: which kind it rides on, which role sends and
which receives, the per-leg cardinality (one frame vs a peer loop), the
step/tag discipline, the measured_comm phase its sends must be counted
under, and the payload format.  commlint.py extracts the actual call
sites from the source and diffs them against this spec; the COM rules in
registry.RULES are the diff categories.

The same declaration doubles as the *static comm budget*:
`frames_by_phase(P, iters, history)` computes the exact number of frames
a clean run sends per measured_comm phase -- cross-checked against
`core/cost_model.proc_net_frames` (COM009) and, in
benchmarks/procnet_bench.py and tests/test_runtime_engine.py, against
the live `TrainResult.measured_comm["frames_by_phase"]` counters
bit-for-bit.  Stale frames dropped by `recv_any` are counted at the
*send* side like every other frame, so the budget is timing-invariant;
the receiver-side `measured_comm["dropped_frames"]` record is excluded
from this comparison by construction.

Grammar (documented in docs/ANALYSIS.md "Choreography grammar"):

  Leg(role, cardinality)      one side of a round.  role is "worker" or
                              "coord"; cardinality is "one" (a single
                              frame per occurrence), "per_peer" (a loop
                              over the other workers, P-1 frames) or
                              "per_worker" (a loop over all P workers).
  Round(name, kind, tag, scope, phase, payload, send, recv, ...)
      scope   "session" (once per run), "step" (once per training step),
              "history_step" (once per step on history runs only),
              "error" (failure path, zero frames in a clean run).
      phase   the measured_comm phase every send of the round must pass
              as its `phase=` kwarg (or inherit as the default).
      payload "array" (wire.share_payload / wire.pack_array), "pickle"
              (a registered control frame -- the ONLY sanctioned pickle
              sites), "json" (UTF-8 json.dumps), or "empty".
      adaptive  the recv leg is a straggler-tolerant collect: it must
              own at least one `recv_any` with an explicit bounded
              timeout (COM006).
      barrier both legs gate progress; a half-instantiated barrier
              round is a deadlock finding (COM005).
"""

from __future__ import annotations

import dataclasses

#: wire kind name -> header id, mirroring launch/runtime/net.py.  commlint
#: cross-checks the two tables (COM007 fires on drift) so the spec can
#: never silently fall behind the transport.
KINDS = {
    "HELLO": 1,
    "LISTEN": 2,
    "SESSION": 3,
    "READY": 4,
    "START": 5,
    "ENC": 6,
    "SHARE": 7,
    "OPEN": 8,
    "OPENED": 9,
    "RESULT": 10,
    "BYE": 11,
    "ERR": 12,
}

#: tag sub-channel names -> values (OPEN/OPENED carry these)
TAGS = {"TAG_TRUNC": 0, "TAG_HIST": 1}

ROLES = ("worker", "coord")

#: measured_comm phases a clean run populates, in protocol order
PHASES = ("setup", "encode", "exchange", "trunc_open", "open_model")


@dataclasses.dataclass(frozen=True)
class Leg:
    role: str            # "worker" | "coord"
    cardinality: str     # "one" | "per_peer" | "per_worker"


@dataclasses.dataclass(frozen=True)
class Round:
    name: str
    kind: str            # key into KINDS
    scope: str           # "session" | "step" | "history_step" | "error"
    phase: str           # measured_comm phase of the sends
    payload: str         # "array" | "pickle" | "json" | "empty"
    send: Leg
    recv: Leg | None     # None -> fire-and-forget (transport dispatches)
    tag: str | None = None      # key into TAGS; None -> tag 0, untagged
    adaptive: bool = False      # recv is a bounded-timeout collect
    barrier: bool = True        # both legs gate progress
    order: int = 0              # position in the per-role choreography
    extract: bool = False       # False: transport-internal (net.py only)

    def occurrences(self, iters: int, history: bool) -> int:
        if self.scope == "session":
            return 1
        if self.scope == "step":
            return iters
        if self.scope == "history_step":
            return iters if history else 0
        return 0                              # "error": clean-run budget

    def frames_per_occurrence(self, procs: int) -> int:
        """Frames the SEND leg emits per occurrence, across all P workers."""
        if self.kind == "HELLO":
            # every worker dials the coordinator (P) plus each lower-ranked
            # peer of the full mesh (sum over ranks = P*(P-1)/2); the
            # coordinator never dials.
            return procs + procs * (procs - 1) // 2
        per_role = {"worker": procs, "coord": 1}[self.send.role]
        per_leg = {"one": 1,
                   "per_peer": procs - 1,
                   "per_worker": procs}[self.send.cardinality]
        return per_role * per_leg


def _mk_rounds():
    w1 = Leg("worker", "one")
    wp = Leg("worker", "per_peer")
    cw = Leg("coord", "per_worker")
    rounds = [
        # transport handshake: emitted inside net.Node._connect, not a
        # node.send site -- budget-only (extract=False keeps the
        # extractor from demanding call sites for it).
        Round("hello", "HELLO", "session", "setup", "empty",
              Leg("worker", "one"), None, barrier=False),
        Round("listen", "LISTEN", "session", "setup", "pickle",
              w1, cw),
        Round("session_deal", "SESSION", "session", "setup", "pickle",
              cw, w1),
        Round("ready", "READY", "session", "setup", "empty", w1, cw),
        Round("start", "START", "session", "setup", "empty", cw, w1),
        Round("enc", "ENC", "step", "encode", "array",
              wp, Leg("worker", "per_peer")),
        Round("share", "SHARE", "step", "exchange", "array",
              wp, Leg("worker", "per_peer"), adaptive=True),
        Round("open_trunc", "OPEN", "step", "trunc_open", "array",
              w1, cw, tag="TAG_TRUNC"),
        Round("opened_trunc", "OPENED", "step", "trunc_open", "array",
              cw, w1, tag="TAG_TRUNC"),
        Round("open_hist", "OPEN", "history_step", "open_model", "array",
              w1, cw, tag="TAG_HIST"),
        Round("result", "RESULT", "session", "open_model", "pickle",
              w1, cw),
        Round("bye", "BYE", "session", "setup", "empty", cw, w1),
        # failure path: the receiving transport turns it into PeerFailure
        # inside net._dispatch, so there is no recv site to demand.
        Round("err", "ERR", "error", "setup", "json", w1, None,
              barrier=False),
    ]
    return tuple(
        dataclasses.replace(r, order=i, extract=r.kind != "HELLO")
        for i, r in enumerate(rounds))


ROUNDS = _mk_rounds()

#: the sanctioned pickle-over-the-wire control frames (COM008): anything
#: else serializing with pickle near the wire is a finding.
PICKLE_ROUNDS = tuple(r.name for r in ROUNDS if r.payload == "pickle")


def rounds_for(kind: str, tag: str | None = None):
    """Rounds riding on `kind`; a concrete tag narrows to its sub-channel."""
    hits = [r for r in ROUNDS if r.kind == kind]
    if tag is not None:
        exact = [r for r in hits if r.tag == tag]
        if exact:
            return exact
    return hits


def frames_by_phase(procs: int, iters: int, history: bool = False) -> dict:
    """Exact per-phase SENT frame counts of one clean proc:P run.

    Closed forms (P = procs, J = iters):
      setup      = P(P-1)/2 + 6P   (HELLO mesh+coord, LISTEN, SESSION,
                                    READY, START, BYE)
      encode     = P(P-1) * J      (ENC all-to-all)
      exchange   = P(P-1) * J      (SHARE all-to-all)
      trunc_open = 2P * J          (OPEN gather + OPENED broadcast)
      open_model = P*J [history] + P  (per-step model opening + RESULT)
    Zero-frame phases are omitted so the dict compares bit-for-bit with
    measured_comm["frames_by_phase"] at any P (P=1 sends no ENC/SHARE).
    """
    out: dict = {}
    for r in ROUNDS:
        n = r.frames_per_occurrence(procs) * r.occurrences(iters, history)
        if n:
            out[r.phase] = out.get(r.phase, 0) + n
    return out
