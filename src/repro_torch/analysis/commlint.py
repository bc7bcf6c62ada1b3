"""commlint: choreography + comm-cost checks for the proc-engine protocol.

The pass runs inside `analyze_paths` (``--pass comm``; the default runs
seclint and commlint together) and shares seclint's waiver / report /
CLI infrastructure: every check lands as a `Finding` whose COM rule id
lives in registry.RULES, so the pragma grammar and the budget report
cover both pass families.

How it works:

1.  Runtime *groups* are discovered structurally: any directory in the
    indexed tree holding both a ``worker.py`` and a ``session.py`` is a
    runtime (the real one is ``launch/runtime/``; the fixture corpus
    of tests provides miniature ones).  A
    ``net.py`` sibling marks the group as a full transport: its kind
    table is cross-checked against the spec and the group must
    instantiate every declared round.
2.  An AST extractor inventories every ``node.send`` / ``node.recv`` /
    ``node.recv_any`` call site -- kind, peer expression, step/tag
    expressions, timeout policy, payload serialization, and
    enclosing-loop cardinality (ast.For / ast.While / comprehension
    generators all count; a peer expression that is an enclosing loop
    target makes the site a peer-loop site).
3.  Sites are matched to the declarative rounds in choreography.py and
    diffed: COM001/002 orphan/unfulfillable legs, COM003 cardinality +
    addressing, COM004 step/tag/phase discipline, COM005 deadlock
    (missing barrier legs plus a progress simulation over the per-role
    event order), COM006 adaptive-collect timeouts, COM007 inventory
    failures (unknown kinds, spec/transport drift), COM008 pickle
    discipline (bridging to seclint's `share_payload` declassify sink),
    COM009 static frame budget vs `core/cost_model.proc_net_frames`.

The analysis is purely syntactic -- nothing from the target tree is
imported -- so it runs identically on the live runtime, on tempdir
corruption-drill copies, and on the fixture corpus.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from . import choreography as spec
from .report import Finding

_GROUP_FILES = ("worker.py", "session.py", "net.py")
_ROLE_OF = {"worker.py": "worker", "session.py": "coord"}

#: wire kinds allowed to carry pickle (the registered control frames)
_PICKLE_KINDS = frozenset(
    r.kind for r in spec.ROUNDS if r.payload == "pickle")

#: (procs, iters, history) samples the COM009 budget cross-check runs on
_BUDGET_SAMPLES = ((1, 1, False), (3, 5, False), (4, 10, True),
                   (8, 2, True))


@dataclasses.dataclass
class Site:
    """One inventoried wire call site."""
    path: str
    line: int
    col: int
    func: str
    role: str            # "worker" | "coord"
    op: str              # "send" | "recv" | "recv_any"
    kind: str | None     # resolved kind name, None when unresolvable
    kind_raw: str        # source text of the kind expression
    peer: str            # "coord" | "loop" | "const" | "var" | "any"
    multi: bool          # emitted/consumed inside a peer loop
    step: tuple          # ("none" | "const" | "var", value)
    tag: tuple           # ("none" | "attr" | "const" | "var", value)
    phase: tuple         # ("none" | "const" | "var", value)   (sends)
    timeout: bool        # explicit timeout argument present
    payload: str         # pickle|json|array|raw|empty|unknown


def _find(rule, message, site_or_path, line=0):
    if isinstance(site_or_path, Site):
        return Finding(rule, message, site_or_path.path, site_or_path.line,
                       site_or_path.col)
    return Finding(rule, message, site_or_path, line)


# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------

def _expr_class(expr):
    if expr is None:
        return ("none", None)
    if isinstance(expr, ast.Constant):
        return ("const", expr.value)
    return ("var", ast.unparse(expr))


def _tag_class(expr):
    if expr is None:
        return ("none", None)
    if isinstance(expr, ast.Constant):
        return ("none", None) if expr.value == 0 else ("const", expr.value)
    if isinstance(expr, ast.Attribute):
        return ("attr", expr.attr)
    if isinstance(expr, ast.Name):
        if expr.id in spec.TAGS or expr.id.startswith("TAG_"):
            return ("attr", expr.id)
        return ("var", expr.id)
    return ("var", ast.unparse(expr))


def _kind_name(expr):
    """(resolved kind name or None, raw source text)."""
    if expr is None:
        return None, "<missing>"
    raw = ast.unparse(expr)
    if isinstance(expr, ast.Attribute):
        return expr.attr, raw
    if isinstance(expr, ast.Name):
        return expr.id, raw
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        rev = {v: k for k, v in spec.KINDS.items()}
        return rev.get(expr.value), raw
    return None, raw


class _Extractor(ast.NodeVisitor):
    """Walk one worker.py / session.py module and inventory wire sites."""

    def __init__(self, path, role):
        self.path = path
        self.role = role
        self.sites: list = []
        self.site_by_node: dict = {}       # id(call) -> Site
        self.pickle_loads: list = []       # (call node, func)
        self.pickle_dumps: list = []       # (call node, func)
        self.covered_dumps: set = set()    # dump ids inside send payloads
        self.covered_names: set = set()    # (func, name) used as a payload
        self.pending_dumps: dict = {}      # (func, name) -> {dump ids}
        self.bindings: dict = {}           # (func, name) -> recv Site
        self.payload_bindings: dict = {}   # (func, name) -> payload class
        self._funcs = ["<module>"]
        self._loops: list = []             # per-level sets of target names

    # -- context ----------------------------------------------------------

    @property
    def func(self):
        return self._funcs[-1]

    def visit_FunctionDef(self, node):
        self._funcs.append(f"{self.func}.{node.name}")
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    @staticmethod
    def _target_names(tgt):
        return {n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)}

    def visit_For(self, node):
        self.visit(node.iter)
        self._loops.append(self._target_names(node.target))
        for sub in node.body + node.orelse:
            self.visit(sub)
        self._loops.pop()

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self.visit(node.test)
        self._loops.append(set())
        for sub in node.body + node.orelse:
            self.visit(sub)
        self._loops.pop()

    def _comprehension(self, node, inner):
        pushed = 0
        for gen in node.generators:
            self.visit(gen.iter)
            self._loops.append(self._target_names(gen.target))
            pushed += 1
            for cond in gen.ifs:
                self.visit(cond)
        for expr in inner:
            self.visit(expr)
        del self._loops[-pushed:]

    def visit_ListComp(self, node):
        self._comprehension(node, [node.elt])

    visit_SetComp = visit_GeneratorExp = visit_ListComp

    def visit_DictComp(self, node):
        self._comprehension(node, [node.key, node.value])

    def visit_Assign(self, node):
        self.visit(node.value)
        for tgt in node.targets:
            self.visit(tgt)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            key = (self.func, node.targets[0].id)
            site = self.site_by_node.get(id(node.value))
            if site is not None and site.op in ("recv", "recv_any"):
                self.bindings[key] = site
            cls = self._payload_class(node.value, follow=False)
            if cls != "unknown":
                self.payload_bindings[key] = cls
                if cls == "pickle":
                    self.pending_dumps[key] = {
                        id(sub) for sub in ast.walk(node.value)
                        if self._is_pickle_dumps(sub)}

    # -- call sites -------------------------------------------------------

    @staticmethod
    def _is_pickle_dumps(node):
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "pickle")

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.attr in ("send", "recv", "recv_any"):
                self._site(node)
            elif f.value.id == "pickle" and f.attr in ("dumps", "loads"):
                bucket = (self.pickle_dumps if f.attr == "dumps"
                          else self.pickle_loads)
                bucket.append((node, self.func))
        self.generic_visit(node)

    def _site(self, call):
        op = call.func.attr
        args = call.args
        kws = {k.arg: k.value for k in call.keywords if k.arg}

        def arg(i, name):
            if name in kws:
                return kws[name]
            return args[i] if len(args) > i else None

        payload_e = phase_e = timeout_e = None
        if op == "send":
            kind_e, peer_e = arg(1, "kind"), arg(0, "dst")
            step_e, tag_e = arg(2, "step"), arg(3, "tag")
            payload_e, phase_e = arg(4, "payload"), kws.get("phase")
        elif op == "recv":
            kind_e, peer_e = arg(0, "kind"), arg(1, "src")
            step_e, tag_e = arg(2, "step"), arg(3, "tag")
            timeout_e = arg(4, "timeout")
        else:                                           # recv_any
            kind_e, peer_e, tag_e = arg(0, "kind"), None, None
            step_e, timeout_e = arg(1, "step"), arg(2, "timeout")

        kind, kind_raw = _kind_name(kind_e)
        peer, peer_name = self._peer(peer_e)
        in_loop = bool(self._loops)
        multi = (peer == "loop"
                 or (op == "recv_any" and in_loop)
                 or (peer == "any" and in_loop))
        site = Site(
            path=self.path, line=call.lineno, col=call.col_offset,
            func=self.func, role=self.role, op=op,
            kind=kind, kind_raw=kind_raw, peer=peer, multi=multi,
            step=_expr_class(step_e), tag=_tag_class(tag_e),
            phase=_expr_class(phase_e), timeout=timeout_e is not None,
            payload=self._payload_class(payload_e) if op == "send"
            else "unknown")
        self.sites.append(site)
        self.site_by_node[id(call)] = site
        if payload_e is not None:
            for sub in ast.walk(payload_e):
                if self._is_pickle_dumps(sub):
                    self.covered_dumps.add(id(sub))
            if isinstance(payload_e, ast.Name):
                self.covered_names.add((self.func, payload_e.id))

    def _peer(self, expr):
        if expr is None:
            return "any", None
        if isinstance(expr, ast.Attribute) and expr.attr == "COORD":
            return "coord", None
        if isinstance(expr, ast.Name):
            if expr.id == "COORD":
                return "coord", None
            if any(expr.id in targets for targets in self._loops):
                return "loop", expr.id
            return "var", expr.id
        if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
            return ("coord", None) if expr.value == 0xFFFF \
                else ("const", expr.value)
        return "var", ast.unparse(expr)

    def _payload_class(self, expr, follow=True):
        if expr is None:
            return "empty"
        if isinstance(expr, ast.Constant):
            return "empty" if expr.value in (b"", "") else "raw"
        if isinstance(expr, ast.Name) and follow:
            return self.payload_bindings.get((self.func, expr.id), "unknown")
        found = set()
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call):
                continue
            sf = sub.func
            if isinstance(sf, ast.Attribute):
                base = sf.value.id if isinstance(sf.value, ast.Name) else ""
                if sf.attr == "dumps" and base == "pickle":
                    found.add("pickle")
                elif sf.attr == "dumps" and base == "json":
                    found.add("json")
                elif sf.attr in ("share_payload", "pack_array"):
                    found.add("array")
                elif sf.attr in ("tobytes", "encode"):
                    found.add("raw")
            elif isinstance(sf, ast.Name):
                if sf.id in ("share_payload", "pack_array"):
                    found.add("array")
                elif sf.id == "bytes":
                    found.add("raw")
        for cls in ("pickle", "json", "array", "raw"):
            if cls in found:
                return cls
        return "unknown"

    # -- post-pass: pickle discipline (COM008) ----------------------------

    def pickle_findings(self):
        out = []
        for key in self.covered_names:
            self.covered_dumps |= self.pending_dumps.get(key, set())
        for node, _func in self.pickle_dumps:
            if id(node) not in self.covered_dumps:
                out.append(Finding(
                    "COM008", "pickle.dumps outside a registered wire "
                    "control frame (arrays cross processes only through "
                    "wire.share_payload, the seclint declassify sink)",
                    self.path, node.lineno, node.col_offset))
        for node, func in self.pickle_loads:
            site = None
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and id(sub) in self.site_by_node:
                    site = self.site_by_node[id(sub)]
                    break
                if site is None and isinstance(sub, ast.Attribute) \
                        and sub.attr == "payload" \
                        and isinstance(sub.value, ast.Name):
                    site = self.bindings.get((func, sub.value.id))
            if site is None:
                out.append(Finding(
                    "COM008", "pickle.loads of an unidentified payload "
                    "(cannot be tied to a registered control frame recv)",
                    self.path, node.lineno, node.col_offset))
            elif site.kind not in _PICKLE_KINDS:
                out.append(Finding(
                    "COM008", f"pickle.loads of a `{site.kind}` payload -- "
                    f"the registered pickle control frames are "
                    f"{sorted(_PICKLE_KINDS)}",
                    self.path, node.lineno, node.col_offset))
        return out


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def _assign_sites(sites, findings):
    """Match sites to spec rounds; COM007 for inventory failures."""
    assigned = {r.name: {"send": [], "recv": []} for r in spec.ROUNDS}
    for s in sites:
        if s.kind is None or s.kind not in spec.KINDS:
            findings.append(_find(
                "COM007", f"wire kind `{s.kind_raw}` is absent from the "
                "choreography spec (inventory failure)", s))
            continue
        tag_name = s.tag[1] if s.tag[0] == "attr" else None
        if tag_name is not None and tag_name not in spec.TAGS:
            findings.append(_find(
                "COM004", f"unknown tag sub-channel `{tag_name}` on "
                f"`{s.kind}` (declared tags: {sorted(spec.TAGS)})", s))
            tag_name = None
        leg = "send" if s.op == "send" else "recv"
        cands = [r for r in spec.rounds_for(s.kind, tag_name)
                 if (r.send.role == s.role if leg == "send"
                     else r.recv is not None and r.recv.role == s.role)]
        if not cands:
            findings.append(_find(
                "COM007", f"no declared round matches this {s.role} "
                f"{s.op} of `{s.kind}` (inventory failure: wrong "
                "role/direction for every spec entry of that kind)", s))
            continue
        for r in cands:
            assigned[r.name][leg].append(s)
    return assigned


def _leg_checks(r, leg, leg_spec, peers_role, sites, findings):
    need_multi = leg_spec.cardinality in ("per_peer", "per_worker")
    for s in sites:
        if s.op != "recv_any" and s.multi != need_multi:
            how = ("a single-shot site" if not s.multi
                   else "inside a peer loop")
            findings.append(_find(
                "COM003", f"{leg} of `{r.kind}` is {how} but round "
                f"`{r.name}` declares cardinality "
                f"`{leg_spec.cardinality}`", s))
        if s.peer == "coord" and peers_role != "coord":
            findings.append(_find(
                "COM003", f"{leg} of `{r.kind}` addresses the "
                f"coordinator but round `{r.name}`'s peer role is "
                f"`{peers_role}`", s))
        if r.scope in ("step", "history_step"):
            if s.step[0] != "var":
                pin = "omits the step" if s.step[0] == "none" else \
                    f"pins step={s.step[1]!r}"
                findings.append(_find(
                    "COM004", f"round `{r.name}` is per-step but this "
                    f"{leg} site {pin} (step/tag discipline)", s))
        elif s.step[0] == "var" or (s.step[0] == "const" and s.step[1] != 0):
            findings.append(_find(
                "COM004", f"session-scoped round `{r.name}` must not "
                f"carry a step expression (got {s.step[1]!r})", s))
        if s.tag[0] == "attr" and s.tag[1] in spec.TAGS \
                and r.tag != s.tag[1]:
            findings.append(_find(
                "COM004", f"tag `{s.tag[1]}` does not match round "
                f"`{r.name}`'s sub-channel ({r.tag or 'untagged'})", s))
        if leg == "send":
            phase = (s.phase[1] if s.phase[0] == "const"
                     else "setup" if s.phase[0] == "none" else None)
            if phase is not None and phase != r.phase:
                findings.append(_find(
                    "COM004", f"send counted under measured_comm phase "
                    f"{phase!r} but round `{r.name}` is budgeted under "
                    f"{r.phase!r} (comm accounting would drift)", s))
            if s.payload == "pickle" and r.payload != "pickle":
                findings.append(_find(
                    "COM008", f"pickle payload on round `{r.name}` -- "
                    f"only {sorted(spec.PICKLE_ROUNDS)} are registered "
                    "pickle control frames", s))
            elif r.payload == "array" and s.payload in ("json", "raw"):
                findings.append(_find(
                    "COM008", f"round `{r.name}` carries field arrays; "
                    "serialize via wire.share_payload / wire.pack_array, "
                    "not ad-hoc bytes", s))
        if s.op == "recv_any" and not s.timeout:
            findings.append(_find(
                "COM006", "recv_any without an explicit bounded timeout "
                "(an adaptive collect must not block forever)", s))


def _round_checks(assigned, has_net, net_info, findings):
    for r in spec.ROUNDS:
        if not r.extract:
            continue
        sends, recvs = assigned[r.name]["send"], assigned[r.name]["recv"]
        if not sends and not recvs:
            if has_net and r.scope != "error":
                path, line = net_info["anchor"](r.kind)
                findings.append(Finding(
                    "COM005", f"round `{r.name}` ({r.kind}) is declared "
                    "in the choreography spec but never instantiated in "
                    "this runtime", path, line))
            continue
        if r.recv is not None:
            if sends and not recvs:
                findings.append(_find(
                    "COM001", f"`{r.kind}` sent by {r.send.role} but no "
                    f"matching {r.recv.role} recv site (orphan send, "
                    f"round `{r.name}`)", sends[0]))
                if r.barrier:
                    findings.append(_find(
                        "COM005", f"barrier round `{r.name}` is missing "
                        f"its recv leg: the {r.recv.role} side never "
                        "consumes the frame and the choreography stalls",
                        sends[0]))
            elif recvs and not sends:
                findings.append(_find(
                    "COM002", f"`{r.kind}` awaited by {r.recv.role} but "
                    f"never sent by {r.send.role} (unfulfillable recv, "
                    f"round `{r.name}`)", recvs[0]))
                if r.barrier:
                    findings.append(_find(
                        "COM005", f"barrier round `{r.name}` is missing "
                        "its send leg: every receiver blocks forever",
                        recvs[0]))
            if r.adaptive and recvs and not any(
                    s.op == "recv_any" and s.timeout for s in recvs):
                findings.append(_find(
                    "COM006", f"adaptive round `{r.name}`'s collect has "
                    "no bounded recv_any site -- a straggler stalls the "
                    "step instead of degrading the decode subset",
                    recvs[0]))
            # matched-pair step discipline
            if sends and recvs:
                def norm(s):
                    return ("const", 0) if s.step[0] == "none" else (
                        s.step[0], s.step[1] if s.step[0] == "const"
                        else None)
                classes = {norm(s) for s in sends + recvs}
                if len(classes) > 1:
                    odd = min(sends + recvs,
                              key=lambda s: (s.step[0] == "var", s.line))
                    findings.append(_find(
                        "COM004", f"matched send/recv pair of round "
                        f"`{r.name}` disagree on the step expression "
                        f"({sorted(classes)})", odd))
        _leg_checks(r, "send", r.send,
                    r.recv.role if r.recv is not None else "coord",
                    sends, findings)
        if r.recv is not None:
            _leg_checks(r, "recv", r.recv, r.send.role, recvs, findings)


def _simulate(assigned, findings):
    """Progress simulation over the per-role event order (COM005).

    Event order: two events of one role are ordered by line number when
    they share an innermost function, by spec round order otherwise
    (all workers run the same program, so a worker recv is fulfillable
    exactly when the symmetric worker send has completed)."""
    events = []
    for r in spec.ROUNDS:
        if not r.extract or r.scope == "error":
            continue
        for leg in ("send", "recv"):
            for s in assigned[r.name][leg]:
                events.append({"role": s.role, "func": s.func,
                               "line": s.line, "order": r.order,
                               "leg": leg, "round": r.name, "site": s})

    def before(a, b):
        if a is b or a["role"] != b["role"]:
            return False
        if a["func"] == b["func"] and a["line"] != b["line"]:
            return a["line"] < b["line"]
        return a["order"] < b["order"]

    done: set = set()
    changed = True
    while changed:
        changed = False
        for i, e in enumerate(events):
            if i in done:
                continue
            if any(j not in done for j, e2 in enumerate(events)
                   if e2["leg"] == "recv" and before(e2, e)):
                continue
            if e["leg"] == "recv" and not any(
                    j in done for j, e2 in enumerate(events)
                    if e2["round"] == e["round"] and e2["leg"] == "send"):
                continue
            done.add(i)
            changed = True
    stuck = [e for i, e in enumerate(events) if i not in done]
    if stuck:
        first = min(stuck, key=lambda e: (e["site"].path, e["line"]))
        chain = sorted({f"{e['role']}:{e['round']}.{e['leg']}"
                        for e in stuck})
        findings.append(_find(
            "COM005", "choreography deadlock: progress simulation leaves "
            f"{len(stuck)} event(s) permanently blocked "
            f"({', '.join(chain[:6])}{', ...' if len(chain) > 6 else ''})",
            first["site"]))


def _net_table(mi, findings):
    """Cross-check net.py's kind table against the spec (COM007)."""
    assigns: dict = {}
    kind_names: set = set()
    for node in mi.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int) and name.isupper():
            assigns[name] = (node.value.value, node.lineno)
        if name == "KIND_NAMES" and isinstance(node.value, ast.Dict):
            kind_names |= {k.id for k in node.value.keys
                           if isinstance(k, ast.Name)}
    if not kind_names:
        kind_names = {n for n in assigns if n != "COORD"
                      and not n.startswith("TAG_")}
    for name in sorted(kind_names - set(spec.KINDS)):
        _, line = assigns.get(name, (None, 1))
        findings.append(Finding(
            "COM007", f"transport kind `{name}` has no choreography spec "
            "entry (inventory failure)", mi.path, line))
    for name in sorted(set(spec.KINDS) - kind_names):
        findings.append(Finding(
            "COM007", f"spec kind `{name}` is missing from the transport "
            "kind table", mi.path, 1))
    for name, (val, line) in sorted(assigns.items()):
        if name in spec.KINDS and val != spec.KINDS[name]:
            findings.append(Finding(
                "COM007", f"kind id drift: transport has {name}={val} "
                f"but the spec declares {spec.KINDS[name]}",
                mi.path, line))

    def anchor(kind):
        _, line = assigns.get(kind, (None, 1))
        return mi.path, line

    return {"anchor": anchor}


def _budget_check(findings):
    """COM009: choreography budget vs cost_model.proc_net_frames."""
    try:
        from ..core import cost_model
        fn = cost_model.proc_net_frames
        cm_path = cost_model.__file__
    except Exception as exc:  # noqa: BLE001 -- unavailability IS a finding
        findings.append(Finding(
            "COM009", "cost_model.proc_net_frames unavailable for the "
            f"static frame-budget cross-check: {exc!r}",
            "src/repro_torch/core/cost_model.py", 1))
        return
    for procs, iters, history in _BUDGET_SAMPLES:
        want = spec.frames_by_phase(procs, iters, history)
        try:
            got = {k: v for k, v in
                   fn(procs, iters, history).items() if v}
        except Exception as exc:  # noqa: BLE001
            findings.append(Finding(
                "COM009", f"proc_net_frames({procs}, {iters}, "
                f"history={history}) raised {exc!r}", cm_path, 1))
            continue
        if got != want:
            findings.append(Finding(
                "COM009", f"static frame budget diverges: "
                f"proc_net_frames({procs}, {iters}, history={history}) "
                f"= {got} but the choreography derives {want}",
                cm_path, 1))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _groups(index):
    """{dirpath: {basename: ModuleInfo}} for worker/session/net triples."""
    groups: dict = {}
    for mi in index.modules.values():
        base = os.path.basename(mi.path)
        if base in _GROUP_FILES:
            key = os.path.dirname(os.path.abspath(mi.path))
            groups.setdefault(key, {})[base] = mi
    return {d: g for d, g in groups.items()
            if "worker.py" in g and "session.py" in g}


def check_group(group) -> list:
    """Run every COM check on one runtime group; returns Findings."""
    findings: list = []
    sites: list = []
    for base, role in _ROLE_OF.items():
        ex = _Extractor(group[base].path, role)
        ex.visit(group[base].tree)
        findings.extend(ex.pickle_findings())
        sites.extend(ex.sites)
    assigned = _assign_sites(sites, findings)
    has_net = "net.py" in group
    net_info = {"anchor": lambda kind: (group["worker.py"].path, 1)}
    if has_net:
        net_info = _net_table(group["net.py"], findings)
    _round_checks(assigned, has_net, net_info, findings)
    _simulate(assigned, findings)
    if has_net:
        _budget_check(findings)
    return findings


def collect(index, run_paths) -> list:
    """The comm pass: check every runtime group touching `run_paths`.

    `index` is the engine's ProjectIndex (groups are discovered over ALL
    indexed modules so a --changed-only run of worker.py still sees its
    session.py counterpart); findings are only emitted for groups with
    at least one member in the analyzed set."""
    run = {os.path.abspath(p) for p in run_paths}
    findings: list = []
    for d in sorted(_groups(index)):
        group = _groups(index)[d]
        if any(os.path.abspath(mi.path) in run for mi in group.values()):
            findings.extend(check_group(group))
    return findings
