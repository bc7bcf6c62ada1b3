"""Two-pass AST analysis: global index, then per-function taint + rules.

Pass 1 indexes every module under the analysis roots: import aliases,
functions/methods with their label annotations (`Share`, `Coded`,
`Public`, `SecretRand`, `Opened` from core/labels.py), and classes with
labeled fields (`CopmlState.w_shares: Share`, ...).

Pass 2 walks each function intra-procedurally.  Taint enters through
parameter annotations, labeled dataclass fields, and registered source
calls; it moves through expressions by the effect table in registry.py;
rules fire where a secret reaches a host escape (SEC001), steers Python
control flow (SEC002), or leaves through an unregistered module
(SEC003), and where field-domain values meet raw operators (FLD001),
unreduced narrowing casts (FLD002), floats (FLD003), or foreign modulus
literals (FLD004).  Calls are resolved through annotations and the
registry rather than followed -- that keeps the analysis sound at
function boundaries without inter-procedural blowup: whatever a callee
really does, its annotated signature is the contract seclint enforces.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field as dc_field

from . import commlint
from . import scope as scope_mod
from . import waivers as waivers_mod
from .registry import (
    ANNOT_LABELS,
    ARITH_METHODS,
    CAST_METHODS,
    CODED,
    EFFECTS,
    ESCAPE_METHODS,
    FIELD,
    FLOAT_DTYPES,
    KNOWN_MODULES,
    META_ATTRS,
    META_METHODS,
    NARROW_DTYPES,
    P_VALUE,
    RAND,
    REDUCE_SITES,
    REDUCED,
    SAFE_ROOTS,
    SECRET,
    SHARE,
    SMALL_MOD_FLOOR,
    fld_exempt,
    lookup_effect,
)
from .report import Finding

_TRACE_CAP = 6
_RAW_OPS = (ast.Add, ast.Sub, ast.Mult, ast.MatMult, ast.Pow)


# --------------------------------------------------------------------------
# taint values
# --------------------------------------------------------------------------

class Taint:
    __slots__ = ("labels", "trace")

    def __init__(self, labels=frozenset(), trace=()):
        self.labels = frozenset(labels)
        self.trace = tuple(trace)[:_TRACE_CAP]

    @property
    def secret(self):
        return bool(self.labels & SECRET)

    def with_step(self, step):
        if len(self.trace) >= _TRACE_CAP:
            return self
        return Taint(self.labels, self.trace + (step,))

    def __repr__(self):  # pragma: no cover -- debugging aid
        return f"Taint({sorted(self.labels)})"


PLAIN = Taint()


def _union(taints):
    labels = frozenset().union(*(t.labels for t in taints)) if taints \
        else frozenset()
    trace = ()
    for t in taints:
        if t.trace and (not trace or (t.secret and len(t.trace) > len(trace))):
            trace = t.trace
    return Taint(labels, trace)


def _propagate(taints):
    """Union, but `reduced` survives only if every field arg was reduced."""
    out = _union(taints)
    if any(FIELD in t.labels and REDUCED not in t.labels for t in taints):
        out = Taint(out.labels - {REDUCED}, out.trace)
    return out


# --------------------------------------------------------------------------
# pass 1: index
# --------------------------------------------------------------------------

def _ann_labels(node):
    """(labels, declassify) from a label annotation, or None if unlabeled."""
    found = set()
    declassify = False
    hit = False
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name in ANNOT_LABELS:
            hit = True
            found |= ANNOT_LABELS[name]
            declassify = declassify or name == "Opened"
    return (frozenset(found), declassify) if hit else None


def _ann_type_name(node):
    """Bare dotted type name of an annotation ('CopmlState', 'm.C'), or None."""
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class FuncInfo:
    name: str
    qualname: str
    module: str
    node: object
    params: list = dc_field(default_factory=list)  # (name, labels, type_raw)
    return_labels: object = None    # frozenset | None
    return_declassify: bool = False
    return_type_raw: str = ""
    return_type: str = ""           # resolved global class key


@dataclass
class ClassInfo:
    name: str
    module: str
    key: str
    fields: dict = dc_field(default_factory=dict)   # name -> labels
    methods: dict = dc_field(default_factory=dict)  # name -> FuncInfo
    bases_raw: list = dc_field(default_factory=list)


@dataclass
class ModuleInfo:
    path: str
    modname: str
    tree: object
    source: str
    imports: dict = dc_field(default_factory=dict)   # alias -> module dotted
    symbols: dict = dc_field(default_factory=dict)   # name -> full dotted
    functions: dict = dc_field(default_factory=dict)  # name -> FuncInfo
    classes: dict = dc_field(default_factory=dict)    # name -> ClassInfo


def _func_info(node, modname, qualprefix=""):
    fi = FuncInfo(node.name, qualprefix + node.name, modname, node)
    a = node.args
    every = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    for arg in every:
        labels = _ann_labels(arg.annotation) if arg.annotation else None
        traw = _ann_type_name(arg.annotation) if arg.annotation else None
        fi.params.append((arg.arg, labels, traw))
    for va in (a.vararg, a.kwarg):
        if va is not None:
            fi.params.append((va.arg, None, None))
    if node.returns is not None:
        spec = _ann_labels(node.returns)
        if spec is not None:
            fi.return_labels, fi.return_declassify = spec
        fi.return_type_raw = _ann_type_name(node.returns) or ""
    return fi


def _index_module(path, source, modname):
    tree = ast.parse(source, filename=path)
    mi = ModuleInfo(path, modname, tree, source)
    pkg_parts = modname.split(".")[:-1]

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                mi.imports[al.asname or al.name.split(".")[0]] = (
                    al.name if al.asname else al.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = modname.split(".")
                base = ".".join(base_parts[:len(base_parts) - node.level])
                if node.module:
                    base = f"{base}.{node.module}" if base else node.module
            else:
                base = node.module or ""
            for al in node.names:
                if al.name == "*":
                    continue
                full = f"{base}.{al.name}" if base else al.name
                mi.symbols[al.asname or al.name] = full

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mi.functions[node.name] = _func_info(node, modname)
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo(node.name, modname, f"{modname}.{node.name}")
            for b in node.bases:
                traw = _ann_type_name(b)
                if traw:
                    ci.bases_raw.append(traw)
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    spec = _ann_labels(item.annotation)
                    if spec is not None:
                        ci.fields[item.target.id] = spec[0]
                elif isinstance(item, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    ci.methods[item.name] = _func_info(
                        item, modname, f"{node.name}.")
            mi.classes[node.name] = ci
    del pkg_parts
    return mi


class ProjectIndex:
    def __init__(self):
        self.modules = {}    # modname -> ModuleInfo
        self.functions = {}  # "mod.func" -> FuncInfo
        self.classes = {}    # "mod.Class" -> ClassInfo

    def add(self, mi):
        self.modules[mi.modname] = mi
        for name, fi in mi.functions.items():
            self.functions[f"{mi.modname}.{name}"] = fi
        for name, ci in mi.classes.items():
            self.classes[ci.key] = ci

    def resolve_class(self, mi, raw):
        """Resolve a raw type name in module `mi` to a global class key."""
        if not raw:
            return ""
        head, _, rest = raw.partition(".")
        if not rest and head in mi.classes:
            return mi.classes[head].key
        if head in mi.symbols:
            cand = mi.symbols[head] + (("." + rest) if rest else "")
            return cand if cand in self.classes else ""
        if head in mi.imports and rest:
            cand = f"{mi.imports[head]}.{rest}"
            return cand if cand in self.classes else ""
        cand = f"{mi.modname}.{raw}"
        return cand if cand in self.classes else ""

    def finalize(self):
        # inheritance: pull unshadowed fields/methods down from bases
        for _ in range(3):  # shallow hierarchies; a few rounds suffice
            for ci in self.classes.values():
                mi = self.modules.get(ci.module)
                if mi is None:
                    continue
                for raw in ci.bases_raw:
                    key = self.resolve_class(mi, raw)
                    base = self.classes.get(key)
                    if base is None:
                        continue
                    for fname, labels in base.fields.items():
                        ci.fields.setdefault(fname, labels)
                    for mname, fi in base.methods.items():
                        ci.methods.setdefault(mname, fi)
        # resolve return/param type names to class keys
        all_funcs = list(self.functions.values())
        for ci in self.classes.values():
            all_funcs.extend(ci.methods.values())
        for fi in all_funcs:
            mi = self.modules.get(fi.module)
            if mi is None:
                continue
            fi.return_type = self.resolve_class(mi, fi.return_type_raw)


# --------------------------------------------------------------------------
# pass 2: per-function taint + rules
# --------------------------------------------------------------------------

class FunctionAnalyzer:
    def __init__(self, index, mi, findings, *, enclosing_class=None):
        self.index = index
        self.mi = mi
        self.findings = findings
        self.enclosing_class = enclosing_class  # ClassInfo | None
        self.env = {}    # name -> Taint ("self.attr" keys for self stores)
        self.types = {}  # name -> global class key
        self.exempt = fld_exempt(mi.path)
        self._sanctioned = set()  # ids of BinOps under a `% P` reduction

    # -- helpers ----------------------------------------------------------

    def _loc(self, node):
        return f"{self.mi.path}:{node.lineno}"

    def emit(self, rule, message, node, trace=()):
        self.findings.append(Finding(
            rule, message, self.mi.path, node.lineno,
            getattr(node, "col_offset", 0), tuple(trace)))

    def resolve_dotted(self, node):
        parts = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(cur.id)
        parts.reverse()
        root, rest = parts[0], parts[1:]
        if root in self.env and root not in self.mi.imports:
            return None  # a local value shadows any same-named import
        if root in self.mi.imports:
            return ".".join([self.mi.imports[root]] + rest)
        if root in self.mi.symbols:
            return ".".join([self.mi.symbols[root]] + rest)
        if root in ("repro_torch", "torch", "numpy") or root in KNOWN_MODULES:
            return ".".join(parts)
        return None

    def _is_field_p(self, node):
        if isinstance(node, ast.Constant):
            return node.value == P_VALUE
        dotted = self.resolve_dotted(node)
        if dotted and (dotted == "repro_torch.core.field.P"
                       or dotted.endswith("field.P")):
            return True
        return False

    def _seed_params(self, fi):
        for name, labels, traw in fi.params:
            if labels is not None:
                lab, _declass = labels
                self.env[name] = Taint(
                    lab, (f"param `{name}` of {fi.qualname} "
                          f"({self.mi.path})",))
            else:
                self.env[name] = PLAIN
                key = self.index.resolve_class(self.mi, traw or "")
                if key:
                    self.types[name] = key
        if self.enclosing_class is not None and fi.params:
            first = fi.params[0][0]
            if first in ("self", "cls"):
                self.types[first] = self.enclosing_class.key

    # -- driver -----------------------------------------------------------

    def run_function(self, fi):
        self._seed_params(fi)
        self.walk_block(fi.node.body)

    def run_module_level(self, body):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            self.stmt(stmt)

    # -- statements -------------------------------------------------------

    def walk_block(self, stmts):
        for s in stmts:
            self.stmt(s)

    def stmt(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = _func_info(node, self.mi.modname)
            child = FunctionAnalyzer(self.index, self.mi, self.findings,
                                     enclosing_class=self.enclosing_class)
            child.env = dict(self.env)
            child.types = dict(self.types)
            child._seed_params(fi)
            child.walk_block(node.body)
            self.env[node.name] = PLAIN
        elif isinstance(node, ast.ClassDef):
            pass  # nested classes: not part of the protocol surface
        elif isinstance(node, ast.Assign):
            t = self.eval(node.value)
            ty = self.type_of(node.value)
            for tgt in node.targets:
                self.bind(tgt, t, ty, node)
        elif isinstance(node, ast.AnnAssign):
            spec = _ann_labels(node.annotation)
            if node.value is not None:
                t = self.eval(node.value)
                ty = self.type_of(node.value)
            else:
                t, ty = PLAIN, ""
            if spec is not None:
                lab, _declass = spec
                t = Taint(lab, (f"annotated at {self._loc(node)}",))
                ty = ""
            elif node.value is None:
                return
            else:
                key = self.index.resolve_class(
                    self.mi, _ann_type_name(node.annotation) or "")
                ty = key or ty
            self.bind(node.target, t, ty, node)
        elif isinstance(node, ast.AugAssign):
            cur = self.eval(node.target) if not isinstance(
                node.target, ast.Name) else self.env.get(
                node.target.id, PLAIN)
            val = self.eval(node.value)
            res = self._binop_effect(node, node.op, cur, val,
                                     node.value)
            self.bind(node.target, res, "", node)
        elif isinstance(node, ast.If):
            t = self.eval(node.test)
            if t.secret:
                self.emit("SEC002",
                          "Python `if` on a secret-tainted condition",
                          node, t.trace)
            self._branch(node.body, node.orelse)
        elif isinstance(node, ast.While):
            t = self.eval(node.test)
            if t.secret:
                self.emit("SEC002",
                          "Python `while` on a secret-tainted condition",
                          node, t.trace)
            self._loop_body(node.body, node.orelse)
            t2 = self.eval(node.test)
            if t2.secret and not t.secret:
                self.emit("SEC002",
                          "Python `while` on a secret-tainted condition",
                          node, t2.trace)
        elif isinstance(node, ast.For):
            it = self.eval(node.iter)
            self.bind(node.target, it, "", node)
            self._loop_body(node.body, node.orelse)
        elif isinstance(node, ast.Try):
            self.walk_block(node.body)
            for h in node.handlers:
                if h.name:
                    self.env[h.name] = PLAIN
                self.walk_block(h.body)
            self.walk_block(node.orelse)
            self.walk_block(node.finalbody)
        elif isinstance(node, ast.With):
            for item in node.items:
                t = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, t, "", node)
            self.walk_block(node.body)
        elif isinstance(node, (ast.Return, ast.Expr)):
            if node.value is not None:
                self.eval(node.value)
        elif isinstance(node, ast.Assert):
            self.eval(node.test)
            if node.msg is not None:
                self.eval(node.msg)
        elif isinstance(node, ast.Raise):
            if node.exc is not None:
                self.eval(node.exc)
            if node.cause is not None:
                self.eval(node.cause)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.env.pop(tgt.id, None)
        # Pass / Import / Global / Nonlocal / Break / Continue: nothing

    def _branch(self, body, orelse):
        save_env, save_ty = dict(self.env), dict(self.types)
        self.walk_block(body)
        after_env, after_ty = self.env, self.types
        self.env, self.types = dict(save_env), dict(save_ty)
        self.walk_block(orelse)
        self._merge(after_env, after_ty)

    def _loop_body(self, body, orelse):
        save_env, save_ty = dict(self.env), dict(self.types)
        self.walk_block(body)
        self.walk_block(body)  # second pass: loop-carried taint
        self.walk_block(orelse)
        self._merge(save_env, save_ty)

    def _merge(self, other_env, other_ty):
        for name, t in other_env.items():
            mine = self.env.get(name)
            self.env[name] = _union([mine, t]) if mine is not None else t
        for name, ty in other_ty.items():
            if self.types.get(name, ty) != ty:
                del self.types[name]
            else:
                self.types.setdefault(name, ty)

    def bind(self, target, taint, ty, node):
        if isinstance(target, ast.Name):
            if taint.secret or FIELD in taint.labels:
                taint = taint.with_step(
                    f"assigned to `{target.id}` at {self._loc(node)}")
            self.env[target.id] = taint
            if ty:
                self.types[target.id] = ty
            else:
                self.types.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                el_t = taint
                if isinstance(el, ast.Starred):
                    el = el.value
                self.bind(el, el_t, "", node)
        elif isinstance(target, ast.Attribute):
            base = target.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                self.env[f"{base.id}.{target.attr}"] = taint
            else:
                self._store_into_base(base, taint)
        elif isinstance(target, ast.Subscript):
            self.eval(target.slice)
            self._store_into_base(target.value, taint)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, taint, "", node)

    def _store_into_base(self, base, taint):
        """x[i] = v / x.attr = v: union the value's labels into x."""
        cur = base
        while isinstance(cur, (ast.Subscript, ast.Attribute)):
            cur = cur.value
        if isinstance(cur, ast.Name):
            old = self.env.get(cur.id, PLAIN)
            labels = old.labels | taint.labels
            # a store of an unreduced field value poisons canonicity
            if FIELD in taint.labels and REDUCED not in taint.labels:
                labels -= {REDUCED}
            self.env[cur.id] = Taint(labels, taint.trace or old.trace)

    # -- types ------------------------------------------------------------

    def type_of(self, node):
        if isinstance(node, ast.Name):
            return self.types.get(node.id, "")
        if isinstance(node, ast.Call):
            eff = self._call_effect_only(node)
            return eff or ""
        return ""

    def _call_effect_only(self, node):
        """Return type (class key) a call produces, without re-analysis."""
        f = node.func
        dotted = self.resolve_dotted(f)
        if dotted:
            if dotted in self.index.classes:
                return dotted
            fi = self.index.functions.get(dotted)
            if fi is not None:
                return fi.return_type
            eff = lookup_effect(dotted)
            if eff and eff["kind"] == "replace" and node.args:
                return self.type_of(node.args[0])
            return ""
        if isinstance(f, ast.Name):
            if f.id in self.mi.classes:
                return self.mi.classes[f.id].key
            fi = self.mi.functions.get(f.id)
            if fi is not None:
                return fi.return_type
            return ""
        if isinstance(f, ast.Attribute):
            fi = self._method_info(f)
            if fi is not None:
                return fi.return_type
        return ""

    def _method_info(self, attr_node):
        """FuncInfo for `obj.method` when obj's class is known."""
        base = attr_node.value
        key = ""
        if isinstance(base, ast.Name):
            key = self.types.get(base.id, "")
        elif isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name) and base.value.id in ("self", "cls"):
            key = ""  # self.attr types are not tracked
        ci = self.index.classes.get(key)
        if ci is not None:
            return ci.methods.get(attr_node.attr)
        return None

    # -- expressions ------------------------------------------------------

    def eval(self, node):
        if node is None:
            return PLAIN
        if isinstance(node, ast.Constant):
            return PLAIN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, PLAIN)
        if isinstance(node, ast.Attribute):
            return self._attribute(node)
        if isinstance(node, ast.Subscript):
            self.eval(node.slice)
            return self.eval(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Mod) and self._is_field_p(node.right):
                # sanction the left subtree BEFORE descending into it, so
                # `(a * b) % field.P` never flags the inner product
                for sub in ast.walk(node.left):
                    if isinstance(sub, ast.BinOp):
                        self._sanctioned.add(id(sub))
            lt = self.eval(node.left)
            rt = self.eval(node.right)
            return self._binop_effect(node, node.op, lt, rt, node.right,
                                      left_node=node.left)
        if isinstance(node, ast.BoolOp):
            return _union([self.eval(v) for v in node.values])
        if isinstance(node, ast.Compare):
            return _union([self.eval(node.left)]
                          + [self.eval(c) for c in node.comparators])
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.IfExp):
            return _union([self.eval(node.test), self.eval(node.body),
                           self.eval(node.orelse)])
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _union([self.eval(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            vals = [self.eval(k) for k in node.keys if k is not None]
            vals += [self.eval(v) for v in node.values]
            return _union(vals)
        if isinstance(node, ast.JoinedStr):
            return _union([self.eval(v.value) for v in node.values
                           if isinstance(v, ast.FormattedValue)])
        if isinstance(node, ast.FormattedValue):
            return self.eval(node.value)
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.Lambda):
            child = FunctionAnalyzer(self.index, self.mi, self.findings,
                                     enclosing_class=self.enclosing_class)
            child.env = dict(self.env)
            child.types = dict(self.types)
            for arg in (list(node.args.posonlyargs) + list(node.args.args)
                        + list(node.args.kwonlyargs)):
                child.env[arg.arg] = PLAIN
            child.eval(node.body)
            return PLAIN
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                it = self.eval(gen.iter)
                self.bind(gen.target, it, "", node)
                for cond in gen.ifs:
                    self.eval(cond)
            if isinstance(node, ast.DictComp):
                return _union([self.eval(node.key), self.eval(node.value)])
            return self.eval(node.elt)
        if isinstance(node, ast.NamedExpr):
            t = self.eval(node.value)
            self.bind(node.target, t, self.type_of(node.value), node)
            return t
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            return self.eval(node.value) if node.value else PLAIN
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.eval(part)
            return PLAIN
        return PLAIN

    def _attribute(self, node):
        # module-path attributes (field.P, torch.int32) are values, no taint
        if self.resolve_dotted(node) is not None:
            return PLAIN
        base = node.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            stored = self.env.get(f"{base.id}.{node.attr}")
            if stored is not None:
                return stored
            if self.enclosing_class is not None:
                labels = self.enclosing_class.fields.get(node.attr)
                if labels is not None:
                    return Taint(labels, (
                        f"{self.enclosing_class.name}.{node.attr} "
                        f"labeled field",))
            return PLAIN
        base_t = self.eval(base)
        ty = self.type_of(base)
        ci = self.index.classes.get(ty)
        if ci is not None:
            labels = ci.fields.get(node.attr)
            if labels is not None:
                return Taint(labels, (f"{ci.name}.{node.attr} labeled field "
                                      f"(read at {self._loc(node)})",))
            return PLAIN
        if node.attr in META_ATTRS:
            return PLAIN
        return base_t

    # -- operators --------------------------------------------------------

    def _binop_effect(self, node, op, lt, rt, right_node, left_node=None):
        loc_labels = lt.labels | rt.labels
        trace = _union([lt, rt]).trace
        if isinstance(op, ast.Mod):
            if self._is_field_p(right_node):
                # the lazy-reduction idiom: `(expr) % field.P` sanctions the
                # whole left subtree (magnitude is on the author)
                if left_node is not None:
                    for sub in ast.walk(left_node):
                        if isinstance(sub, ast.BinOp):
                            self._sanctioned.add(id(sub))
                return Taint(loc_labels | {FIELD, REDUCED}, trace)
            if isinstance(right_node, ast.Constant) and isinstance(
                    right_node.value, int) \
                    and right_node.value >= SMALL_MOD_FLOOR \
                    and right_node.value != P_VALUE:
                self.emit("FLD004",
                          f"modulus literal {right_node.value} is not "
                          "field.P", node, trace)
        if isinstance(op, ast.Div) and FIELD in loc_labels \
                and not self.exempt:
            self.emit("FLD003",
                      "true division produces floats from a field-domain "
                      "value", node, trace)
        if isinstance(op, _RAW_OPS + (ast.Mod,)) and FIELD in loc_labels \
                and not self.exempt and id(node) not in self._sanctioned:
            opname = type(op).__name__
            self.emit("FLD001",
                      f"raw `{opname}` on a field-domain value outside "
                      "core/field.py / kernels wrappers "
                      "(use field.add/mul/matmul or reduce with % field.P)",
                      node, trace)
        if FIELD in loc_labels and not self.exempt:
            for side in (left_node, right_node):
                if isinstance(side, ast.Constant) and isinstance(
                        side.value, float):
                    self.emit("FLD003",
                              "float literal combined with a field-domain "
                              "value", node, trace)
                    break
        return Taint(loc_labels - {REDUCED}, trace)

    # -- calls ------------------------------------------------------------

    def _dtype_name(self, node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id
        return ""

    def _call(self, node):
        f = node.func
        dotted = self.resolve_dotted(f)
        if dotted in REDUCE_SITES:
            # barrett_reduce/fold26 ARE the reduction: sanction raw
            # arithmetic in the argument subtree, same as `% field.P`
            for a in list(node.args) + [k.value for k in node.keywords]:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.BinOp):
                        self._sanctioned.add(id(sub))
        arg_taints = [self.eval(a) for a in node.args]
        arg_taints += [self.eval(k.value) for k in node.keywords]
        if dotted is not None:
            return self._apply_dotted(dotted, arg_taints, node)

        if isinstance(f, ast.Name):
            name = f.id
            if name in self.mi.classes:
                return _propagate(arg_taints)  # instance carries no labels
            fi = self.mi.functions.get(name)
            if fi is not None:
                return self._apply_funcinfo(fi, arg_taints, node, name)
            if name in ("print", "int", "float", "bool", "bytes"):
                return self._apply_registry(
                    {"kind": "escape"}, f"builtins.{name}",
                    arg_taints, node)
            if name in ("len", "id", "hash", "isinstance", "hasattr",
                        "getattr", "type", "repr", "str"):
                return PLAIN if name in ("len", "id", "isinstance",
                                         "hasattr", "type") \
                    else _union(arg_taints)
            return _propagate(arg_taints)  # local callable / builtin misc

        if isinstance(f, ast.Attribute):
            return self._method_call(f, arg_taints, node)

        self.eval(f)
        return _propagate(arg_taints)

    def _apply_dotted(self, dotted, arg_taints, node):
        if dotted in EFFECTS:
            # an exact registry entry is the contract, also where the
            # callee is indexed (wire.share_payload's declassify)
            return self._apply_registry(EFFECTS[dotted], dotted, arg_taints,
                                        node)
        fi = self.index.functions.get(dotted)
        if fi is not None:
            return self._apply_funcinfo(fi, arg_taints, node, dotted)
        if dotted in self.index.classes:
            return _propagate(arg_taints)
        eff = lookup_effect(dotted)
        if eff is not None:
            return self._apply_registry(eff, dotted, arg_taints, node)
        root = dotted.split(".", 1)[0]
        u = _union(arg_taints)
        if root not in SAFE_ROOTS and u.secret:
            self.emit("SEC003",
                      f"secret-tainted value passed to unregistered "
                      f"external callable `{dotted}` (no sanctioned sink "
                      "registered for this module)", node, u.trace)
            return PLAIN
        return _propagate(arg_taints)

    def _apply_funcinfo(self, fi, arg_taints, node, display):
        if fi.return_declassify:
            return Taint((), (f"declassified by `{display}` "
                              f"at {self._loc(node)}",))
        if fi.return_labels is not None:
            labels = fi.return_labels
            step = (f"`{display}() -> "
                    f"{'|'.join(sorted(labels)) or 'opened'}` "
                    f"at {self._loc(node)}")
            carried = _union(arg_taints)
            return Taint(labels | (carried.labels & SECRET),
                         carried.trace[-_TRACE_CAP + 1:] + (step,))
        return _propagate(arg_taints)

    def _apply_registry(self, eff, dotted, arg_taints, node):
        kind = eff["kind"]
        u = _union(arg_taints)
        loc = self._loc(node)
        if kind == "source":
            labels = eff["labels"] | (u.labels & SECRET)
            return Taint(labels, u.trace + (f"secret source `{dotted}` "
                                            f"at {loc}",))
        if kind == "open":
            return Taint((u.labels - {SHARE, RAND}) | {FIELD, REDUCED},
                         u.trace + (f"opened via `{dotted}` at {loc}",))
        if kind == "decode":
            return Taint((u.labels - {CODED}) | {FIELD, REDUCED},
                         u.trace + (f"decoded via `{dotted}` at {loc}",))
        if kind == "declassify":
            return Taint((), (f"declassified via `{dotted}` at {loc}",))
        if kind == "fieldop":
            return Taint(frozenset({FIELD, REDUCED}) | (u.labels & SECRET),
                         u.trace)
        if kind == "dequant":
            return Taint(u.labels - {FIELD, REDUCED}, u.trace)
        if kind == "public":
            return Taint({FIELD, REDUCED}, ())
        if kind == "plain":
            return PLAIN
        if kind == "escape":
            if u.secret:
                self.emit("SEC001",
                          f"secret-tainted value reaches host escape "
                          f"`{dotted}`", node, u.trace)
            return PLAIN
        if kind == "replace":
            return _propagate(arg_taints)
        return _propagate(arg_taints)

    def _check_cast(self, obj_t, dt, node, what):
        """FLD002 / FLD003 for a cast of a field value to dtype `dt`."""
        if self.exempt or FIELD not in obj_t.labels:
            return
        if dt in NARROW_DTYPES and REDUCED not in obj_t.labels:
            self.emit("FLD002",
                      f"narrowing cast `{what}` on a field value not "
                      "dominated by `% field.P`", node, obj_t.trace)
        if dt in FLOAT_DTYPES:
            self.emit("FLD003",
                      f"float cast `{what}` on a field-domain value",
                      node, obj_t.trace)

    def _method_call(self, f, arg_taints, node):
        fi = self._method_info(f)
        obj_t = self.eval(f.value)
        if fi is not None:
            return self._apply_funcinfo(fi, [obj_t] + arg_taints, node,
                                        fi.qualname)
        attr = f.attr
        if attr in ESCAPE_METHODS:
            if obj_t.secret:
                self.emit("SEC001",
                          f"secret-tainted value reaches host escape "
                          f"`.{attr}()`", node, obj_t.trace)
            return PLAIN
        if attr in ("astype", "to", "type") or (
                attr in CAST_METHODS and not node.args):
            dt = CAST_METHODS.get(attr, "")
            if node.args:
                dt = self._dtype_name(node.args[0])
            for k in node.keywords:
                if k.arg == "dtype":
                    dt = self._dtype_name(k.value)
            self._check_cast(obj_t, dt, node, f".{attr}({dt})")
            return obj_t
        if attr in META_METHODS:
            return PLAIN
        if attr in ARITH_METHODS:
            out = _union([obj_t] + arg_taints)
            return Taint(out.labels - {REDUCED}, out.trace)
        return _propagate([obj_t] + arg_taints)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

@dataclass
class AnalysisResult:
    findings: list
    waiver_maps: dict
    files: list
    unused_waivers: list

    @property
    def active(self):
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self):
        return [f for f in self.findings if f.waived]


def _iter_py_files(path):
    if os.path.isfile(path):
        yield path, True  # explicit file: bypass scope filtering
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn), False


def _modname_for(path, package=""):
    stem = os.path.splitext(os.path.basename(path))[0]
    if package:
        return f"{package}.{stem}" if stem != "__init__" else package
    parts = [stem] if stem != "__init__" else []
    d = os.path.dirname(os.path.abspath(path))
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(parts) if parts else stem


def _analyze_module_sec(index, mi):
    """The per-file seclint pass; returns this module's findings.

    Self-contained (depends only on the module + the finalized index) so
    results can be memoized by a FindingsCache keyed on file stats."""
    findings: list[Finding] = []
    top = FunctionAnalyzer(index, mi, findings)
    top.run_module_level(mi.tree.body)
    for fi in mi.functions.values():
        fa = FunctionAnalyzer(index, mi, findings)
        fa.run_function(fi)
    for ci in mi.classes.values():
        for fi in ci.methods.values():
            if fi.module != mi.modname:  # inherited: analyzed at origin
                continue
            fa = FunctionAnalyzer(index, mi, findings,
                                  enclosing_class=ci)
            fa.run_function(fi)
    return findings


def analyze_paths(paths, *, package="", strict=False, apply_scope=True,
                  passes=("sec", "comm"), only_files=None, cache=None):
    """Analyze files/trees; returns an AnalysisResult.

    `package` forces the dotted package context of explicitly-listed
    files (so relative imports in tmp copies of protocol modules resolve
    against the registry).  Directory walks honour the scope config
    unless `apply_scope` is False; explicitly-listed files are always
    analyzed.

    `passes` selects the rule families: "sec" (seclint taint + field
    rules) and/or "comm" (commlint choreography rules).  `only_files`
    (absolute paths) restricts which files are *analyzed* -- everything
    is still indexed, so cross-module resolution and commlint's
    worker/session group discovery see the whole tree (this backs
    --changed-only).  `cache` is an optional FindingsCache memoizing the
    per-file sec pass across runs.
    """
    index = ProjectIndex()
    findings: list[Finding] = []
    selected = []  # (ModuleInfo, analyze?)
    for root in paths:
        for path, explicit in _iter_py_files(root):
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
                mi = _index_module(path, source,
                                   _modname_for(path,
                                                package if explicit else ""))
            except (SyntaxError, UnicodeDecodeError) as exc:
                findings.append(Finding(
                    "WVR001", f"unparseable file: {exc}", path,
                    getattr(exc, "lineno", 1) or 1))
                continue
            index.add(mi)
            run = explicit or not apply_scope or scope_mod.in_scope(path)
            if run and only_files is not None:
                run = os.path.abspath(path) in only_files
            selected.append((mi, run))
    index.finalize()

    waiver_maps = {}
    for mi, run in selected:
        if not run:
            continue
        wmap, problems = waivers_mod.scan_file(mi.path, mi.source)
        waiver_maps[mi.path] = wmap
        findings.extend(problems)
        if "sec" not in passes:
            continue
        cached = cache.get(mi, index) if cache is not None else None
        if cached is not None:
            findings.extend(cached)
            continue
        file_findings = _analyze_module_sec(index, mi)
        if cache is not None:
            cache.put(mi, index, file_findings)
        findings.extend(file_findings)

    if "comm" in passes:
        findings.extend(commlint.collect(
            index, [mi.path for mi, run in selected if run]))

    # dedup (loop fixpoints walk bodies twice) and stable order
    seen = set()
    unique = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    unique.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    waivers_mod.apply(unique, waiver_maps)
    unused = waivers_mod.unused_findings(waiver_maps)
    if strict:
        unique.extend(unused)
    return AnalysisResult(unique, waiver_maps, [m.path for m, r in selected
                                               if r], unused)
