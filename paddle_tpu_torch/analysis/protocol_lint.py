"""Protocol conformance lint — P-rules over the port's distributed planes;
the counterpart of ``paddle_tpu/analysis/protocol_lint.py`` (same rule ids,
same findings on the same sources), run over ``paddle_tpu_torch``.

The master RPC plane (master.py), its HA/journal durability planes
(master_ha.py / master_journal.py), the typed wire codec (master_wire.py)
and the serving fleet (serving/router.py / serving/scheduler.py) form one
distributed protocol, but each invariant used to be asserted by exactly
one hand-written drill along one interleaving.  These passes cross-check
the protocol SURFACES against each other statically, so a change that
drifts one surface (a new RPC method, journal record type, request
status, fencing comparison, or timeout path) fires the lint everywhere
the other surfaces depend on it:

  P501  RPC surface conformance: every method in a ``_METHODS``-style
        whitelist has a handler on its service class; no
        codec-unrepresentable value is constructed on a reply path; the
        client/server plumbing is wired to the DECLARED whitelist.
  P502  Journal record conformance: every ``_journal({"t": ...})``
        literal is a registered record type with an ``_apply_*`` replay
        op; every registered type is emitted somewhere; payload-carrying
        types are re-emitted by compaction (the snapshot stays pure
        JSON); no orphan replay op.
  P503  Status-ledger exhaustiveness: every status literal assigned or
        compared anywhere in the serving planes is a member of the ONE
        declared disjoint set (``scheduler.TERMINAL_STATUSES``); every
        declared status is actually assigned; any parallel status-set
        literal must equal the declared set exactly.
  P504  Lease/fence monotonicity: epoch fences compare by EQUALITY
        (ordering accepts stale holders), journal sequences compare by
        ORDERING (equality breaks replay dedupe), and lease deadlines
        are written only with the registry lock held (a small entry-held
        inference over self-calls — the static leg the concurrency
        plane runs package-wide, specialized to the lease fields).
  P505  Timeout completeness: every RPC client ``_call`` has a deadline
        identifier and a raise path; no unbounded ``Connection.poll()``;
        no RPC client constructed with ``call_timeout_s=None``.

``# proto: allow[P504] <why>`` pragmas escape intentional findings (the
shared analysis/pragmas.py grammar); P500 is the bookkeeping rule for
malformed pragmas and missing/unparseable protocol surfaces.

Mutation tests inject a violation by rewriting ONE source in the map
passed to :func:`lint_protocol_sources`; ``python -m paddle_tpu_torch
lint --protocol`` (:func:`lint_protocol_package`) lints the port's tree
and must report zero findings.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis import pragmas as _pragmas
from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = [
    "PROTOCOL_FILES",
    "lint_protocol_package",
    "lint_protocol_sources",
]

# the protocol surfaces, relative to the package root
PROTOCOL_FILES = (
    "master.py",
    "master_ha.py",
    "master_journal.py",
    "master_wire.py",
    "serving/router.py",
    "serving/scheduler.py",
)

# (file with the whitelist literal, whitelist name, handler class)
_RPC_SURFACES = (
    ("master.py", "_METHODS", "Service"),
    ("serving/router.py", "ROUTER_METHODS", "Router"),
    ("serving/router.py", "ENGINE_METHODS", "EngineAgent"),
)

# constructors whose result the typed wire codec cannot represent
# (master_wire encodes None/bool/int/float/str/bytes/list/tuple/dict/
# ndarray only) — conservative: only PROVABLE constructions are flagged
_UNWIRE_CALLS = frozenset({
    "set", "frozenset", "complex", "bytearray", "memoryview", "iter",
    "map", "filter", "zip", "range", "enumerate", "reversed", "slice",
    "object", "open",
})

# the one transient (non-terminal) request status
_TRANSIENT_STATUSES = frozenset({"pending"})


def _err(rule: str, message: str, source: str, line: Optional[int],
         hint: str) -> Diagnostic:
    return Diagnostic(rule=rule, severity=Severity.ERROR, message=message,
                      source=source, line=line, hint=hint)


def _name_of(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain (``a.b.c``), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_elts(node: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """``[(value, line)]`` for a tuple/list/set/frozenset-of-str literal."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "frozenset" and node.args):
        node = node.args[0]
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    out = []
    for e in node.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.append((e.value, e.lineno))
    return out


def _module_assign(tree: ast.Module, name: str) -> Optional[ast.AST]:
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return stmt.value
    return None


def _find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef) and stmt.name == name:
            return stmt
    return None


def _class_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {s.name: s for s in cls.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _own_returns(fn: ast.FunctionDef) -> List[ast.Return]:
    """Return statements of ``fn`` itself (nested defs excluded)."""
    out: List[ast.Return] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _unwireable(expr: ast.AST) -> List[Tuple[ast.AST, str]]:
    """Provably codec-unrepresentable constructions inside ``expr``."""
    bad: List[Tuple[ast.AST, str]] = []
    for node in ast.walk(expr):
        if isinstance(node, (ast.Set, ast.SetComp)):
            bad.append((node, "set literal"))
        elif isinstance(node, ast.GeneratorExp):
            bad.append((node, "generator expression"))
        elif isinstance(node, ast.Lambda):
            bad.append((node, "lambda"))
        elif isinstance(node, ast.Constant) and (
                node.value is Ellipsis or isinstance(node.value, complex)):
            bad.append((node, f"constant {node.value!r}"))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _UNWIRE_CALLS):
            bad.append((node, f"{node.func.id}(...) call"))
    return bad


# ---------------------------------------------------------------------------
# P501 — RPC surface conformance
# ---------------------------------------------------------------------------

def _p501(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for rel, wl_name, cls_name in _RPC_SURFACES:
        tree = trees.get(rel)
        if tree is None:
            continue
        wl_node = _module_assign(tree, wl_name)
        methods = _str_elts(wl_node) if wl_node is not None else None
        if methods is None:
            diags.append(_err(
                "P500",
                f"RPC whitelist {wl_name} is not a module-level literal "
                f"tuple of method-name strings",
                rel, getattr(wl_node, "lineno", None),
                f"declare {wl_name} = (\"method\", ...) at module scope — "
                "the conformance plane cross-checks it statically",
            ))
            continue
        cls = _find_class(tree, cls_name)
        if cls is None:
            diags.append(_err(
                "P500", f"handler class {cls_name} not found", rel, None,
                f"{wl_name} names {cls_name} as its handler surface",
            ))
            continue
        handlers = _class_methods(cls)
        for meth, line in methods:
            fn = handlers.get(meth)
            if fn is None:
                diags.append(_err(
                    "P501",
                    f"RPC method {meth!r} in {wl_name} has no handler on "
                    f"{cls_name} — a client call would dispatch into "
                    f"AttributeError",
                    rel, line,
                    f"define {cls_name}.{meth}(...) or drop {meth!r} from "
                    f"{wl_name}",
                ))
                continue
            for ret in _own_returns(fn):
                if ret.value is None:
                    continue
                for node, what in _unwireable(ret.value):
                    diags.append(_err(
                        "P501",
                        f"reply path of RPC handler {cls_name}.{meth} "
                        f"constructs a codec-unrepresentable value "
                        f"({what}) — the typed wire codec would raise "
                        f"WireTypeError at reply time",
                        rel, getattr(node, "lineno", ret.lineno),
                        "reply with the wire universe only (None/bool/int/"
                        "float/str/bytes/list/tuple/dict/ndarray); e.g. "
                        "sorted(...) instead of a set",
                    ))
    # client/server plumbing must be wired to the DECLARED whitelists
    for rel, cls_name, wl_name in (
        ("master.py", "Client", "_METHODS"),
        ("master_ha.py", "HAClient", "_METHODS"),
    ):
        tree = trees.get(rel)
        if tree is None:
            continue
        cls = _find_class(tree, cls_name)
        if cls is None:
            diags.append(_err("P500", f"class {cls_name} not found", rel,
                              None, "the RPC client surface moved?"))
            continue
        if not any(isinstance(n, ast.Name) and n.id == wl_name
                   for n in ast.walk(cls)):
            diags.append(_err(
                "P501",
                f"{cls_name} does not delegate from {wl_name} — its "
                f"surface can silently drift from the server whitelist",
                rel, cls.lineno,
                f"route __getattr__ delegation through {wl_name} (one "
                "definition for the whole surface)",
            ))
    router = trees.get("serving/router.py")
    if router is not None:
        wired: Set[str] = set()
        for node in ast.walk(router):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "methods" and isinstance(kw.value, ast.Name):
                        wired.add(kw.value.id)
        for wl_name in ("ROUTER_METHODS", "ENGINE_METHODS"):
            if wl_name not in wired:
                diags.append(_err(
                    "P501",
                    f"no Server/Client is constructed with "
                    f"methods={wl_name} — the declared whitelist is not "
                    f"what the wire actually enforces",
                    "serving/router.py", None,
                    f"pass methods={wl_name} (the NAME, not a copied "
                    "literal) to the Server/Client constructor",
                ))
    return diags


# ---------------------------------------------------------------------------
# P502 — journal record conformance
# ---------------------------------------------------------------------------

def _journal_dicts(tree: ast.Module) -> List[Tuple[ast.Call, ast.AST]]:
    """Every ``*._journal(<arg>)`` call in ``tree`` with its first arg."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "_journal" and node.args):
            out.append((node, node.args[0]))
    return out


def _dict_t(d: ast.AST) -> Optional[Tuple[str, bool]]:
    """(record type, carries-"result"-key) of a literal journal dict."""
    if not isinstance(d, ast.Dict):
        return None
    t_val, has_result = None, False
    for k, v in zip(d.keys, d.values):
        key = getattr(k, "value", None)
        if key == "t":
            if not (isinstance(v, ast.Constant) and isinstance(v.value, str)):
                return None
            t_val = v.value
        elif key == "result":
            has_result = True
    return (t_val, has_result) if t_val is not None else None


def _p502(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    mj = trees.get("master_journal.py")
    m = trees.get("master.py")
    if mj is None or m is None:
        return diags
    rt_node = _module_assign(mj, "RECORD_TYPES")
    rt = _str_elts(rt_node) if rt_node is not None else None
    if rt is None:
        diags.append(_err(
            "P500", "RECORD_TYPES is not a module-level frozenset literal "
            "of record-type strings", "master_journal.py",
            getattr(rt_node, "lineno", None),
            "declare RECORD_TYPES = frozenset({\"lease\", ...}) — every "
            "journal surface keys on it",
        ))
        return diags
    record_types = {v for v, _ in rt}
    rt_line = rt[0][1] if rt else None
    svc = _find_class(m, "Service")
    if svc is None:
        diags.append(_err("P500", "class Service not found", "master.py",
                          None, "the journal emission surface moved?"))
        return diags
    handlers = _class_methods(svc)
    apply_ops = {name[len("_apply_"):]: fn.lineno
                 for name, fn in handlers.items()
                 if name.startswith("_apply_")}
    compact = handlers.get("_compact")
    compact_emits: Set[str] = set()
    if compact is not None:
        for node in ast.walk(compact):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "append" and node.args
                    and len(node.args) >= 2):
                got = _dict_t(node.args[1])
                if got is not None:
                    compact_emits.add(got[0])
    emitted: Dict[str, Tuple[int, bool]] = {}
    for call, arg in _journal_dicts(m):
        got = _dict_t(arg)
        if got is None:
            diags.append(_err(
                "P502",
                "_journal() argument is not a literal dict with a literal "
                "\"t\" record type — the conformance plane (and journal "
                "replay) cannot check a computed record type",
                "master.py", call.lineno,
                "emit _journal({\"t\": \"<type>\", ...}) with the type as "
                "a string literal",
            ))
            continue
        t, has_result = got
        prev = emitted.get(t)
        emitted[t] = (call.lineno, has_result or (prev[1] if prev else False))
    for t, (line, has_result) in sorted(emitted.items()):
        if t not in record_types:
            diags.append(_err(
                "P502",
                f"journal record type {t!r} is emitted but not registered "
                f"in master_journal.RECORD_TYPES — replay would hard-error "
                f"as version skew",
                "master.py", line,
                f"add {t!r} to RECORD_TYPES and define Service._apply_{t}",
            ))
        if t not in apply_ops:
            diags.append(_err(
                "P502",
                f"journal record type {t!r} has no Service._apply_{t} "
                f"replay op — recovery would AttributeError on it",
                "master.py", line,
                f"define Service._apply_{t}(rec) (pure state, never "
                "journals)",
            ))
        if has_result and t not in compact_emits:
            diags.append(_err(
                "P502",
                f"record type {t!r} carries a \"result\" payload but is "
                f"not re-emitted by Service._compact — compaction would "
                f"silently drop the payloads (the snapshot stays pure "
                f"JSON and never carries them)",
                "master.py", line,
                f"re-emit retained {t!r} records into the new generation "
                "inside _compact",
            ))
    for t in sorted(record_types):
        if t not in emitted and t not in compact_emits:
            diags.append(_err(
                "P502",
                f"registered record type {t!r} is never emitted by any "
                f"_journal()/compaction site — dead protocol surface "
                f"(or the emission no longer uses a literal)",
                "master_journal.py", rt_line,
                f"drop {t!r} from RECORD_TYPES or restore its emission",
            ))
    for t, line in sorted(apply_ops.items()):
        if t not in record_types:
            diags.append(_err(
                "P502",
                f"Service._apply_{t} replays a record type {t!r} that is "
                f"not in RECORD_TYPES — unreachable replay op",
                "master.py", line,
                f"register {t!r} in RECORD_TYPES or delete the handler",
            ))
    return diags


# ---------------------------------------------------------------------------
# P503 — status-ledger exhaustiveness
# ---------------------------------------------------------------------------

def _status_literals(value: ast.AST) -> List[Tuple[str, int]]:
    """String constants reachable through IfExp/BoolOp arms of ``value``."""
    out: List[Tuple[str, int]] = []
    stack = [value]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append((node.value, node.lineno))
        elif isinstance(node, ast.IfExp):
            stack.extend((node.body, node.orelse))
        elif isinstance(node, ast.BoolOp):
            stack.extend(node.values)
    return out


def _is_status_target(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr == "status"
    return isinstance(node, ast.Name) and node.id == "status"


def _p503(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    sched = trees.get("serving/scheduler.py")
    if sched is None:
        return diags
    decl_node = _module_assign(sched, "TERMINAL_STATUSES")
    decl = _str_elts(decl_node) if decl_node is not None else None
    if decl is None:
        diags.append(_err(
            "P500",
            "TERMINAL_STATUSES is not a module-level literal tuple — the "
            "disjoint status ledger has no declared universe to check "
            "against",
            "serving/scheduler.py", getattr(decl_node, "lineno", None),
            "declare TERMINAL_STATUSES = (\"served\", ...) once in "
            "serving/scheduler.py; every other surface must reference it",
        ))
        return diags
    declared = {v for v, _ in decl}
    allowed = declared | _TRANSIENT_STATUSES
    assigned: Set[str] = set()
    for rel in ("serving/scheduler.py", "serving/router.py"):
        tree = trees.get(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            lits: List[Tuple[str, int]] = []
            is_assign = False
            if isinstance(node, ast.Assign):
                if any(_is_status_target(t) for t in node.targets):
                    lits = _status_literals(node.value)
                    is_assign = True
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "status":
                        lits.extend(_status_literals(kw.value))
                        is_assign = True
                fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                         else getattr(node.func, "id", None))
                if fname == "_finalize" and len(node.args) >= 2:
                    lits.extend(_status_literals(node.args[1]))
                    is_assign = True
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                if (any(_is_status_target(s) for s in sides)
                        and all(isinstance(op, (ast.Eq, ast.NotEq))
                                for op in node.ops)):
                    for s in sides:
                        lits.extend(_status_literals(s))
            for value, line in lits:
                if is_assign:
                    assigned.add(value)
                if value not in allowed:
                    diags.append(_err(
                        "P503",
                        f"status literal {value!r} is not in the declared "
                        f"disjoint set TERMINAL_STATUSES (nor the "
                        f"transient {sorted(_TRANSIENT_STATUSES)}) — "
                        f"summaries/ledgers keyed on the declared set "
                        f"would drop it",
                        rel, line,
                        "add it to serving/scheduler.py TERMINAL_STATUSES "
                        "(ONE source of truth) or use a declared status",
                    ))
        # a parallel status-set literal that drifted from the declaration
        for node in ast.walk(tree):
            if node is decl_node or not isinstance(node, (ast.Tuple, ast.Set,
                                                          ast.List)):
                continue
            elts = _str_elts(node)
            if elts is None:
                continue
            vals = {v for v, _ in elts}
            if len(vals & declared) >= 2 and vals != declared:
                diags.append(_err(
                    "P503",
                    f"status-set literal {sorted(vals)} diverges from the "
                    f"declared TERMINAL_STATUSES {sorted(declared)} — a "
                    f"status added in one place is invisible to the other",
                    rel, node.lineno if hasattr(node, "lineno") else None,
                    "reference scheduler.TERMINAL_STATUSES instead of "
                    "copying the literal",
                ))
    for v, line in decl:
        if v not in assigned:
            diags.append(_err(
                "P503",
                f"declared terminal status {v!r} is never assigned at any "
                f"transition site in the serving planes — dead ledger "
                f"category",
                "serving/scheduler.py", line,
                f"drop {v!r} from TERMINAL_STATUSES or restore the "
                "transition that lands on it",
            ))
    return diags


# ---------------------------------------------------------------------------
# P504 — lease/fence monotonicity hazards
# ---------------------------------------------------------------------------

def _field_kind(node: ast.AST) -> Optional[str]:
    """\"epoch\"/\"seq\" when the expression is an epoch/sequence field."""
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    if name is None:
        return None
    if name == "epoch":
        return "epoch"
    if name in ("seq", "_seq", "last_seq", "base_seq"):
        return "seq"
    return None


def _p504_compare(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for rel in ("master.py", "master_ha.py", "master_journal.py"):
        tree = trees.get(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Compare) or len(node.ops) != 1:
                continue
            kinds = (_field_kind(node.left),
                     _field_kind(node.comparators[0]))
            op = node.ops[0]
            if kinds == ("epoch", "epoch") and isinstance(
                    op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE)):
                diags.append(_err(
                    "P504",
                    "epoch fence compared with an ORDERING operator — the "
                    "epoch guard is an equality fence (rotation resets "
                    "epochs to 0, so ordering accepts a stale holder's "
                    "ack as current)",
                    rel, node.lineno,
                    "compare epochs with ==/!= (the service.go task-epoch "
                    "discipline)",
                ))
            if kinds == ("seq", "seq") and isinstance(
                    op, (ast.Eq, ast.NotEq)):
                diags.append(_err(
                    "P504",
                    "journal sequence compared with EQUALITY — the replay "
                    "dedupe guard is monotonic (a reordered/duplicated "
                    "record must compare by ordering, or replay either "
                    "re-applies or drops records)",
                    rel, node.lineno,
                    "compare sequences with <=/< against the high-water "
                    "mark",
                ))
    return diags


def _clock_plus_timeout(value: ast.AST) -> bool:
    """``<clock call> + <timeout-ish name>`` anywhere inside ``value``."""
    for node in ast.walk(value):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            sides = (node.left, node.right)
            has_clock = any(
                isinstance(s, ast.Call)
                and (_name_of(s.func) or "").rsplit(".", 1)[-1]
                in ("_clock", "clock", "monotonic", "time", "perf_counter")
                for s in sides
            )
            has_timeout = any(
                "timeout" in ((_name_of(s) or "").rsplit(".", 1)[-1])
                for s in sides
            )
            if has_clock and has_timeout:
                return True
    return False


def _deadline_write(stmt: ast.AST) -> Optional[int]:
    """Line of a lease-deadline write in ``stmt`` (Assign/AugAssign only)."""
    if not isinstance(stmt, (ast.Assign, ast.AugAssign)):
        return None
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    shared = [t for t in targets
              if isinstance(t, (ast.Attribute, ast.Subscript))]
    if not shared:
        return None
    named = any("deadline" in (getattr(t, "attr", "") or "").lower()
                for t in shared if isinstance(t, ast.Attribute))
    if named or _clock_plus_timeout(stmt.value):
        return stmt.lineno
    return None


def _lock_names(cls: ast.ClassDef) -> Set[str]:
    """Attribute names assigned a lock in ``__init__`` (make_lock/RLock)."""
    init = _class_methods(cls).get("__init__")
    out: Set[str] = set()
    if init is None:
        return out
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = (_name_of(node.value.func) or "").rsplit(".", 1)[-1]
            if ctor in ("make_lock", "make_rlock", "Lock", "RLock"):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
    return out


def _under_lock(path: Sequence[ast.AST], locks: Set[str]) -> bool:
    for node in path:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _name_of(item.context_expr)
                if name and name.rsplit(".", 1)[-1] in locks:
                    return True
    return False


def _self_call_sites(cls: ast.ClassDef) -> Dict[str, List[Tuple[str, bool]]]:
    """callee -> [(caller, call-site-under-lock)] over ``self.x(...)``
    calls, with the journal plane's ``getattr(self, f"_apply_{t}")(...)``
    dynamic dispatch expanded onto every ``_apply_*`` method."""
    locks = _lock_names(cls)
    methods = _class_methods(cls)
    sites: Dict[str, List[Tuple[str, bool]]] = {}

    def _walk(node: ast.AST, caller: str, path: List[ast.AST]) -> None:
        held = _under_lock(path, locks)
        if isinstance(node, ast.Call):
            callee = None
            if (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                callee = node.func.attr
            elif (isinstance(node.func, ast.Call)
                  and isinstance(node.func.func, ast.Name)
                  and node.func.func.id == "getattr"
                  and node.func.args
                  and isinstance(node.func.args[0], ast.Name)
                  and node.func.args[0].id == "self"):
                # getattr(self, <expr mentioning "_apply_">)(...) — the
                # replay dispatch: a call site for every _apply_* method
                dumped = ast.dump(node.func)
                if "_apply_" in dumped:
                    for m in methods:
                        if m.startswith("_apply_"):
                            sites.setdefault(m, []).append((caller, held))
            if callee in methods:
                sites.setdefault(callee, []).append((caller, held))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            _walk(child, caller, path + [node])

    for name, fn in methods.items():
        for stmt in fn.body:
            _walk(stmt, name, [])
    return sites


def _entry_held(cls: ast.ClassDef) -> Set[str]:
    """Methods whose EVERY reachable call site holds the class lock (a
    fixpoint over self-calls — the miniature of concurrency_lint's entry-held
    inference, enough for the lease-deadline fields)."""
    sites = _self_call_sites(cls)
    methods = set(_class_methods(cls))
    held = {m for m in methods if m in sites}  # optimistic start
    changed = True
    while changed:
        changed = False
        for m in sorted(held):
            ok = all(under or (caller in held and caller != m)
                     for caller, under in sites.get(m, ()))
            if not ok:
                held.discard(m)
                changed = True
    return held


def _p504_lease_locks(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for rel in ("master.py", "master_ha.py", "serving/router.py"):
        tree = trees.get(rel)
        if tree is None:
            continue
        for cls in (s for s in tree.body if isinstance(s, ast.ClassDef)):
            locks = _lock_names(cls)
            if not locks:
                continue
            entry_held = _entry_held(cls)
            for name, fn in _class_methods(cls).items():
                if name == "__init__" or name in entry_held:
                    continue

                def _scan(node: ast.AST, path: List[ast.AST]) -> None:
                    line = _deadline_write(node)
                    if line is not None and not _under_lock(path, locks):
                        diags.append(_err(
                            "P504",
                            f"lease deadline written in "
                            f"{cls.name}.{name} without holding the "
                            f"registry lock ({'/'.join(sorted(locks))}) — "
                            f"a concurrent prune/renew can tear the lease "
                            f"table",
                            rel, line,
                            "move the write under `with self._lock:` (or "
                            "make every call site hold it)",
                        ))
                    for child in ast.iter_child_nodes(node):
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.Lambda, ast.ClassDef)):
                            continue
                        _scan(child, path + [node])

                for stmt in fn.body:
                    _scan(stmt, [])
    return diags


# ---------------------------------------------------------------------------
# P505 — timeout completeness
# ---------------------------------------------------------------------------

def _p505(trees: Dict[str, ast.Module]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for rel in ("master.py", "master_ha.py", "serving/router.py"):
        tree = trees.get(rel)
        if tree is None:
            continue
        for cls in (s for s in tree.body if isinstance(s, ast.ClassDef)):
            fn = _class_methods(cls).get("_call")
            if fn is None:
                continue
            names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            attrs = {n.attr for n in ast.walk(fn)
                     if isinstance(n, ast.Attribute)}
            bounded = any("timeout" in s or "deadline" in s
                          for s in names | attrs)
            raises = any(isinstance(n, ast.Raise) for n in ast.walk(fn))
            if not (bounded and raises):
                diags.append(_err(
                    "P505",
                    f"RPC client {cls.name}._call has no deadline path — "
                    f"a dead or frozen peer would hang the caller forever "
                    f"instead of raising MasterTimeoutError",
                    rel, fn.lineno,
                    "bound the call with call_timeout_s/deadline and "
                    "raise MasterTimeoutError (or re-raise) when it "
                    "elapses",
                ))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "poll"):
                unbounded = (not node.args and not node.keywords) or any(
                    isinstance(a, ast.Constant) and a.value is None
                    for a in node.args)
                if unbounded:
                    diags.append(_err(
                        "P505",
                        "unbounded Connection.poll() on an RPC plane — "
                        "blocks forever with no route to "
                        "MasterTimeoutError",
                        rel, node.lineno,
                        "pass a finite timeout (poll(remaining)) derived "
                        "from the call deadline",
                    ))
            if (isinstance(node, ast.Call)
                    and (_name_of(node.func) or "").rsplit(".", 1)[-1]
                    in ("Client", "HAClient")):
                for kw in node.keywords:
                    if (kw.arg == "call_timeout_s"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is None):
                        diags.append(_err(
                            "P505",
                            "RPC client constructed with "
                            "call_timeout_s=None — every call site needs "
                            "a deadline path to MasterTimeoutError",
                            rel, node.lineno,
                            "pass a finite call_timeout_s (the default "
                            "is already bounded)",
                        ))
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_sources(root: Optional[str] = None) -> Dict[str, str]:
    root = root or _package_root()
    out: Dict[str, str] = {}
    for rel in PROTOCOL_FILES:
        path = os.path.join(root, *rel.split("/"))
        with open(path, encoding="utf-8") as f:
            out[rel] = f.read()
    return out


def lint_protocol_sources(sources: Mapping[str, str]) -> List[Diagnostic]:
    """Run every P-rule over ``{relpath: source}`` (mutation tests pass a
    rewritten copy; :func:`lint_protocol_package` passes the real tree)."""
    diags: List[Diagnostic] = []
    trees: Dict[str, ast.Module] = {}
    prag: Dict[str, Dict[int, _pragmas.Pragma]] = {}
    for rel, src in sources.items():
        prag[rel] = _pragmas.collect(src, "proto", rel, diags)
        try:
            trees[rel] = ast.parse(src)
        except SyntaxError as exc:
            diags.append(_err(
                "P500", f"unparseable protocol surface: {exc.msg}", rel,
                exc.lineno, "fix the syntax error",
            ))
    findings: List[Diagnostic] = []
    findings.extend(_p501(trees))
    findings.extend(_p502(trees))
    findings.extend(_p503(trees))
    findings.extend(_p504_compare(trees))
    findings.extend(_p504_lease_locks(trees))
    findings.extend(_p505(trees))
    used: Dict[str, Set[int]] = {rel: set() for rel in sources}
    for d in findings:
        p = prag.get(d.source, {}).get(d.line or -1)
        if p is not None and p.suppresses(d.rule):
            used.setdefault(d.source, set()).add(d.line)
            continue
        diags.append(d)
    for rel in sources:
        diags.extend(_pragmas.stale_findings(
            prag.get(rel, {}), used.get(rel, ()), "proto", rel,
            severity=Severity.ERROR,
        ))
    return diags


def lint_protocol_package(root: Optional[str] = None) -> List[Diagnostic]:
    """Lint the port's protocol surfaces (``python -m paddle_tpu_torch lint
    --protocol``).  Zero findings is the gate."""
    return lint_protocol_sources(_load_sources(root))
