"""Lock-discipline lint — static C-rules over the port's threaded planes;
the counterpart of ``paddle_tpu/analysis/concurrency_lint.py`` (same rule
ids, same findings on the same source), run over ``paddle_tpu_torch``.

The port carries the JAX package's multi-threaded distributed system (the
master queue / registry / fence plane on one RLock, the HA standby tail
thread, the elastic heartbeat thread, async checkpoint writers, the
prefetch feeder, the serving router's poll thread).  This pass applies the
config_assert philosophy to *threads*: infer each class's lock discipline
from the AST and report the violations before a drill does.  The runtime
leg (:mod:`~paddle_tpu_torch.analysis.lock_sanitizer`) checks the same
invariants dynamically while the drills run.

Inference, per class (and per module, for module-level locks/globals):

  * lock attrs        ``self._lock = threading.Lock()/RLock()/Condition()``
                      (or the ``make_lock``/``make_rlock`` sanitizer
                      factories, or any ``with self.X:`` whose name matches
                      ``lock|mutex|_mu``);
  * guarded fields    fields mutated at least once while a lock is held —
                      assignment, ``del``, subscript stores, and container
                      mutators (``.append``/``.update``/...);
  * held-set          propagated interprocedurally within the class: a
                      private method whose every in-class call site holds
                      lock L is analyzed as if L were held on entry
                      (``__init__`` is single-threaded by construction:
                      its writes and call sites are exempt);
  * thread entries    targets of ``threading.Thread(target=...)`` /
                      ``threading.Timer(..., cb)`` — a method or nested
                      function that runs on a second thread.

Rules (``C###``):

  C301 mixed-guard-write   a guarded field is also written while its lock
                           set is NOT held — two writers can interleave
  C302 unguarded-read      a thread-entry path reads a guarded field
                           without the lock — torn/stale reads on the
                           second thread
  C303 lock-order-cycle    the static acquisition graph (nested ``with``,
                           plus calls into lock-acquiring methods, across
                           classes) contains a cycle — an ABBA deadlock
  C304 blocking-under-lock a blocking call (``os.fsync``, socket/pipe
                           send/recv/accept, ``time.sleep``, subprocess,
                           no-timeout ``.wait()``/queue ops, thread join)
                           while holding a lock — annotate intentional
                           holds (journal fsync-before-ack) with the
                           pragma below
  C305 leaked-thread       a non-daemon thread with no join path, or a
                           no-timeout ``Event.wait`` in a loop (a stop
                           flag can never interrupt it)
  C306 uninjectable-sleep  a ``time.sleep`` polling loop in a function
                           with no injectable ``sleep``/``clock`` hook —
                           the LeaseFile testability discipline: polling
                           loops must be drivable by a fake clock

Allowlist pragma (same line as the finding)::

    os.fsync(f.fileno())  # lock: allow[C304] fsync-before-ack is the contract

``# lock: allow[C304,C306] why`` suppresses several rules at once.  The
justification string is REQUIRED — an empty one is its own finding (C300).

Run via ``python -m paddle_tpu_torch lint --concurrency``.  Rule ids are
stable; every rule has a firing mutation test in
tests/test_concurrency_lint.py, which tests/test_torch_concurrency_lint.py
runs through both packages.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis import pragmas as _pragmas
from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = ["lint_concurrency_file", "lint_concurrency_package"]

_LOCKNAME_RE = re.compile(r"lock|mutex|_mu$", re.IGNORECASE)

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "make_lock", "make_rlock"})
_EVENT_CTORS = frozenset({"Event"})
_THREAD_CTORS = frozenset({"Thread", "Timer"})

# container-mutator method names: `self.x.append(...)` mutates field x
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "update", "setdefault", "add", "discard", "sort", "reverse",
})

# method names too generic to resolve cross-class by name alone
_CROSS_CALL_STOPLIST = frozenset({
    "close", "open", "start", "stop", "run", "next", "read", "write",
    "send", "recv", "get", "put", "join", "wait", "acquire", "release",
    "append", "add", "update", "items", "keys", "values", "copy", "flush",
})

# receiver tails that mean a blocking transport op regardless of receiver
_BLOCKING_TAILS = frozenset({
    "accept", "connect", "recv", "recv_bytes", "send", "sendall",
    "send_bytes",
    # the master_wire transport helpers block exactly like the raw socket
    # ops they wrap (one frame send / one frame recv)
    "send_msg", "recv_msg",
})
_SUBPROCESS_FNS = frozenset({"run", "call", "check_call", "check_output", "Popen"})
_THREADISH_RE = re.compile(r"thread|proc|worker|pending", re.IGNORECASE)
_QUEUEISH_RE = re.compile(r"(^|_)q(s)?($|_)|queue", re.IGNORECASE)

_SLEEP_INJECTABLES = frozenset({"sleep", "sleep_fn", "clock"})


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _attr_root(node: ast.AST) -> Tuple[Optional[ast.AST], List[ast.AST]]:
    """Descend a Subscript/Attribute chain; returns (root expr, chain nodes).
    ``self.fences[fid]["arrived"]`` -> (Name 'self'-rooted Attribute, ...)."""
    chain: List[ast.AST] = []
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        chain.append(node)
        node = node.value
    return node, chain


def _self_field(node: ast.AST) -> Optional[ast.Attribute]:
    """The ``self.X`` Attribute at the root of a target/receiver chain."""
    root, chain = _attr_root(node)
    if isinstance(root, ast.Name) and root.id == "self" and chain:
        last = chain[-1]
        if isinstance(last, ast.Attribute):
            return last
    return None


@dataclasses.dataclass
class _Event:
    """One analyzed occurrence inside a function body (access / call /
    acquisition / blocking op / sleep), with the lexically-held lock set."""

    kind: str  # read|write|self_call|other_call|acquire|blocking|sleep|wait
    name: str
    line: int
    held: frozenset
    thread_side: bool = False
    in_loop: bool = False
    detail: str = ""


@dataclasses.dataclass
class _Spawn:
    target: Optional[str]     # 'self.m' | local/module function name
    daemon: Optional[bool]    # None = not specified
    line: int
    var: Optional[str] = None       # local var the Thread was bound to
    attr: Optional[str] = None      # self attr the Thread was stored to


@dataclasses.dataclass
class _FnInfo:
    name: str
    params: Set[str]
    events: List[_Event] = dataclasses.field(default_factory=list)
    spawns: List[_Spawn] = dataclasses.field(default_factory=list)
    joined_vars: Set[str] = dataclasses.field(default_factory=set)
    daemonized_vars: Set[str] = dataclasses.field(default_factory=set)
    is_thread_entry: bool = False


@dataclasses.dataclass
class _ClassInfo:
    module: str
    name: str
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    event_attrs: Set[str] = dataclasses.field(default_factory=set)
    thread_attrs: Set[str] = dataclasses.field(default_factory=set)
    method_names: Set[str] = dataclasses.field(default_factory=set)
    init_params: Set[str] = dataclasses.field(default_factory=set)
    methods: Dict[str, _FnInfo] = dataclasses.field(default_factory=dict)
    joined_attrs: Set[str] = dataclasses.field(default_factory=set)
    thread_entries: Set[str] = dataclasses.field(default_factory=set)

    @property
    def key(self) -> str:
        return f"{self.module}.{self.name}"

    def lock_id(self, attr: str) -> str:
        return f"{self.module}.{self.name}.{attr}"


@dataclasses.dataclass
class _ModuleInfo:
    name: str
    relpath: str
    classes: Dict[str, _ClassInfo] = dataclasses.field(default_factory=dict)
    module_locks: Set[str] = dataclasses.field(default_factory=set)
    functions: Dict[str, _FnInfo] = dataclasses.field(default_factory=dict)
    global_writes: List[_Event] = dataclasses.field(default_factory=list)
    pragmas: Dict[int, Tuple[Set[str], str]] = dataclasses.field(default_factory=dict)
    pragma_used: Set[int] = dataclasses.field(default_factory=set)


class _Universe:
    """Package-wide lookup tables for cross-class resolution."""

    def __init__(self, modules: Sequence[_ModuleInfo]):
        self.modules = list(modules)
        # lock attr name -> owning class keys (unique name = resolvable)
        self.lock_attr_owners: Dict[str, List[_ClassInfo]] = {}
        # method name -> owning classes
        self.method_owners: Dict[str, List[_ClassInfo]] = {}
        for m in modules:
            for c in m.classes.values():
                for a in c.lock_attrs:
                    self.lock_attr_owners.setdefault(a, []).append(c)
                for meth in c.method_names:
                    self.method_owners.setdefault(meth, []).append(c)

    def resolve_foreign_lock(self, attr: str, own: Optional[_ClassInfo]) -> Optional[str]:
        owners = [c for c in self.lock_attr_owners.get(attr, ()) if c is not own]
        if len(owners) == 1:
            return owners[0].lock_id(attr)
        return None

    def resolve_foreign_method(self, name: str, own: Optional[_ClassInfo]) -> Optional[_ClassInfo]:
        if name in _CROSS_CALL_STOPLIST or name.startswith("__"):
            return None
        owners = [c for c in self.method_owners.get(name, ()) if c is not own]
        if len(owners) == 1:
            return owners[0]
        return None


# ---------------------------------------------------------------------------
# phase 1: declarations (lock/event/thread attrs, thread entries, pragmas)
# ---------------------------------------------------------------------------

def _module_name(path: str, base: str) -> str:
    rel = os.path.relpath(path, base)
    for prefix in ("paddle_tpu_torch" + os.sep,):
        if rel.startswith(prefix):
            rel = rel[len(prefix):]
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _ctor_kind(value: ast.AST) -> Optional[str]:
    """'lock' | 'event' | 'thread' when value is a recognized constructor."""
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func)
    if dotted is None:
        return None
    tail = dotted.rpartition(".")[2]
    if tail in _LOCK_CTORS:
        return "lock"
    if tail in _EVENT_CTORS:
        return "event"
    if tail in _THREAD_CTORS:
        return "thread"
    return None


def _collect_pragmas(src: str, relpath: str, diags: List[Diagnostic],
                     info: _ModuleInfo) -> None:
    """Pragmas parse through the shared plane parser (analysis.pragmas):
    COMMENT tokens only — a ``# lock: allow[...]`` spelled inside a string
    literal is documentation, not an annotation — and an empty
    justification is its own C300 finding."""
    for line, p in _pragmas.collect(src, "lock", relpath, diags).items():
        info.pragmas[line] = (set(p.rules), p.justification)


def _declared(tree: ast.Module, mod: str, relpath: str) -> _ModuleInfo:
    info = _ModuleInfo(name=mod, relpath=relpath)
    for node in tree.body:
        if isinstance(node, ast.Assign) and _ctor_kind(node.value) == "lock":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    info.module_locks.add(t.id)
        elif isinstance(node, ast.ClassDef):
            c = _ClassInfo(module=mod, name=node.name)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    c.method_names.add(item.name)
                    if item.name == "__init__":
                        c.init_params = {a.arg for a in item.args.args}
                        c.init_params |= {a.arg for a in item.args.kwonlyargs}
            for sub in ast.walk(node):
                # self.X = <ctor>  anywhere in the class body
                if isinstance(sub, ast.Assign):
                    kind = _ctor_kind(sub.value)
                    if kind:
                        for t in sub.targets:
                            f = _self_field(t)
                            if f is not None and not isinstance(
                                t, (ast.Subscript,)
                            ):
                                {"lock": c.lock_attrs,
                                 "event": c.event_attrs,
                                 "thread": c.thread_attrs}[kind].add(f.attr)
                # any `with self.X:` with a lock-ish name counts as a lock
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    for it in sub.items:
                        f = _self_field(it.context_expr)
                        if f is not None and _LOCKNAME_RE.search(f.attr):
                            c.lock_attrs.add(f.attr)
                # `self.X.join(...)` anywhere -> X has a join path
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
                    if sub.func.attr == "join":
                        f = _self_field(sub.func.value)
                        if f is not None:
                            c.joined_attrs.add(f.attr)
            c.event_attrs -= c.lock_attrs
            info.classes[node.name] = c
    return info


# ---------------------------------------------------------------------------
# phase 2: body analysis
# ---------------------------------------------------------------------------

class _FnScanner:
    """Walk one function body tracking the lexically held lock set."""

    def __init__(self, universe: _Universe, minfo: _ModuleInfo,
                 cls: Optional[_ClassInfo], fn: _FnInfo,
                 local_locks: Optional[Dict[str, str]] = None,
                 qual: str = ""):
        self.u = universe
        self.m = minfo
        self.c = cls
        self.fn = fn
        self.qual = qual or fn.name
        self.local_locks = dict(local_locks or {})
        self.global_names: Set[str] = set()
        self.thread_side = fn.is_thread_entry

    # -- lock resolution -------------------------------------------------
    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                # directly `with self.X:`
                if self.c is not None and expr.attr in self.c.lock_attrs:
                    return self.c.lock_id(expr.attr)
                return None
            # `with other.X:` (any depth) — resolvable when X is a
            # lock-named attr owned by exactly one analyzed class
            if _LOCKNAME_RE.search(expr.attr):
                return self.u.resolve_foreign_lock(expr.attr, self.c)
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.m.module_locks:
                return f"{self.m.name}.{expr.id}"
            if expr.id in self.local_locks:
                return self.local_locks[expr.id]
        return None

    # -- entry -----------------------------------------------------------
    def scan(self, node: ast.AST, held: frozenset = frozenset()) -> None:
        # pre-pass: thread targets among nested defs, local lock vars,
        # daemonized/joined thread vars
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func)
                tail = d.rpartition(".")[2] if d else ""
                if tail in _THREAD_CTORS:
                    self._note_spawn(sub)
                elif tail == "join" and isinstance(sub.func, ast.Attribute):
                    recv = sub.func.value
                    if isinstance(recv, ast.Name):
                        self.fn.joined_vars.add(recv.id)
            elif isinstance(sub, ast.Assign):
                if _ctor_kind(sub.value) == "lock":
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            self.local_locks[t.id] = (
                                f"{self.m.name}.{self.qual}.{t.id}"
                            )
                # t.daemon = True
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute) and t.attr == "daemon"
                            and isinstance(t.value, ast.Name)
                            and isinstance(sub.value, ast.Constant)
                            and sub.value.value):
                        self.fn.daemonized_vars.add(t.value.id)
            elif isinstance(sub, ast.Global):
                self.global_names.update(sub.names)
        body = node.body if hasattr(node, "body") else [node]
        self._stmts(body, held, 0)

    def _note_spawn(self, call: ast.Call) -> None:
        d = _dotted(call.func) or ""
        tail = d.rpartition(".")[2]
        target_expr = None
        if tail == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif tail == "Timer" and len(call.args) >= 2:
            target_expr = call.args[1]
        daemon = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        target = None
        if target_expr is not None:
            f = _self_field(target_expr)
            if f is not None:
                target = f"self.{f.attr}"
                if self.c is not None:
                    self.c.thread_entries.add(f.attr)
            elif isinstance(target_expr, ast.Name):
                target = target_expr.id
        self.fn.spawns.append(_Spawn(target=target, daemon=daemon,
                                     line=call.lineno))

    # -- statements ------------------------------------------------------
    def _stmts(self, body: Sequence[ast.stmt], held: frozenset, loop: int) -> None:
        for stmt in body:
            self._stmt(stmt, held, loop)

    def _stmt(self, stmt: ast.stmt, held: frozenset, loop: int) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for it in stmt.items:
                lock = self._resolve_lock(it.context_expr)
                if lock is not None:
                    self._event("acquire", lock, it.context_expr.lineno,
                                new_held, loop)
                    new_held = new_held | {lock}
                else:
                    self._exprs([it.context_expr], held, loop)
            self._stmts(stmt.body, new_held, loop)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._nested_def(stmt, held)
        elif isinstance(stmt, ast.ClassDef):
            pass  # nested classes: out of scope
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            header = [stmt.test] if isinstance(stmt, ast.While) else [stmt.iter]
            self._exprs(header, held, loop + 1)
            self._stmts(stmt.body, held, loop + 1)
            self._stmts(stmt.orelse, held, loop)
        elif isinstance(stmt, ast.If):
            self._exprs([stmt.test], held, loop)
            self._stmts(stmt.body, held, loop)
            self._stmts(stmt.orelse, held, loop)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body, held, loop)
            for h in stmt.handlers:
                self._stmts(h.body, held, loop)
            self._stmts(stmt.orelse, held, loop)
            self._stmts(stmt.finalbody, held, loop)
        elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            skip: Set[int] = set()
            for t in targets:
                self._write_target(t, held, loop, skip)
            value = stmt.value
            if value is not None:
                self._exprs([value], held, loop, skip)
            if isinstance(stmt, ast.AugAssign):
                # aug-assign reads the target too; the write already notes it
                pass
        elif isinstance(stmt, ast.Delete):
            skip = set()
            for t in stmt.targets:
                self._write_target(t, held, loop, skip)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._exprs([stmt.value], held, loop)
        elif isinstance(stmt, ast.Expr):
            self._exprs([stmt.value], held, loop)
        else:
            exprs = [v for v in ast.iter_child_nodes(stmt)
                     if isinstance(v, ast.expr)]
            self._exprs(exprs, held, loop)

    def _nested_def(self, stmt, held: frozenset) -> None:
        """A nested ``def``: if it is a thread target it runs on a second
        thread with NOTHING held; otherwise treat it as running where it
        was defined (closure called locally)."""
        is_thread = any(
            s.target == stmt.name for s in self.fn.spawns
        )
        sub_fn = _FnInfo(
            name=f"{self.fn.name}.{stmt.name}",
            params={a.arg for a in stmt.args.args} | self.fn.params,
            is_thread_entry=is_thread or self.fn.is_thread_entry,
        )
        scanner = _FnScanner(self.u, self.m, self.c, sub_fn,
                             local_locks=self.local_locks,
                             qual=f"{self.qual}.{stmt.name}")
        scanner.global_names = set(self.global_names)
        scanner.scan(stmt, frozenset() if is_thread else held)
        # nested events fold into the enclosing method record so the
        # class-level passes see them (entry-held union still applies to
        # the ENCLOSING method; thread bodies carry thread_side=True).
        # Spawns do NOT fold back: the enclosing scan()'s pre-pass already
        # walked the nested body, so extending here would double-record
        # every nested-def Thread construction (duplicate C305s).
        self.fn.events.extend(sub_fn.events)

    # -- writes ----------------------------------------------------------
    def _write_target(self, t: ast.AST, held: frozenset, loop: int,
                      skip: Set[int]) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._write_target(el, held, loop, skip)
            return
        f = _self_field(t)
        if f is not None:
            if self.c is not None and (
                f.attr in self.c.lock_attrs or f.attr in self.c.event_attrs
            ):
                return
            self._event("write", f.attr, t.lineno, held, loop)
            root, chain = _attr_root(t)
            skip.update(id(n) for n in chain)
            skip.add(id(root))
            # subscript stores read the container first; chain exprs
            # (indices) still get scanned by the caller via value walk
            for n in chain:
                if isinstance(n, ast.Subscript):
                    self._exprs([n.slice], held, loop)
            return
        root, chain = _attr_root(t)
        if isinstance(root, ast.Name) and (
            root.id in self.global_names
            or (not chain and root.id in self.m.module_locks)
        ):
            self._event("gwrite", root.id, t.lineno, held, loop)
            skip.add(id(root))
            skip.update(id(n) for n in chain)

    # -- expressions -----------------------------------------------------
    def _exprs(self, exprs: Sequence[Optional[ast.expr]], held: frozenset,
               loop: int, skip: Optional[Set[int]] = None) -> None:
        skip = skip or set()
        for e in exprs:
            if e is None:
                continue
            lambda_sub: Set[int] = set()
            for node in ast.walk(e):
                if id(node) in lambda_sub:
                    continue
                if isinstance(node, ast.Lambda):
                    # a lambda body runs LATER, somewhere else — analyzing
                    # it with the definition site's held-set would invent
                    # findings at a context the code never executes in.
                    # ast.walk still yields its children, so blacklist the
                    # whole subtree explicitly.
                    for sub in ast.walk(node):
                        if sub is not node:
                            lambda_sub.add(id(sub))
                    continue
                if isinstance(node, ast.Call):
                    self._call(node, held, loop, skip)
                elif isinstance(node, ast.Attribute) and id(node) not in skip:
                    if (isinstance(node.value, ast.Name)
                            and node.value.id == "self"
                            and isinstance(node.ctx, ast.Load)):
                        c = self.c
                        if c is not None and node.attr not in c.method_names \
                                and node.attr not in c.lock_attrs \
                                and node.attr not in c.event_attrs:
                            self._event("read", node.attr, node.lineno,
                                        held, loop)

    def _call(self, node: ast.Call, held: frozenset, loop: int,
              skip: Set[int]) -> None:
        d = _dotted(node.func)
        tail = (d or "").rpartition(".")[2]
        head = (d or "").rpartition(".")[0]
        func = node.func

        # time.sleep: C304 material under a lock, C306 material in a loop
        if d == "time.sleep" or (tail == "sleep" and head == "time"):
            self._event("sleep", "time.sleep", node.lineno, held, loop,
                        in_loop=loop > 0)
        elif d == "os.fsync":
            self._event("blocking", "os.fsync", node.lineno, held, loop)
        elif head == "subprocess" and tail in _SUBPROCESS_FNS:
            self._event("blocking", d, node.lineno, held, loop)
        elif isinstance(func, ast.Attribute):
            recv = func.value
            recv_name = _dotted(recv) or ""
            recv_field = _self_field(recv)
            is_lock_recv = (
                self._resolve_lock(recv) is not None
                or (recv_field is not None and self.c is not None
                    and recv_field.attr in self.c.lock_attrs)
            )
            if tail in _BLOCKING_TAILS and not isinstance(recv, ast.Constant):
                self._event("blocking", f".{tail}", node.lineno, held, loop)
            elif tail == "join" and not isinstance(recv, ast.Constant):
                if d != "os.path.join" and not (d or "").endswith("path.join"):
                    if _THREADISH_RE.search(recv_name) or (
                        recv_field is not None and self.c is not None
                        and recv_field.attr in self.c.thread_attrs
                    ) or (isinstance(recv, ast.Name)
                          and recv.id in self.fn.joined_vars
                          and any(s.var == recv.id for s in self.fn.spawns)):
                        self._event("blocking", ".join", node.lineno, held, loop)
            elif tail == "wait" and not node.args and not node.keywords:
                if not is_lock_recv:  # Condition.wait releases the lock
                    ev = (recv_field is not None and self.c is not None
                          and recv_field.attr in self.c.event_attrs)
                    self._event("wait", recv_name or ".wait", node.lineno,
                                held, loop, in_loop=loop > 0,
                                detail="event" if ev else "")
            elif tail == "get" and not node.args and not any(
                kw.arg == "timeout" for kw in node.keywords
            ) and _QUEUEISH_RE.search(recv_name):
                self._event("blocking", ".get", node.lineno, held, loop)
            elif tail == "put" and not any(
                kw.arg == "timeout" for kw in node.keywords
            ) and _QUEUEISH_RE.search(recv_name):
                self._event("blocking", ".put", node.lineno, held, loop)

            # self-calls / cross-class calls (for held-set + lock-graph)
            if recv_field is None and isinstance(recv, ast.Name) \
                    and recv.id == "self":
                if self.c is not None and tail in self.c.method_names:
                    self._event("self_call", tail, node.lineno, held, loop)
                    skip.add(id(func))
            elif not is_lock_recv and tail not in _MUTATORS:
                self._event("other_call", tail, node.lineno, held, loop)

        # container mutators on self fields: `self.todo.append(x)`
        if isinstance(func, ast.Attribute) and tail in _MUTATORS:
            f = _self_field(func.value)
            if f is not None and self.c is not None \
                    and f.attr not in self.c.lock_attrs \
                    and f.attr not in self.c.event_attrs:
                self._event("write", f.attr, node.lineno, held, loop)
                skip.add(id(func.value))
            else:
                root, _ = _attr_root(func.value)
                if isinstance(root, ast.Name) and root.id in self.global_names:
                    self._event("gwrite", root.id, node.lineno, held, loop)

    def _event(self, kind: str, name: str, line: int, held: frozenset,
               loop: int, in_loop: bool = False, detail: str = "") -> None:
        self.fn.events.append(_Event(
            kind=kind, name=name, line=line, held=held,
            thread_side=self.thread_side, in_loop=in_loop or loop > 0,
            detail=detail,
        ))


# ---------------------------------------------------------------------------
# phase 3: class-level reasoning + diagnostics
# ---------------------------------------------------------------------------

_TOP = None  # lattice top for the entry-held fixpoint ("unknown context")


def _entry_held_fixpoint(c: _ClassInfo) -> Dict[str, Optional[frozenset]]:
    """Held-on-entry per method: intersection over in-class call sites,
    {} for externally-callable methods (public names, dunders, thread
    entries).  ``__init__`` call sites are exempt (single-threaded by
    construction).  A private method with NO visible non-init call site is
    dispatched dynamically (``getattr(self, f"_apply_{t}")``) or dead —
    its context is unknowable statically, so it maps to ``None`` (exempt
    from C301/C302 rather than reported at a context the code never runs
    in)."""
    sites: Dict[str, List[Tuple[str, frozenset]]] = {}
    for mname, fn in c.methods.items():
        if mname == "__init__":
            continue
        for ev in fn.events:
            if ev.kind == "self_call":
                sites.setdefault(ev.name, []).append((mname, ev.held))

    entry: Dict[str, object] = {}
    for mname in c.methods:
        if (not mname.startswith("_") or mname.startswith("__")
                or mname in c.thread_entries):
            entry[mname] = frozenset()
        else:
            entry[mname] = _TOP

    changed = True
    while changed:
        changed = False
        for mname, slist in sites.items():
            if mname not in entry or entry[mname] == frozenset():
                continue
            met = None
            for caller, held in slist:
                ce = entry.get(caller, frozenset())
                if ce is _TOP:
                    continue  # unresolved caller contributes nothing yet
                eff = frozenset(ce) | held
                met = eff if met is None else (met & eff)
            if met is not None and met != entry[mname]:
                entry[mname] = met
                changed = True
    return {m: (None if e is _TOP else frozenset(e))
            for m, e in entry.items()}


def _thread_held_fixpoint(c: _ClassInfo) -> Dict[str, frozenset]:
    """Minimum lock set held when each method runs ON A SPAWNED THREAD:
    seeded at the thread entries (nothing held), propagated through
    self-calls with the lexical held-set at each call site.  Methods not
    in the result are unreachable from any thread entry — C302 does not
    apply to them."""
    held_map: Dict[str, frozenset] = {
        m: frozenset() for m in c.thread_entries if m in c.methods
    }
    changed = True
    while changed:
        changed = False
        for mname in list(held_map):
            fn = c.methods.get(mname)
            if fn is None:
                continue
            for ev in fn.events:
                if ev.kind != "self_call":
                    continue
                cand = held_map[mname] | ev.held
                cur = held_map.get(ev.name)
                new = cand if cur is None else (cur & cand)
                if new != cur:
                    held_map[ev.name] = new
                    changed = True
    return held_map


def _acquires_fixpoint(c: _ClassInfo) -> Dict[str, frozenset]:
    """Locks each method may acquire (directly or via self-calls)."""
    acq: Dict[str, Set[str]] = {m: set() for m in c.methods}
    for mname, fn in c.methods.items():
        for ev in fn.events:
            if ev.kind == "acquire":
                acq[mname].add(ev.name)
    changed = True
    while changed:
        changed = False
        for mname, fn in c.methods.items():
            for ev in fn.events:
                if ev.kind == "self_call" and ev.name in acq:
                    before = len(acq[mname])
                    acq[mname] |= acq[ev.name]
                    if len(acq[mname]) != before:
                        changed = True
    return {m: frozenset(s) for m, s in acq.items()}


class _Linter:
    def __init__(self, universe: _Universe):
        self.u = universe
        self.diags: List[Diagnostic] = []
        self._acq_cache: Dict[str, Dict[str, frozenset]] = {}
        # edge -> (relpath, line) where first observed
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # -- pragma-aware emit ----------------------------------------------
    def _emit(self, m: _ModuleInfo, rule: str, severity: Severity,
              message: str, line: int, hint: Optional[str] = None,
              layer: Optional[str] = None) -> bool:
        pragma = m.pragmas.get(line)
        if pragma and rule in pragma[0]:
            m.pragma_used.add(line)
            return False
        self.diags.append(Diagnostic(
            rule=rule, severity=severity, message=message,
            source=m.relpath, line=line, hint=hint, layer=layer,
        ))
        return True

    def _acquires(self, c: _ClassInfo) -> Dict[str, frozenset]:
        got = self._acq_cache.get(c.key)
        if got is None:
            got = self._acq_cache[c.key] = _acquires_fixpoint(c)
        return got

    def _edge(self, m: _ModuleInfo, a: str, b: str, line: int) -> None:
        if a == b:
            return  # reentrant same-lock (RLock) is not an ordering event
        pragma = m.pragmas.get(line)
        if pragma and "C303" in pragma[0]:
            m.pragma_used.add(line)
            return
        self.edges.setdefault((a, b), (m.relpath, line))

    # -- per-class -------------------------------------------------------
    def lint_class(self, m: _ModuleInfo, c: _ClassInfo) -> None:
        entry = _entry_held_fixpoint(c)
        thread_held = _thread_held_fixpoint(c)
        acquires = self._acquires(c)

        def eff(mname: str, ev: _Event) -> Optional[frozenset]:
            """Effective held set for C301/C304, None = unknowable context
            (dynamically-dispatched private method)."""
            base = entry.get(mname, frozenset())
            if ev.thread_side and mname not in c.thread_entries:
                # nested thread body: entry-held of the enclosing method
                # does NOT apply (fresh thread holds nothing)
                base = frozenset()
            if base is None:
                return None
            return ev.held | base

        # guarded fields: written at least once under a lock
        guards: Dict[str, Set[str]] = {}
        for mname, fn in c.methods.items():
            if mname == "__init__":
                continue
            for ev in fn.events:
                if ev.kind == "write":
                    h = eff(mname, ev)
                    if h:
                        guards.setdefault(ev.name, set()).update(h)

        for mname, fn in c.methods.items():
            if mname == "__init__":
                continue
            for ev in fn.events:
                h = eff(mname, ev)
                if h is None:
                    h_lex = ev.held  # lexical only; skip guard rules
                else:
                    h_lex = h
                if ev.kind == "write" and ev.name in guards and h is not None:
                    if not (h & guards[ev.name]):
                        self._emit(
                            m, "C301", Severity.ERROR,
                            f"field {ev.name!r} is written here without "
                            f"{_fmt_locks(guards[ev.name])}, but other "
                            "writes hold it — two writers can interleave",
                            ev.line, layer=f"{c.name}.{mname}",
                            hint="take the lock around this write, or move "
                            "the field out of the guarded set",
                        )
                elif ev.kind == "read" and ev.name in guards and (
                    mname in thread_held or ev.thread_side
                ):
                    on_thread = ev.held | (
                        frozenset() if ev.thread_side
                        else thread_held.get(mname, frozenset())
                    )
                    if not (on_thread & guards[ev.name]):
                        self._emit(
                            m, "C302", Severity.ERROR,
                            f"guarded field {ev.name!r} read without "
                            f"{_fmt_locks(guards[ev.name])} on a thread-entry "
                            "path — the second thread can observe torn/stale "
                            "state",
                            ev.line, layer=f"{c.name}.{mname}",
                            hint="read under the lock (snapshot into a local "
                            "if the hold must stay short)",
                        )
                elif ev.kind in ("blocking", "sleep", "wait") and h_lex:
                    self._emit(
                        m, "C304", Severity.WARNING,
                        f"blocking call {ev.name} while holding "
                        f"{_fmt_locks(h_lex)} — every other thread touching this "
                        "lock stalls behind the i/o",
                        ev.line, layer=f"{c.name}.{mname}",
                        hint="move the blocking op outside the critical "
                        "section, or annotate the intentional hold: "
                        "# lock: allow[C304] <why>",
                    )
                if ev.kind == "wait" and ev.in_loop and ev.detail == "event":
                    self._emit(
                        m, "C305", Severity.WARNING,
                        f"no-timeout Event.wait on {ev.name!r} inside a "
                        "loop — a stop flag can never interrupt it",
                        ev.line, layer=f"{c.name}.{mname}",
                        hint="wait(timeout) and re-check the stop condition "
                        "each iteration",
                    )
                if ev.kind == "sleep" and ev.in_loop:
                    self._maybe_c306(m, c, fn, ev, mname)
                if ev.kind == "acquire":
                    for holder in h_lex:
                        self._edge(m, holder, ev.name, ev.line)
                if ev.kind == "self_call" and h_lex:
                    for b in acquires.get(ev.name, ()):
                        for holder in h_lex:
                            self._edge(m, holder, b, ev.line)
                if ev.kind == "other_call" and h_lex:
                    other = self.u.resolve_foreign_method(ev.name, c)
                    if other is not None:
                        oacq = self._acquires(other)
                        locks = oacq.get(ev.name, frozenset())
                        for b in locks:
                            for holder in h_lex:
                                self._edge(m, holder, b, ev.line)

            # C305: non-daemon threads with no join path
            for sp in fn.spawns:
                if sp.daemon is True or (
                    sp.var is not None and sp.var in fn.daemonized_vars
                ):
                    continue
                joined = (
                    (sp.var is not None and sp.var in fn.joined_vars)
                    or (sp.attr is not None and sp.attr in c.joined_attrs)
                )
                if not joined:
                    self._emit(
                        m, "C305", Severity.WARNING,
                        "non-daemon thread with no join path — interpreter "
                        "shutdown blocks on it forever if its loop never "
                        "exits",
                        sp.line, layer=f"{c.name}.{mname}",
                        hint="daemon=True for best-effort workers, or keep "
                        "a handle and join() it on close/stop",
                    )

    def _maybe_c306(self, m: _ModuleInfo, c: Optional[_ClassInfo],
                    fn: _FnInfo, ev: _Event, mname: str) -> None:
        injectable = fn.params & _SLEEP_INJECTABLES
        if not injectable and c is not None:
            injectable = c.init_params & _SLEEP_INJECTABLES
        if injectable:
            return
        where = f"{c.name}.{mname}" if c is not None else mname
        self._emit(
            m, "C306", Severity.WARNING,
            "time.sleep polling loop with no injectable clock — tests "
            "must burn wall time to drive it (the LeaseFile "
            "clock=/sleep= discipline)",
            ev.line, layer=where,
            hint="accept sleep=time.sleep (and clock=time.time if "
            "deadlines are involved) and call the injected hooks",
        )

    # -- module level ----------------------------------------------------
    def lint_module_functions(self, m: _ModuleInfo) -> None:
        # module pseudo-class: module-level locks guard `global` writes
        guards: Dict[str, Set[str]] = {}
        for fn in m.functions.values():
            for ev in fn.events:
                if ev.kind == "gwrite" and ev.held:
                    guards.setdefault(ev.name, set()).update(ev.held)
        for fname, fn in m.functions.items():
            for ev in fn.events:
                if ev.kind == "gwrite" and ev.name in guards:
                    if not (ev.held & guards[ev.name]):
                        self._emit(
                            m, "C301", Severity.ERROR,
                            f"module global {ev.name!r} written without "
                            f"{_fmt_locks(guards[ev.name])}, but other "
                            "writes hold it",
                            ev.line, layer=fname,
                            hint="take the module lock around this write",
                        )
                elif ev.kind in ("blocking", "sleep", "wait") and ev.held:
                    self._emit(
                        m, "C304", Severity.WARNING,
                        f"blocking call {ev.name} while holding "
                        f"{_fmt_locks(ev.held)}",
                        ev.line, layer=fname,
                        hint="move the blocking op outside the critical "
                        "section, or annotate: # lock: allow[C304] <why>",
                    )
                if ev.kind == "sleep" and ev.in_loop:
                    self._maybe_c306(m, None, fn, ev, fname)
                if ev.kind == "wait" and ev.in_loop and ev.detail == "event":
                    self._emit(
                        m, "C305", Severity.WARNING,
                        f"no-timeout Event.wait on {ev.name!r} inside a loop",
                        ev.line, layer=fname,
                        hint="wait(timeout) and re-check the stop condition",
                    )
                if ev.kind == "acquire":
                    for holder in ev.held:
                        self._edge(m, holder, ev.name, ev.line)
            for sp in fn.spawns:
                if sp.daemon is True or (
                    sp.var is not None and sp.var in fn.daemonized_vars
                ):
                    continue
                if sp.var is not None and sp.var in fn.joined_vars:
                    continue
                self._emit(
                    m, "C305", Severity.WARNING,
                    "non-daemon thread with no join path",
                    sp.line, layer=fname,
                    hint="daemon=True for best-effort workers, or keep a "
                    "handle and join() it",
                )

    def check_unused_pragmas(self, modules) -> None:
        """A pragma that suppressed nothing is a stale annotation — the
        hold it justified moved or stopped being blocking.  Reported as
        C300 (the shared stale-pragma discipline, analysis.pragmas) so
        the allowlist stays an honest record of intentional holds."""
        for m in modules:
            table = {
                line: _pragmas.Pragma(line, frozenset(rules_), just)
                for line, (rules_, just) in m.pragmas.items()
            }
            self.diags.extend(_pragmas.stale_findings(
                table, m.pragma_used, "lock", m.relpath,
            ))

    # -- C303 cycle check (package-wide) ---------------------------------
    def check_cycles(self) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        seen: Set[str] = set()
        reported: Set[frozenset] = set()

        def dfs(node: str, stack: List[str], on_stack: Set[str]) -> None:
            seen.add(node)
            stack.append(node)
            on_stack.add(node)
            for nxt in sorted(graph.get(node, ())):
                if nxt in on_stack:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        self._report_cycle(cycle)
                elif nxt not in seen:
                    dfs(nxt, stack, on_stack)
            stack.pop()
            on_stack.discard(node)

        for node in sorted(graph):
            if node not in seen:
                dfs(node, [], set())

    def _report_cycle(self, cycle: List[str]) -> None:
        sites = []
        for a, b in zip(cycle, cycle[1:]):
            where = self.edges.get((a, b))
            if where:
                sites.append(f"{a} -> {b} at {where[0]}:{where[1]}")
        first = self.edges.get((cycle[0], cycle[1]), ("", 0))
        self.diags.append(Diagnostic(
            rule="C303", severity=Severity.ERROR,
            message="static lock-order inversion: "
            + " -> ".join(cycle) + " (" + "; ".join(sites) + ")",
            source=first[0] or None, line=first[1] or None,
            hint="pick one global order for these locks and acquire them "
            "in it everywhere (or collapse them into one lock)",
        ))


def _fmt_locks(locks) -> str:
    names = sorted(locks)
    if len(names) == 1:
        return f"lock {names[0]!r}"
    return "any of {" + ", ".join(repr(n) for n in names) + "}"


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _parse_module(path: str, base: str) -> Tuple[Optional[_ModuleInfo],
                                                 Optional[ast.Module],
                                                 List[Diagnostic]]:
    relpath = os.path.relpath(path, base) if base else path
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return None, None, [Diagnostic(
            rule="C300", severity=Severity.ERROR,
            message=f"syntax error: {e.msg}", source=relpath, line=e.lineno,
        )]
    info = _declared(tree, _module_name(path, base or os.path.dirname(path)),
                     relpath)
    diags: List[Diagnostic] = []
    _collect_pragmas(src, relpath, diags, info)
    return info, tree, diags


def _analyze_bodies(universe: _Universe, info: _ModuleInfo,
                    tree: ast.Module) -> None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            c = info.classes[node.name]
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                fn = _FnInfo(
                    name=item.name,
                    params={a.arg for a in item.args.args}
                    | {a.arg for a in item.args.kwonlyargs},
                    is_thread_entry=item.name in c.thread_entries,
                )
                c.methods[item.name] = fn
                _FnScanner(universe, info, c, fn,
                           qual=f"{node.name}.{item.name}").scan(item)
                for sp in fn.spawns:
                    if sp.target is not None and sp.target.startswith("self."):
                        c.thread_entries.add(sp.target[len("self."):])
            # spawn var/attr binding: `t = Thread(...)` / `self.x = Thread(...)`
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = c.methods[item.name]
                    _bind_spawn_vars(item, fn)
            # entry flags may have arrived after scanning (Timer in a later
            # method): re-mark
            for mname in c.thread_entries:
                if mname in c.methods:
                    c.methods[mname].is_thread_entry = True
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = _FnInfo(
                name=node.name,
                params={a.arg for a in node.args.args}
                | {a.arg for a in node.args.kwonlyargs},
            )
            info.functions[node.name] = fn
            _FnScanner(universe, info, None, fn, qual=node.name).scan(node)
            _bind_spawn_vars(node, fn)


def _bind_spawn_vars(fn_node: ast.AST, fn: _FnInfo) -> None:
    """Attach `t = Thread(...)` / `self.x = Thread(...)` bindings to the
    recorded spawns (by line) for the C305 join-path check."""
    for sub in ast.walk(fn_node):
        if not isinstance(sub, ast.Assign) or not isinstance(sub.value, ast.Call):
            continue
        d = _dotted(sub.value.func) or ""
        if d.rpartition(".")[2] not in _THREAD_CTORS:
            continue
        var = attr = None
        for t in sub.targets:
            if isinstance(t, ast.Name):
                var = t.id
            else:
                f = _self_field(t)
                if f is not None:
                    attr = f.attr
        for sp in fn.spawns:
            if sp.line == sub.value.lineno:
                sp.var = sp.var or var
                sp.attr = sp.attr or attr
        # `self.attr = t` later in the function also binds the attr
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Name):
            f = _self_field(sub.targets[0]) if sub.targets else None
            if f is not None:
                for sp in fn.spawns:
                    if sp.var == sub.value.id and sp.attr is None:
                        sp.attr = f.attr


def _lint_files(paths: Sequence[str], base: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    parsed: List[Tuple[_ModuleInfo, ast.Module]] = []
    for path in paths:
        info, tree, file_diags = _parse_module(path, base)
        diags.extend(file_diags)
        if info is not None and tree is not None:
            parsed.append((info, tree))
    universe = _Universe([info for info, _ in parsed])
    for info, tree in parsed:
        _analyze_bodies(universe, info, tree)
    linter = _Linter(universe)
    for info, _ in parsed:
        for c in info.classes.values():
            linter.lint_class(info, c)
        linter.lint_module_functions(info)
    linter.check_cycles()
    linter.check_unused_pragmas([info for info, _ in parsed])
    diags.extend(linter.diags)
    return diags


def lint_concurrency_file(path: str, root: Optional[str] = None) -> List[Diagnostic]:
    """All C-rules over one source file (cross-class resolution limited to
    the classes that file defines) — the mutation-test entry point."""
    base = root or os.path.dirname(os.path.abspath(path))
    return _lint_files([os.path.abspath(path)], base)


def lint_concurrency_package(root: Optional[str] = None,
                             extra_paths: Optional[List[str]] = None
                             ) -> List[Diagnostic]:
    """Every C-rule over the paddle_tpu_torch package tree (plus
    ``extra_paths``) — the ``python -m paddle_tpu_torch lint --concurrency``
    body.  The package root comes from this file's path: importing the
    package would import torch."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.dirname(root)
    files: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files.extend(
            os.path.join(dirpath, fn) for fn in sorted(filenames)
            if fn.endswith(".py")
        )
    return _lint_files(sorted(files) + list(extra_paths or ()), base)
