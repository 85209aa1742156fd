"""Self-lint: custom AST rules over the port's own source — the
counterpart of ``paddle_tpu/analysis/ast_rules.py`` (same rule ids, same
findings on the same source), run over ``paddle_tpu_torch``.

The graph linter checks the user's model; these rules check *us* — the
host-side Python that feeds, drives and serves the network — for repo
invariants the runtime can't check early.

Rules (``A###``):

  A203 unseeded-reader-rng  direct global-module ``random.X(...)`` /
                          ``np.random.X(...)`` sampling in reader/dataset
                          modules — reader order becomes irreproducible and
                          immune to the ``seed`` flag (thread an explicit
                          ``rng`` / ``random.Random(seed)``)
  A204 duplicate-flag     the same flag name registered twice via
                          ``define_flag`` (the loser silently wins; see
                          utils/flags.py re-registration guard)
  A205 wall-clock-in-obs  ``time.time()``/``time.time_ns()`` in an
                          ``obs/`` module — span timestamps must come
                          from the MONOTONIC, injectable tracer clock
                          (an NTP step would fold a timeline backward).
                          The one legitimate wall read (the merge
                          anchor) carries the pragma
                          ``# obs: allow-wall-clock <why>`` with a
                          REQUIRED justification.
  A206 raw-deserialization  ``pickle.load``/``pickle.loads``/
                          ``pickle.Unpickler`` or a bare zero-argument
                          ``.recv()`` (the ``multiprocessing.connection``
                          implicit-unpickle read) ANYWHERE outside
                          ``master_wire.py`` — unpickling executes
                          attacker-controlled bytes, and the RPC plane's
                          whole safety story is that every byte crossing a
                          process boundary rides the restricted typed
                          codec instead.  Genuinely-local, never-network
                          reads (a CRC-verified AOT cache blob, an
                          operator-written dataset file) escape with
                          ``# wire: allow[A206] <why>`` — justification
                          REQUIRED, stale pragmas flagged (the shared
                          analysis.pragmas discipline).

The JAX package's A201 (``time.time()``-family calls inside a ``jax.jit``
body) and A202 (host ``random``/``np.random`` sampling inside one) are not
ported: their subject is a function traced once and replayed, and the
port traces nothing — it runs eagerly, with no ``torch.compile`` and no
CUDA graph.

Run via :func:`lint_package` (``python -m paddle_tpu_torch lint``).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

# numpy/np-module RNG samplers + `random` module samplers; seeding calls and
# generator constructors are fine (they are how you FIX the finding)
_RNG_OK = frozenset({"RandomState", "default_rng", "Random", "seed", "SeedSequence"})

# reader-plane modules for A203 (package-relative path prefixes)
_READER_PREFIXES = ("reader" + os.sep, "dataset" + os.sep)

# the wall-clock time.* calls A205 forbids in obs/ modules (monotonic /
# perf_counter are exactly what spans SHOULD use, so they stay legal)
_WALL_FNS = frozenset({"time", "time_ns"})

# the pickle entry points that EXECUTE payload bytes (A206); dumps/dump
# only serialize and stay legal
_PICKLE_LOADS = frozenset({"load", "loads", "Unpickler"})
_PICKLE_MODULES = frozenset({"pickle", "cPickle", "_pickle", "dill"})


def _name_of(node: ast.AST) -> Optional[str]:
    """Dotted name of an expression like ``np.random.rand`` -> that string."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _host_rng_heads(tree: ast.Module) -> Set[str]:
    """Dotted-name heads that denote HOST RNG modules in this file.  Only
    an actual ``import random`` binds the bare name ``random`` to the
    stdlib module — ``from torch import random`` (or ``from jax import
    random``) binds another namespace to the same name and must NOT flag."""
    heads: Set[str] = {"np.random", "numpy.random"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random":
                    heads.add(a.asname or "random")
                elif a.name == "numpy.random":
                    heads.add(a.asname or "numpy.random")
    return heads


def _scan_reader_rng(tree: ast.Module, relpath: str,
                     diags: List[Diagnostic], rng_heads: Set[str]) -> None:
    # `import random as _random` aliases resolve; `from torch import random`
    # does not flag (the _host_rng_heads resolution)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _name_of(node.func)
        if dotted is None:
            continue
        head, _, tail = dotted.rpartition(".")
        if head in rng_heads and tail not in _RNG_OK:
            diags.append(Diagnostic(
                rule="A203", severity=Severity.ERROR,
                message=f"global-RNG call `{dotted}(...)` in reader module "
                "— sample order is irreproducible and ignores the `seed` "
                "flag",
                source=relpath, line=node.lineno,
                hint="accept an explicit `rng` (random.Random/np.random."
                "RandomState seeded from the seed flag) and sample from it",
            ))


def _scan_obs_wall_clock(tree: ast.Module, src: str, relpath: str,
                         diags: List[Diagnostic]) -> None:
    """A205 over one obs/ module: wall-clock calls are forbidden unless
    the LINE carries ``# obs: allow-wall-clock <justification>``.  The
    pragma parses through the shared plane parser (analysis.pragmas) —
    comment tokens only, empty justification is its own finding, and a
    stale pragma (suppressing nothing) reports uniformly with the
    ``# lock:``/``# num:`` planes.  Alias-aware like the RNG rules:
    ``import time as t; t.time()`` and ``from time import time`` must
    not slip past the ban."""
    from paddle_tpu_torch.analysis import pragmas as _pragmas

    time_mods = {"time"}
    bare_wall: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    time_mods.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _WALL_FNS:
                    bare_wall.add(a.asname or a.name)
    pragma_diags: List[Diagnostic] = []
    table = _pragmas.collect(src, "obs", relpath, pragma_diags)
    diags.extend(pragma_diags)
    # a malformed (empty-why) pragma already reported above — the wall
    # read on its line must not double-report, but is NOT suppressed
    # either in the sense that the pragma finding keeps the lint red
    malformed = {d.line for d in pragma_diags if d.line is not None}
    used: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _name_of(node.func)
        if dotted is None:
            continue
        head, _, tail = dotted.rpartition(".")
        if not (
            (head in time_mods and tail in _WALL_FNS)
            or (head == "" and tail in bare_wall)
        ):
            continue
        if node.lineno in table:
            used.add(node.lineno)
            continue
        if node.lineno in malformed:
            continue
        diags.append(Diagnostic(
            rule="A205", severity=Severity.ERROR,
            message=f"wall-clock `{dotted}()` in an obs/ module — span "
            "timestamps must be monotonic (an NTP step folds the "
            "timeline backward)",
            source=relpath, line=node.lineno,
            hint="use the tracer's injectable monotonic clock; a "
            "genuinely-needed wall read (merge anchor) takes "
            "`# obs: allow-wall-clock <why>`",
        ))
    diags.extend(_pragmas.stale_findings(table, used, "obs", relpath))


def _scan_wire_hygiene(tree: ast.Module, src: str, relpath: str,
                       diags: List[Diagnostic]) -> None:
    """A206 over one module: raw deserialization outside master_wire.py.

    Alias-aware for the pickle module (``import pickle as p``,
    ``from pickle import loads``); the bare ``.recv()`` check keys on the
    ZERO-argument signature — ``socket.recv(bufsize)`` reads bytes (legal
    everywhere), ``Connection.recv()`` unpickles (the hazard)."""
    from paddle_tpu_torch.analysis import pragmas as _pragmas

    if os.path.basename(relpath) == "master_wire.py":
        return  # the codec is the one legitimate home of deserialization
    mods: Set[str] = set()
    bare: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in _PICKLE_MODULES:
                    mods.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module in _PICKLE_MODULES:
            for a in node.names:
                if a.name in _PICKLE_LOADS:
                    bare[a.asname or a.name] = f"{node.module}.{a.name}"
    pragma_diags: List[Diagnostic] = []
    table = _pragmas.collect(src, "wire", relpath, pragma_diags)
    diags.extend(pragma_diags)
    malformed = {d.line for d in pragma_diags if d.line is not None}
    used: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        hit: Optional[str] = None
        dotted = _name_of(node.func)
        if dotted is not None:
            head, _, tail = dotted.rpartition(".")
            if head in mods and tail in _PICKLE_LOADS:
                hit = f"`{dotted}(...)` executes payload bytes to deserialize"
            elif head == "" and tail in bare:
                hit = (f"`{dotted}(...)` ({bare[tail]}) executes payload "
                       f"bytes to deserialize")
        if hit is None and (
            isinstance(node.func, ast.Attribute) and node.func.attr == "recv"
            and not node.args and not node.keywords
        ):
            hit = ("bare `.recv()` (Connection-style) implicitly unpickles "
                   "whatever the peer sent")
        if hit is None:
            continue
        pragma = table.get(node.lineno)
        if pragma is not None and pragma.suppresses("A206"):
            used.add(node.lineno)
            continue
        if node.lineno in malformed:
            continue  # the rejected pragma already keeps the lint red
        diags.append(Diagnostic(
            rule="A206", severity=Severity.ERROR,
            message=f"{hit} outside master_wire.py — raw deserialization "
            "of bytes you did not verify is forbidden on every plane "
            "(a corrupt or hostile frame must be a structured rejection, "
            "never an exec)",
            source=relpath, line=node.lineno,
            hint="route the bytes through paddle_tpu_torch.master_wire "
            "(encode_payload/decode_payload, send_msg/recv_msg); a "
            "genuinely-local, never-network read takes "
            "`# wire: allow[A206] <why>`",
        ))
    diags.extend(_pragmas.stale_findings(table, used, "wire", relpath))


def _scan_flag_defs(tree: ast.Module, relpath: str,
                    defs: Dict[str, Tuple[str, int]],
                    diags: List[Diagnostic]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _name_of(node.func)
        if dotted is None or dotted.split(".")[-1] != "define_flag":
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant):
            continue
        name = node.args[0].value
        if not isinstance(name, str):
            continue
        if name in defs:
            first_file, first_line = defs[name]
            diags.append(Diagnostic(
                rule="A204", severity=Severity.ERROR,
                message=f"flag {name!r} registered twice (first at "
                f"{first_file}:{first_line})",
                source=relpath, line=node.lineno,
                hint="reuse the existing flag or pick a distinct name; "
                "conflicting re-registration raises at import "
                "(utils.flags.define_flag)",
            ))
        else:
            defs[name] = (relpath, node.lineno)


def lint_file(path: str, root: Optional[str] = None,
              _flag_defs: Optional[Dict[str, Tuple[str, int]]] = None
              ) -> List[Diagnostic]:
    """All AST rules over one source file."""
    relpath = os.path.relpath(path, root) if root else path
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Diagnostic(
            rule="A200", severity=Severity.ERROR,
            message=f"syntax error: {e.msg}", source=relpath, line=e.lineno,
        )]
    diags: List[Diagnostic] = []
    rng_heads = _host_rng_heads(tree)
    if relpath.replace("paddle_tpu_torch" + os.sep, "", 1).startswith(
        _READER_PREFIXES
    ) or os.sep + "dataset" + os.sep in relpath or (
        os.sep + "reader" + os.sep in relpath
    ):
        _scan_reader_rng(tree, relpath, diags, rng_heads)
    if os.sep + "obs" + os.sep in relpath or relpath.replace(
        "paddle_tpu_torch" + os.sep, "", 1
    ).startswith("obs" + os.sep):
        _scan_obs_wall_clock(tree, src, relpath, diags)
    _scan_wire_hygiene(tree, src, relpath, diags)
    if _flag_defs is not None:
        _scan_flag_defs(tree, relpath, _flag_defs, diags)
    return diags


def lint_package(root: Optional[str] = None,
                 extra_paths: Optional[List[str]] = None) -> List[Diagnostic]:
    """Run every AST rule over the paddle_tpu_torch package tree (plus any
    ``extra_paths`` files, e.g. chip_smoke.py) — the ``python -m
    paddle_tpu_torch lint`` body.  The package root comes from this file's
    path: importing the package would import torch."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    diags: List[Diagnostic] = []
    flag_defs: Dict[str, Tuple[str, int]] = {}
    base = os.path.dirname(root)
    files: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files.extend(
            os.path.join(dirpath, fn) for fn in sorted(filenames)
            if fn.endswith(".py")
        )
    for path in sorted(files) + list(extra_paths or ()):
        diags.extend(lint_file(path, root=base, _flag_defs=flag_defs))
    return diags
