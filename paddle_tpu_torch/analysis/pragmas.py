"""Shared allowlist-pragma parser — ONE tokenizer for every lint plane;
the counterpart of ``paddle_tpu/analysis/pragmas.py`` (same grammar, same
findings), imported by the port's self-lint, concurrency and protocol
passes.

The analysis planes grew line-anchored escape hatches independently:
the C-rules' ``# lock: allow[C304] <why>`` (concurrency_lint), the
numerics plane's ``# num: allow[N403] <why>`` (numerics_lint), the
traced-step plane's ``# trace: allow[T103] <why>`` (trace_lint; the port's
own: the JAX package's trace lint has no pragmas), and the A205
wall-clock escape ``# obs: allow-wall-clock <why>`` (ast_rules).
They share one discipline — a pragma is a COMMENT token (never a string
literal showing the syntax), it names the rules it suppresses, and its
justification string is REQUIRED — so they share one parser.

Per plane the grammar differs only in spelling:

    # lock: allow[C304,C306] why      rules come from the bracket list
    # num: allow[N401] why            same grammar, N-rule namespace
    # wire: allow[A206] why           same grammar, the raw-deserialization
                                      ban (ast_rules A206)
    # proto: allow[P504] why          same grammar, the protocol
                                      conformance plane (protocol_lint)
    # trace: allow[T103] why          same grammar, the traced-step
                                      hazards (trace_lint)
    # obs: allow-wall-clock why       keyword form; always rule A205

``collect`` returns ``{line: Pragma}`` plus uniform findings for
malformed pragmas (empty rule list / empty justification) under the
plane's bookkeeping rule id; ``stale_findings`` reports pragmas that
suppressed nothing — the annotated hazard moved or stopped firing — so
every plane's allowlist stays an honest record of intentional hazards.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = ["Pragma", "collect", "comment_tokens", "stale_findings", "PLANES"]


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One parsed allowlist annotation: the rules it suppresses on its
    line and the (non-empty) justification its author supplied."""

    line: int
    rules: frozenset
    justification: str

    def suppresses(self, rule: str) -> bool:
        return rule in self.rules


@dataclasses.dataclass(frozen=True)
class _Plane:
    name: str                      # comment prefix: "# <name>: ..."
    pattern: re.Pattern            # groups: (rules-or-None, justification)
    fixed_rules: Optional[frozenset]  # keyword planes map to one rule set
    bookkeeping_rule: str          # id for empty/stale pragma findings
    example: str                   # fix-hint template


def _allow_plane(name: str, bookkeeping_rule: str, example_rule: str) -> _Plane:
    return _Plane(
        name=name,
        pattern=re.compile(
            r"#\s*" + name + r":\s*allow\[([A-Z0-9, ]*)\]\s*(.*)$"
        ),
        fixed_rules=None,
        bookkeeping_rule=bookkeeping_rule,
        example=f"# {name}: allow[{example_rule}] <why this is intentional>",
    )


PLANES: Dict[str, _Plane] = {
    "lock": _allow_plane("lock", "C300", "C304"),
    "num": _allow_plane("num", "N400", "N403"),
    "wire": _allow_plane("wire", "A206", "A206"),
    "proto": _allow_plane("proto", "P500", "P504"),
    "trace": _allow_plane("trace", "T107", "T103"),
    "obs": _Plane(
        name="obs",
        pattern=re.compile(r"#\s*obs:\s*allow-wall-clock\s*(())?(.*)$"),
        fixed_rules=frozenset({"A205"}),
        bookkeeping_rule="A205",
        example="# obs: allow-wall-clock <why this wall read can never "
        "stamp a span>",
    ),
}


def comment_tokens(src: str) -> List[Tuple[int, str]]:
    """``(line, text)`` for every COMMENT token in ``src`` — a pragma
    spelled inside a string literal (a docstring showing the syntax, a
    fix-hint template) is documentation, not an annotation.  An
    unparseable tail returns the comments seen so far (the AST pass
    reports the syntax error on its own)."""
    comments: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return comments


def collect(
    src: str,
    plane: str,
    relpath: str,
    diags: Optional[List[Diagnostic]] = None,
) -> Dict[int, Pragma]:
    """Parse every ``plane`` pragma in ``src``.  Malformed pragmas (empty
    rule list or empty justification) append a finding to ``diags`` under
    the plane's bookkeeping rule and are NOT returned — a rejected pragma
    must never suppress the hazard it annotates."""
    spec = PLANES[plane]
    out: Dict[int, Pragma] = {}
    for line, comment in comment_tokens(src):
        m = spec.pattern.search(comment)
        if not m:
            continue
        if spec.fixed_rules is not None:
            rules: Set[str] = set(spec.fixed_rules)
            justification = (m.group(3) or "").strip()
        else:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            justification = (m.group(2) or "").strip()
        if not rules or not justification:
            if diags is not None:
                diags.append(Diagnostic(
                    rule=spec.bookkeeping_rule, severity=Severity.ERROR,
                    message=f"empty `# {spec.name}:` allowlist pragma "
                    "without a justification string (every intentional "
                    "hazard must say WHY)",
                    source=relpath, line=line,
                    hint=spec.example,
                ))
            continue
        out[line] = Pragma(line=line, rules=frozenset(rules),
                           justification=justification)
    return out


def stale_findings(
    pragmas: Dict[int, Pragma],
    used_lines: Iterable[int],
    plane: str,
    relpath: str,
    severity: Severity = Severity.WARNING,
) -> List[Diagnostic]:
    """A pragma that suppressed nothing is a stale annotation — the
    hazard it justified moved or stopped firing.  Reported under the
    plane's bookkeeping rule so the allowlist stays honest."""
    spec = PLANES[plane]
    used = set(used_lines)
    out: List[Diagnostic] = []
    for line in sorted(pragmas):
        if line in used:
            continue
        p = pragmas[line]
        out.append(Diagnostic(
            rule=spec.bookkeeping_rule, severity=severity,
            message=f"unused `# {spec.name}:` allowlist pragma "
            f"allow[{','.join(sorted(p.rules))}] — no finding on this "
            "line is suppressed by it (stale annotation)",
            source=relpath, line=line,
            hint="delete the pragma, or re-anchor it on the line that "
            "actually needs the exemption",
        ))
    return out
