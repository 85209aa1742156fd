"""The diagnostic record the port's error paths raise — a small copy of
``paddle_tpu/analysis/diagnostics.py`` (rule id, severity, layer provenance,
fix hint), kept to what the topology, the compiler and the serving and RPC
planes use (``ProtocolError`` and its helpers)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, List, Optional, Sequence


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    rule: str
    severity: Severity
    message: str
    layer: Optional[str] = None
    source: Optional[str] = None
    line: Optional[int] = None
    hint: Optional[str] = None

    def format(self) -> str:
        head = f"{self.severity}[{self.rule}]"
        if self.layer is not None:
            head += f" layer {self.layer!r}"
        out = f"{head}: {self.message}"
        if self.source:
            out += f"\n    --> {self.source}" + (f":{self.line}" if self.line else "")
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    if not diags:
        return "no diagnostics"
    ordered = sorted(diags, key=lambda d: (-int(d.severity), d.rule))
    lines = [d.format() for d in ordered]
    n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
    n_warn = sum(1 for d in diags if d.severity == Severity.WARNING)
    lines.append(f"{len(diags)} diagnostic(s): {n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)


class DiagnosticError(ValueError):
    """A ValueError carrying structured diagnostics."""

    def __init__(self, diagnostics):
        if isinstance(diagnostics, Diagnostic):
            diagnostics = [diagnostics]
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        super().__init__(format_diagnostics(self.diagnostics))

    @property
    def rules(self) -> List[str]:
        return [d.rule for d in self.diagnostics]


class ProtocolError(DiagnosticError, RuntimeError):
    """A distributed-protocol misuse (P-rule namespace): calling into a
    closed client, violating a lifecycle contract, breaking a lease or
    fence invariant at runtime.  It is a RuntimeError too, so an ``except
    RuntimeError`` handler of the serving and RPC planes still catches it
    (and DiagnosticError keeps ``except ValueError`` consumers working)."""


def protocol_error(rule: str, message: str, *, source: Optional[str] = None,
                   hint: Optional[str] = None) -> ProtocolError:
    """A single-finding :class:`ProtocolError` (the raise-site shorthand of
    the serving and wire planes)."""
    return ProtocolError(Diagnostic(rule=rule, severity=Severity.ERROR, message=message,
                                    source=source, hint=hint))


def config_assert(cond: bool, rule: str, message: str, *, layer: Optional[str] = None,
                  source: Optional[str] = None, hint: Optional[str] = None) -> None:
    """The reference's ``config_assert`` (config_parser.py:178): raise a
    :class:`DiagnosticError` with full provenance when ``cond`` is false."""
    if not cond:
        raise DiagnosticError(Diagnostic(rule=rule, severity=Severity.ERROR, message=message,
                                         layer=layer, source=source, hint=hint))


def errors(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == Severity.ERROR]


def raise_if_errors(diags: Sequence[Diagnostic]) -> None:
    """Raise :class:`DiagnosticError` when any ERROR-severity finding is
    present; warnings and info never raise."""
    errs = errors(diags)
    if errs:
        raise DiagnosticError(errs)
