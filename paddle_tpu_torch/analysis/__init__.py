"""Static analysis of the PyTorch/CUDA port (see paddle_tpu_torch/__init__.py)
— the counterpart of ``paddle_tpu/analysis``, with its ported passes:

  * :mod:`~paddle_tpu_torch.analysis.diagnostics` — the shared diagnostic
    model (rule id, severity, layer/file provenance, fix hint);
  * :mod:`~paddle_tpu_torch.analysis.graph_lint` — abstract shape/arity
    propagation over the Topology IR before anything runs (rules ``G###``;
    ``python -m paddle_tpu_torch lint --config``);
  * :mod:`~paddle_tpu_torch.analysis.lock_sanitizer` — instrumented locks
    that detect lock-order cycles at run time.

The JAX package's other passes (the AST self-lint, the jaxpr, concurrency,
protocol and numerics lints, the interleaving explorer) are not ported yet
(ROADMAP Queue 1 item 7).

Submodules import lazily (PEP 562): ``graph_lint`` pulls torch and the
core IR, which the torch-free consumers of ``lock_sanitizer`` and
``diagnostics`` (master.py) must not pay for.
"""

import importlib
from typing import List

# public name -> defining submodule (resolved on first attribute access)
_EXPORTS = {
    "Diagnostic": "diagnostics",
    "DiagnosticError": "diagnostics",
    "ProtocolError": "diagnostics",
    "protocol_error": "diagnostics",
    "Severity": "diagnostics",
    "config_assert": "diagnostics",
    "errors": "diagnostics",
    "format_diagnostics": "diagnostics",
    "raise_if_errors": "diagnostics",
    "attr_key_universe": "graph_lint",
    "lint_parsed": "graph_lint",
    "lint_topology": "graph_lint",
    "DeadlockReport": "lock_sanitizer",
    "make_lock": "lock_sanitizer",
    "make_rlock": "lock_sanitizer",
    "sanitizer_enabled": "lock_sanitizer",
}

__all__: List[str] = sorted(_EXPORTS)


def __getattr__(name: str):
    mod_name = _EXPORTS.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    value = getattr(mod, name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
