"""Static analysis of the PyTorch/CUDA port (see paddle_tpu_torch/__init__.py)
— the counterpart of ``paddle_tpu/analysis``, with its ported passes:

  * :mod:`~paddle_tpu_torch.analysis.diagnostics` — the shared diagnostic
    model (rule id, severity, layer/file provenance, fix hint);
  * :mod:`~paddle_tpu_torch.analysis.graph_lint` — abstract shape/arity
    propagation over the Topology IR before anything runs (rules ``G###``;
    ``python -m paddle_tpu_torch lint --config``);
  * :mod:`~paddle_tpu_torch.analysis.ast_rules` — self-lint of the port's
    own source (rules ``A###``; ``python -m paddle_tpu_torch lint``);
  * :mod:`~paddle_tpu_torch.analysis.concurrency_lint` — lock-discipline
    lint over the port's threaded planes (rules ``C###``; ``lint
    --concurrency``);
  * :mod:`~paddle_tpu_torch.analysis.protocol_lint` — protocol conformance
    of the master, HA, journal, wire and serving-fleet surfaces (rules
    ``P###``; ``lint --protocol``);
  * :mod:`~paddle_tpu_torch.analysis.interleave` — the interleaving
    explorer over the real router, master and HA lease state machines
    (``python -m paddle_tpu_torch explore``);
  * :mod:`~paddle_tpu_torch.analysis.pragmas` — the ``# lock:/# proto:/
    # wire:/# obs:`` allowlist grammar those passes share;
  * :mod:`~paddle_tpu_torch.analysis.lock_sanitizer` — instrumented locks
    that detect lock-order cycles at run time.

The JAX package's jaxpr passes (``trace_lint``, ``numerics_lint`` and the
``num_sanitizer``) are not ported yet: their twins over the FX graph are
ROADMAP Queue 1 item 7d.

Submodules import lazily (PEP 562): ``graph_lint`` pulls torch and the
core IR, which the torch-free consumers of ``lock_sanitizer`` and
``diagnostics`` (master.py) must not pay for; the A/C/P passes and the
explorer's module import neither torch nor jax.
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
    "lint_file": "ast_rules",
    "lint_package": "ast_rules",
    "attr_key_universe": "graph_lint",
    "lint_parsed": "graph_lint",
    "lint_topology": "graph_lint",
    "lint_concurrency_file": "concurrency_lint",
    "lint_concurrency_package": "concurrency_lint",
    "lint_protocol_package": "protocol_lint",
    "lint_protocol_sources": "protocol_lint",
    "explore_schedules": "interleave",
    "replay_spec": "interleave",
    "shrink_events": "interleave",
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
