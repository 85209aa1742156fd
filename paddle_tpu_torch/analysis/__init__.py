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
  * :mod:`~paddle_tpu_torch.analysis.trace_lint` — one traced train step
    as an FX graph (``make_fx``; the flash kernels are custom-op nodes) and
    its hazards (rules ``T###``; ``lint --donation``);
  * :mod:`~paddle_tpu_torch.analysis.numerics_lint` — precision-flow lint
    over that graph and the precision certificate (rules ``N###``; ``lint
    --numerics [--certify]``);
  * :mod:`~paddle_tpu_torch.analysis.num_sanitizer` — the runtime leg: a
    skipped step re-executed node by node to name its first non-finite op
    (the ``num_sanitizer`` flag);
  * :mod:`~paddle_tpu_torch.analysis.pragmas` — the ``# lock:/# proto:/
    # wire:/# obs:/# num:/# trace:`` allowlist grammar those passes share;
  * :mod:`~paddle_tpu_torch.analysis.lock_sanitizer` — instrumented locks
    that detect lock-order cycles at run time.

Submodules import lazily (PEP 562): ``graph_lint`` and the traced-step
passes pull torch and the core IR, which the torch-free consumers of
``lock_sanitizer`` and ``diagnostics`` (master.py) must not pay for; the A/C/P passes and the
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
    "donation_audit": "trace_lint",
    "lint_graph": "trace_lint",
    "lint_jaxpr": "trace_lint",
    "lint_step": "trace_lint",
    "recompile_audit": "trace_lint",
    "trace_step": "trace_lint",
    "PrecisionCertificate": "numerics_lint",
    "certify_precision_plan": "numerics_lint",
    "lint_numerics_config": "numerics_lint",
    "lint_numerics_graph": "numerics_lint",
    "lint_numerics_jaxpr": "numerics_lint",
    "lint_numerics_package": "numerics_lint",
    "lint_numerics_step": "numerics_lint",
    "NumericsSanitizer": "num_sanitizer",
    "find_first_nonfinite": "num_sanitizer",
    "num_sanitizer_armed": "num_sanitizer",
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
