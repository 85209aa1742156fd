"""The port's protocol conformance lint (paddle_tpu_torch/analysis/
protocol_lint.py) against the JAX package's on the CPU.

* Every mutation of ``tests/test_protocol_lint.py`` (each ``(file, old,
  new)`` it hands its ``_mutated`` helper, read from that file) is applied
  to the port's own protocol sources, and the same mutated text goes
  through both packages' ``lint_protocol_sources``: the ``(rule, severity,
  line)`` lists must be equal, and a fixture named after a P-rule must make
  that rule fire in the port.
* The gate: the port's unmutated sources, and ``lint_protocol_package``,
  lint clean through both packages.
"""

import os
import re

import pytest

from paddle_tpu.analysis import protocol_lint as jpl
from paddle_tpu_torch.analysis import format_diagnostics
from paddle_tpu_torch.analysis import protocol_lint as tpl
from test_torch_self_lint import PORT, jax_test_fixtures

_CASES = jax_test_fixtures("test_protocol_lint.py", "_mutated")


def _sources():
    out = {}
    for rel in tpl.PROTOCOL_FILES:
        with open(os.path.join(PORT, *rel.split("/")), encoding="utf-8") as f:
            out[rel] = f.read()
    return out


def _key(diags):
    return [(d.rule, str(d.severity), d.source, d.line) for d in diags]


def test_every_mutation_of_the_jax_protocol_lint_is_taken():
    # one mutation in each of its 10 fixture tests; a test added there joins
    assert len(_CASES) >= 10
    assert jpl.PROTOCOL_FILES == tpl.PROTOCOL_FILES


@pytest.mark.parametrize("rel, old, new", _CASES)
def test_mutation_findings_equal_the_jax_package(request, rel, old, new):
    srcs = _sources()
    before = srcs[rel]
    srcs[rel] = before.replace(old, new, 1)
    assert srcs[rel] != before, f"mutation anchor {old!r} not found in the port's {rel}"
    want = jpl.lint_protocol_sources(srcs)
    got = tpl.lint_protocol_sources(srcs)
    assert _key(got) == _key(want), (format_diagnostics(got), format_diagnostics(want))
    named = re.match(r"test_(p50\d)_", request.node.callspec.id)
    if named:
        assert named.group(1).upper() in {d.rule for d in got}, format_diagnostics(got)


def test_the_port_protocol_surfaces_lint_clean_in_both_packages():
    assert jpl.lint_protocol_sources(_sources()) == []
    diags = tpl.lint_protocol_package()
    assert diags == [], format_diagnostics(diags)
