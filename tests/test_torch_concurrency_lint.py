"""The port's lock-discipline lint (paddle_tpu_torch/analysis/
concurrency_lint.py) against the JAX package's on the CPU.

* Every mutation fixture of ``tests/test_concurrency_lint.py`` (each source
  text it hands its ``_lint_src`` helper, read from that file) goes through
  both packages' ``lint_concurrency_file`` at the same path: the ``(rule,
  severity, line)`` lists must be equal.
* The port's tree with every ``# lock:`` pragma stripped from its comments,
  linted by both packages' ``lint_concurrency_package``: equal ``(rule,
  relpath, line)`` sets that hold ``cmd_master``'s supervision sleep (C306,
  ``cli.py``) and the journal fsync under the ledger lock (C304,
  ``serving/router.py``).
* The gate: the port's tree lints clean.
"""

import os
import textwrap

import pytest

from paddle_tpu.analysis import concurrency_lint as jcl
from paddle_tpu_torch.analysis import concurrency_lint as tcl
from paddle_tpu_torch.analysis import format_diagnostics
from test_torch_self_lint import PORT, jax_test_fixtures, stripped_copy

_CASES = jax_test_fixtures("test_concurrency_lint.py", "_lint_src")


def _key(diags):
    return [(d.rule, str(d.severity), d.line) for d in diags]


def _line_of(rel, needle):
    with open(os.path.join(PORT, *rel.split("/")), encoding="utf-8") as f:
        hits = [i for i, line in enumerate(f, 1) if needle in line]
    assert len(hits) == 1, (rel, needle, hits)
    return hits[0]


def test_every_fixture_of_the_jax_concurrency_lint_is_taken():
    # one call in each of its 30 fixture tests; a test added there joins
    assert len(_CASES) >= 30
    assert {"test_c303_abba_cycle_across_classes", "test_c300_unused_pragma_is_reported",
            "test_pragma_inside_string_literal_is_documentation"} <= {p.id for p in _CASES}


@pytest.mark.parametrize("src", _CASES)
def test_fixture_findings_equal_the_jax_package(tmp_path, src):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(src))
    want = jcl.lint_concurrency_file(str(path), root=str(tmp_path))
    got = tcl.lint_concurrency_file(str(path), root=str(tmp_path))
    assert _key(got) == _key(want), (format_diagnostics(got), format_diagnostics(want))


def test_the_port_without_its_lock_pragmas_lints_as_in_the_jax_package(tmp_path):
    root = stripped_copy(tmp_path, ("lock",))
    sets = [{(d.rule, d.source, d.line) for d in mod.lint_concurrency_package(root=root)}
            for mod in (jcl, tcl)]
    assert sets[1] == sets[0]
    sites = {("C306", os.path.join("paddle_tpu_torch", "cli.py"),
              _line_of("cli.py", "time.sleep(0.2)  # lock: allow[C306]")),
             ("C304", os.path.join("paddle_tpu_torch", "serving", "router.py"),
              _line_of("serving/router.py", "os.fsync(self._jfile.fileno())"))}
    assert sites <= sets[1], sorted(sets[1])


def test_the_port_concurrency_lint_is_clean():
    diags = tcl.lint_concurrency_package()
    assert diags == [], format_diagnostics(diags)
