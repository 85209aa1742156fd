"""The port's self-lint (paddle_tpu_torch/analysis/ast_rules.py) against the
JAX package's (paddle_tpu/analysis/ast_rules.py) on the CPU.

* Every mutation fixture of ``tests/test_self_lint.py`` (each source text it
  hands its ``_lint_src`` helper, read from that file so that no case is
  left out) goes through both packages' ``lint_file`` at the same path: the
  ``(rule, severity, line)`` lists must be equal.  The JAX package's A201
  and A202 (time and host RNG inside a ``jax.jit`` body) are not ported —
  the port traces nothing — so they are dropped from the JAX side, and the
  port must report neither.
* The A204 fixture (one flag defined in two files) through both packages.
* The port's tree with every ``# wire:`` pragma stripped from its comments,
  linted by both packages' ``lint_package``: equal ``(rule, relpath, line)``
  sets that hold the four raw-``pickle`` sites the pragmas justify.
* The gate: the port's tree plus ``chip_smoke.py`` lints clean.

``jax_test_fixtures`` and ``stripped_copy`` are shared with the port's
concurrency and protocol lint tests, which import them by module name.
"""

import ast
import io
import os
import re
import textwrap
import tokenize

import pytest

from paddle_tpu.analysis import ast_rules as jast
from paddle_tpu_torch.analysis import ast_rules as tast
from paddle_tpu_torch.analysis import format_diagnostics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
_NOT_PORTED = ("A201", "A202")


def jax_test_fixtures(test_file, helper):
    """``pytest.param`` of the literal arguments of every call to ``helper``
    in a JAX test file of ``tests/``, one per call, named after the test
    that makes it (``test_x`` or ``test_x#2`` for its second call).  Calls
    whose arguments are not all literals (the ``tmp_path`` argument aside)
    are skipped."""
    with open(os.path.join(REPO, "tests", test_file), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name) and n.func.id == helper),
                       key=lambda n: (n.lineno, n.col_offset))
        for i, call in enumerate(calls):
            args = [a for a in call.args if not (isinstance(a, ast.Name) and a.id == "tmp_path")]
            if not all(isinstance(a, ast.Constant) for a in args):
                continue
            name = fn.name if i == 0 else f"{fn.name}#{i + 1}"
            out.append(pytest.param(*[a.value for a in args], id=name))
    return out


def stripped_copy(dst, planes):
    """Copy the port's ``.py`` files under ``dst/paddle_tpu_torch`` with every
    pragma comment of ``planes`` (e.g. ``("wire",)``) removed; returns the
    copy's package root.  Only comment tokens are cut: a pragma spelled in a
    string (a docstring showing the syntax) stays."""
    pat = re.compile(r"#\s*(?:%s):" % "|".join(planes))
    root = os.path.join(str(dst), "paddle_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                src = f.read()
            lines = src.split("\n")
            for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT and pat.match(tok.string):
                    row, col = tok.start
                    lines[row - 1] = lines[row - 1][:col].rstrip()
            out = os.path.join(root, os.path.relpath(dirpath, PORT), fn)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w", encoding="utf-8") as f:
                f.write("\n".join(lines))
    return root


def _key(diags):
    return [(d.rule, str(d.severity), d.line) for d in diags]


_SELF_LINT_CASES = jax_test_fixtures("test_self_lint.py", "_lint_src")


def test_every_fixture_of_the_jax_self_lint_is_taken():
    # 19 calls in 18 tests; a test added there joins the parametrization
    assert len(_SELF_LINT_CASES) >= 19
    ids = {p.id for p in _SELF_LINT_CASES}
    assert {"test_a203_global_rng_in_reader_module", "test_a206_alias_and_from_import",
            "test_a206_empty_pragma_justification_rejected", "test_a206_stale_pragma_flagged",
            "test_a206_dumps_and_master_wire_exempt#2"} <= ids


@pytest.mark.parametrize("src, relname", [
    p if len(p.values) == 2 else pytest.param(*p.values, "reader/mod.py", id=p.id)
    for p in _SELF_LINT_CASES])
def test_fixture_findings_equal_the_jax_package(tmp_path, src, relname):
    path = tmp_path / relname
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    want = [d for d in jast.lint_file(str(path), root=str(tmp_path)) if d.rule not in _NOT_PORTED]
    got = tast.lint_file(str(path), root=str(tmp_path))
    assert _key(got) == _key(want), (format_diagnostics(got), format_diagnostics(want))
    assert not any(d.rule in _NOT_PORTED for d in got)


def test_a204_duplicate_flag_definition_equals_the_jax_package(tmp_path):
    a = tmp_path / "pkg" / "flags_a.py"
    b = tmp_path / "pkg" / "flags_b.py"
    a.parent.mkdir(parents=True)
    a.write_text('define_flag("seed", 0, "x")\n')
    b.write_text('define_flag("seed", 1, "y")\n')
    found = []
    for mod in (jast, tast):
        defs = {}
        d = mod.lint_file(str(a), root=str(tmp_path), _flag_defs=defs)
        d += mod.lint_file(str(b), root=str(tmp_path), _flag_defs=defs)
        found.append(d)
    assert _key(found[1]) == _key(found[0]) == [("A204", "error", 1)]
    assert "flags_a.py" in found[1][0].message and found[1][0].source.endswith("flags_b.py")


def test_the_port_without_its_wire_pragmas_lints_as_in_the_jax_package(tmp_path):
    root = stripped_copy(tmp_path, ("wire",))
    sets = [{(d.rule, d.source, d.line) for d in mod.lint_package(root=root)}
            for mod in (jast, tast)]
    assert sets[1] == sets[0]
    sites = {("A206", os.path.join("paddle_tpu_torch", *rel.split("/")), line)
             for rel, line in (("reader/creator.py", 59), ("reader/creator.py", 85),
                               ("utils/preprocess_img.py", 212),
                               ("utils/preprocess_img.py", 226))}
    assert sites <= sets[1], sorted(sets[1])


def test_the_port_self_lint_is_clean():
    diags = tast.lint_package(extra_paths=[os.path.join(REPO, "chip_smoke.py")])
    assert diags == [], format_diagnostics(diags)

