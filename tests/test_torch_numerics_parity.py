"""The port's precision-flow lint over the shipped config corpus, held to
the JAX package's lint live (``tests/test_numerics_lint.py``'s corpus
cases; the rule-by-rule twins are in ``test_torch_numerics_lint.py``).

Each config's real train step is traced once per dtype for the whole
module and linted raw; the pragma filter is applied to that raw result
where a case wants it, as ``lint_numerics_config(apply_pragmas=True)``
applies it.  The mnist config case drifts on this jax and holds the port
to the JAX test's assertion as a specification.  The rules whose subjects
differ by design at bf16 (N401's GEMM switch, N405, N406) are listed in
``test_torch_numerics_lint.py``'s docstring.
"""

import functools
import os

import pytest

from paddle_tpu_torch.analysis import format_diagnostics
from paddle_tpu_torch.analysis import numerics_lint as NL
from test_torch_numerics_lint import jax_shim  # noqa: F401 (a fixture)

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


@functools.lru_cache(maxsize=None)
def _port_raw(cfg, dtype):
    return tuple(NL.lint_numerics_config(os.path.join(CONFIGS, cfg), compute_dtype=dtype,
                                         device="cpu", apply_pragmas=False))


def port_lint(cfg, dtype=None, apply_pragmas=True):
    """The port's lint of one config at one dtype, from the module's one
    trace of it."""
    raw = list(_port_raw(cfg, dtype))
    return NL._PragmaFilter().filter(raw) if apply_pragmas else raw


def test_mnist_demo_config_zero_diagnostic_at_f32_and_bf16():
    # spec (drifts on this jax)
    assert port_lint("demo_mnist_mlp.py") == []
    d = port_lint("demo_mnist_mlp.py", "bfloat16")
    assert d == [], format_diagnostics(d)


# rules whose subjects differ by design at bf16 (test_torch_numerics_lint.py)
_BY_DESIGN_BF16 = {"N401", "N405", "N406"}


@pytest.mark.parametrize("cfg", ["demo_mnist_mlp.py", "demo_seq2seq_attention.py",
                                 "demo_text_lstm.py"])
def test_config_rules_agree_with_the_jax_lint(jax_shim, cfg):  # noqa: F811
    """Live: the port and the JAX lint on each config's real step give the
    same findings at f32 (none) and, outside the by-design rules, at bf16."""
    from paddle_tpu.analysis.numerics_lint import lint_numerics_config as jax_lint

    path = os.path.join(CONFIGS, cfg)
    assert port_lint(cfg) == jax_lint(path) == []
    port = port_lint(cfg, "bfloat16", apply_pragmas=False)
    want = jax_lint(path, compute_dtype="bfloat16", apply_pragmas=False)
    assert {(d.rule, d.layer) for d in port if d.rule not in _BY_DESIGN_BF16} == \
        {(d.rule, d.layer) for d in want if d.rule not in _BY_DESIGN_BF16}


@pytest.mark.slow
def test_flagship_corpus_zero_diagnostic_both_dtypes():
    for cfg in sorted(os.listdir(CONFIGS)):
        if not cfg.endswith(".py"):
            continue
        for dt in (None, "bfloat16"):
            d = port_lint(cfg, dt)
            assert d == [], (cfg, dt, format_diagnostics(d))
    for dt in (None, "bfloat16"):
        d = NL.lint_numerics_package(compute_dtype=dt, device="cpu")
        assert d == [], (dt, format_diagnostics(d))
