"""The package leg of the port's precision-flow lint (its probe
topologies through the shipped step builder) held live to the JAX
package's ``lint_numerics_package`` at f32, as
``tests/test_numerics_lint.py``'s package case holds the JAX lint; the
rule-by-rule twins are in ``test_torch_numerics_lint.py``."""

from paddle_tpu_torch.analysis import numerics_lint as NL
from test_torch_numerics_lint import jax_shim  # noqa: F401 (a fixture)


def test_package_probes_agree_with_the_jax_lint_at_f32(jax_shim):  # noqa: F811
    from paddle_tpu.analysis.numerics_lint import lint_numerics_package as jax_pkg

    assert NL.lint_numerics_package(device="cpu") == jax_pkg() == []
