"""The port's cost layers (paddle_tpu_torch/layers/cost.py) against the JAX
package's (paddle_tpu/layers/cost.py): cross_entropy over `<input>@logits`
(the fused log-softmax path), over probabilities, and softmax_with_cost, on
padded sequences and on plain rows.  Values and gradients with respect to
the logits agree at f32 atol 1e-6: the same f32 arithmetic in another
summation order over a vocabulary of 37."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.layers import cost as jcost
from paddle_tpu_torch.core.batch import SeqTensor as TSeq
from paddle_tpu_torch.layers import cost as tcost

ATOL = 1e-6
B, T, V = 3, 8, 37
LENGTHS = np.asarray([8, 5, 1], np.int32)


def _inputs(seq):
    rng = np.random.RandomState(0)
    shape = (B, T, V) if seq else (B, V)
    logits = (2.0 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, V, size=shape[:-1]).astype(np.int32)
    return logits, labels


def _jax_cost(kind, logits, labels, seq):
    lens = jnp.asarray(LENGTHS) if seq else None
    conf = SimpleNamespace(inputs=("pred", "lbl"))

    def f(x):
        lbl = JSeq(jnp.asarray(labels), lens)
        if kind == "softmax_with_cost":
            out = jcost.softmax_with_cost_apply(conf, {}, [JSeq(x, lens), lbl], None)
        else:
            outputs = {"pred@logits": JSeq(x, lens)} if kind == "logits" else {}
            prob = JSeq(jax.nn.softmax(x, axis=-1), lens)
            out = jcost.cross_entropy_apply(conf, {}, [prob, lbl], SimpleNamespace(outputs=outputs))
        return out.data

    return np.asarray(f(jnp.asarray(logits))), np.asarray(
        jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(logits))
    )


def _torch_cost(kind, logits, labels, seq):
    lens = torch.from_numpy(LENGTHS) if seq else None
    conf = SimpleNamespace(inputs=("pred", "lbl"))
    x = torch.tensor(logits, requires_grad=True)
    lbl = TSeq(torch.from_numpy(labels), lens)
    if kind == "softmax_with_cost":
        out = tcost.softmax_with_cost_apply(conf, {}, [TSeq(x, lens), lbl], None)
    else:
        outputs = {"pred@logits": TSeq(x, lens)} if kind == "logits" else {}
        prob = TSeq(torch.softmax(x, dim=-1), lens)
        out = tcost.cross_entropy_apply(conf, {}, [prob, lbl], SimpleNamespace(outputs=outputs))
    out.data.sum().backward()
    return out.data.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("kind", ["logits", "probabilities", "softmax_with_cost"])
@pytest.mark.parametrize("seq", [True, False])
def test_cost_and_gradient_match_jax(kind, seq):
    logits, labels = _inputs(seq)
    want, want_g = _jax_cost(kind, logits, labels, seq)
    got, got_g = _torch_cost(kind, logits, labels, seq)
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_g, want_g, atol=ATOL)
    if seq:  # padded timesteps carry no cost and get no gradient
        assert not np.any(got_g[1, 5:]) and not np.any(got_g[2, 1:])
