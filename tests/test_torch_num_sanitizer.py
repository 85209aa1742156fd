"""The port's numerics sanitizer (paddle_tpu_torch/analysis/num_sanitizer.py)
against the JAX package's (paddle_tpu/analysis/num_sanitizer.py) on the CPU.

Each case of ``tests/test_num_sanitizer.py`` has a torch twin.  Where the
JAX interpreter runs on this jax (with the ``jax.core`` names it imports
aliased from ``jax.extend.core`` for one case), the port is held to it
live: the same kind of first non-finite op (``dot_general`` for
``aten.mm``, ``exp``, ``mul``, ``div``) and the same layer.
``test_nan_batch_postmortem_names_poisoned_eqn`` drifts on this jax (its
source provenance), so its twin holds the port to the JAX test's
assertion as a specification.

By design: the port's loops are Python loops, unrolled in the trace, so
there is no scan step to descend into — the record names the node of the
poisoned iteration; and a cast or view of a value that is already
non-finite only propagates it, so the record names the op that computes
with it (the first ``mm`` of a poisoned bf16 weight, not its cast).
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.analysis.num_sanitizer import find_first_nonfinite, num_sanitizer_armed
from paddle_tpu_torch.core.compiler import provenance
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.robustness import chaos
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.timers import global_stats

# the port op each JAX primitive of these cases is
_JAX_PRIM = {"aten.mm": "dot_general", "aten.exp": "exp", "aten.mul": "mul",
             "aten.div": "div"}


@pytest.fixture(autouse=True)
def _clean():
    saved = dict(flags._VALUES)
    yield
    chaos.disarm()
    flags._VALUES.clear()
    flags._VALUES.update(saved)


@pytest.fixture
def jax_shim(monkeypatch):
    """Alias the ``jax.core`` names the JAX interpreter imports lazily, for
    one case (undone by monkeypatch)."""
    import jax
    import jax.extend.core as jec

    for name in ("Literal", "Jaxpr", "ClosedJaxpr"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)
    return jax


def _jax_first(fn, args):
    from paddle_tpu.analysis.num_sanitizer import find_first_nonfinite as jax_first

    return jax_first(fn, args)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def test_first_nonfinite_names_node_and_poisoned_input(jax_shim):
    def fn(x, w):
        provenance.layer = "fc:h1"  # what CompiledNetwork.apply sets per layer
        try:
            y = x @ w
        finally:
            provenance.layer = None
        return torch.tanh(y)

    x = np.ones((4, 8), np.float32)
    x[0, 0] = np.nan
    w = np.ones((8, 8), np.float32)
    rec = find_first_nonfinite(fn, (torch.from_numpy(x), torch.from_numpy(w)))
    assert rec is not None
    assert rec["primitive"] == "aten.mm"
    assert rec["layer"] == "h1"
    assert rec["poisoned_inputs"] and "arg0" in rec["poisoned_inputs"][0]["input"]
    assert any(s.get("n_nonfinite") for s in rec["inputs"])
    assert rec["source"].endswith("test_torch_num_sanitizer.py") and rec["line"]

    jnp = jax_shim.numpy

    def jfn(x, w):
        with jax_shim.named_scope("fc:h1"):
            y = x @ w
        return jnp.tanh(y)

    want = _jax_first(jfn, (x, w))
    assert want["primitive"] == _JAX_PRIM[rec["primitive"]] and want["layer"] == rec["layer"]


def test_first_nonfinite_is_the_producer_not_a_consumer(jax_shim):
    """A finite input that OVERFLOWS mid-graph: the record names the op
    that produced the first inf, not the op that consumed it."""
    def fn(x):
        big = torch.exp(x)  # overflows to inf at x=200
        return big - big    # the consumer turns it into nan

    rec = find_first_nonfinite(fn, (torch.full((4,), 200.0),))
    assert rec["primitive"] == "aten.exp"
    assert rec["poisoned_inputs"] == []
    jnp = jax_shim.numpy
    want = _jax_first(lambda x: jnp.exp(x) - jnp.exp(x), (np.full((4,), 200.0, np.float32),))
    assert want["primitive"] == _JAX_PRIM[rec["primitive"]]


def test_first_nonfinite_localizes_inside_a_loop_step(jax_shim):
    """The twin of the scan-step case: the port's loop is unrolled, so the
    record names the node of the poisoned iteration."""
    def fn(xs):
        c = torch.ones(())
        outs = []
        for t in range(xs.shape[0]):
            c = c * xs[t]  # blows up at the poisoned step
            outs.append(torch.log(c))
        return c, torch.stack(outs)

    xs = np.ones((6,), np.float32)
    xs[3] = np.inf
    rec = find_first_nonfinite(fn, (torch.from_numpy(xs),))
    assert rec["primitive"] == "aten.mul"
    assert any(s.get("n_nonfinite") == 1 for s in rec["inputs"])  # x[3] = inf
    assert rec["node"].endswith(":aten.mul")  # a node of the unrolled loop

    def jfn(xs):
        def body(c, x):
            c = c * x
            return c, jax_shim.numpy.log(c)

        return jax_shim.lax.scan(body, jax_shim.numpy.ones((), jax_shim.numpy.float32), xs)

    want = _jax_first(jfn, (xs,))
    assert want["primitive"] == _JAX_PRIM[rec["primitive"]] and want["scan_step"] == 3


def test_all_finite_returns_none(jax_shim):
    assert find_first_nonfinite(lambda x: torch.tanh(x).sum(), (torch.ones(4),)) is None
    jnp = jax_shim.numpy
    assert _jax_first(lambda x: jnp.tanh(x).sum(), (np.ones((4,), np.float32),)) is None


def test_saturating_quantization_scale_underflow_named_as_div(jax_shim):
    """The quantization drill: a tiny-magnitude block with its scale stored
    in f16 underflows the scale to 0 (amax is NOT zero, so the zero-guard
    stays out of the way) and the quantize division produces inf — named
    as that div.  The port's twin spells the block-scaled quantize of
    ops/quantize.py in torch."""
    def quant(x, scale_dtype):
        amax = x.abs().reshape(-1, 64).amax(-1, keepdim=True)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0).to(scale_dtype)
        payload = torch.round(x.reshape(-1, 64) / scale.float()).clamp(-127, 127).to(torch.int8)
        return payload.float().sum() + scale.float().sum()

    x = torch.full((64,), 1e-8)
    rec = find_first_nonfinite(lambda v: quant(v, torch.float16), (x,))
    assert rec is not None and rec["primitive"] == "aten.div"
    assert rec["poisoned_inputs"] == []
    assert find_first_nonfinite(lambda v: quant(v, torch.float32), (x,)) is None

    import jax.numpy as jnp
    from paddle_tpu.ops.quantize import quantize_block_scaled

    def jquant(v):
        payload, scale = quantize_block_scaled(v, block=64, scale_dtype=jnp.float16)
        return payload.astype(jnp.float32).sum() + scale.sum()

    want = _jax_first(jquant, (np.full((64,), 1e-8, np.float32),))
    assert want["primitive"] == _JAX_PRIM[rec["primitive"]]


def test_armed_flag_reads_env(monkeypatch):
    flags.reset_flags()
    monkeypatch.delenv("PADDLE_TPU_TORCH_NUM_SANITIZER", raising=False)
    assert not num_sanitizer_armed()
    monkeypatch.setenv("PADDLE_TPU_TORCH_NUM_SANITIZER", "1")
    assert num_sanitizer_armed()
    assert len(flags._DEFS) == 63


def test_flash_forward_overflow_is_named_as_the_custom_op():
    """The chip smoke's second planted fault at a probe width: the first
    encoder attention's query weight scaled until q.k overflows f32 while q
    stays finite in bf16 — the first non-finite node is the flash forward
    custom op (its plain version on the CPU), in that layer."""
    from paddle_tpu_torch.core.compiler import CompiledNetwork
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.models.transformer import transformer_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.trainer.step import _train_step_body

    flags.set_flag("use_flash_attention", True)
    reset_auto_names()
    cost, _ = transformer_cost(30, 30, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    net = CompiledNetwork(Topology(cost), compute_dtype="bfloat16")
    params, state = net.init(3, device="cpu")
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    rng = np.random.RandomState(0)
    feeder = DataFeeder(net.topology.data_types(), {"src_word": 0, "trg_word": 1,
                                                    "trg_next": 2}, device="cpu")
    batch = feeder([tuple(list(rng.randint(2, 30, 128)) for _ in range(3)) for _ in range(2)])
    with torch.no_grad():
        outs, _ = net.apply(params, batch, state=state, train=True)
        q = outs[net.topology.layers["enc0_att"].inputs[0]].data.float() \
            @ params["enc0_att"]["wq"].to(torch.bfloat16).float()
        params["enc0_att"]["wq"].mul_(1e38 / float(q.abs().max()))
    body = _train_step_body(net, opt, sentinel=False)
    rec = find_first_nonfinite(body, (params, state, opt.init(params), batch, 1))
    assert rec["primitive"] == "paddle_tpu_torch.flash_attention_fwd", rec
    assert rec["layer"] == "enc0_att" and not rec["backward"]
    q_stats = rec["inputs"][0]
    assert q_stats["n_nonfinite"] == 0 and q_stats["max_abs"] > 1e37


# ---------------------------------------------------------------------------
# trainer e2e: nan_batch drill -> flight-recorder postmortem
# ---------------------------------------------------------------------------


def _small_trainer(seed=0):
    reset_auto_names()
    img = P.layer.data("pixel", P.data_type.dense_vector(32))
    label = P.layer.data("label", P.data_type.integer_value(4))
    h = P.layer.fc(img, size=16, act=P.activation.Relu(), name="h1")
    pred = P.layer.fc(h, size=4, act=P.activation.Softmax(), name="out")
    cost = P.layer.classification_cost(input=pred, label=label)
    return P.trainer.SGD(
        cost=cost, parameters=P.parameters.create(cost, seed=seed, device="cpu"),
        update_equation=P.optimizer.Momentum(learning_rate=0.1, momentum=0.9), device="cpu")


def _reader(n_batches=6, rows=8):
    rng = np.random.RandomState(7)
    data = [(rng.randn(32).astype("float32"), int(rng.randint(4)))
            for _ in range(n_batches * rows)]
    return P.batch(lambda: iter(data), rows)


def _final_params(trainer):
    return {f"{k}.{kk}": v.detach().clone() for k, d in trainer.parameters.params.items()
            for kk, v in d.items()}


def test_nan_batch_postmortem_names_poisoned_node(tmp_path):
    """spec (the JAX twin drifts on this jax): with the sanitizer armed,
    the nan_batch chaos point's skipped step produces a flight-recorder
    postmortem naming the first non-finite-producing node, its layer, its
    source line and the poisoned feed slot."""
    flags.set_flag("num_sanitizer", True)
    flags.set_flag("trace_dir", str(tmp_path))
    trainer = _small_trainer()
    chaos.arm("nan_batch@3")
    base = global_stats.count("num_sanitizer/captures")
    trainer.train(_reader(), num_passes=1)
    assert global_stats.count("num_sanitizer/captures") > base

    obj = json.loads((tmp_path / f"flight-{os.getpid()}.json").read_text())
    assert obj["otherData"]["reason"].startswith("num-sanitizer: skip")
    num = obj["otherData"]["numerics"]
    assert num["primitive"] == "aten.mm"
    assert num["layer"] == "h1"
    assert any("pixel" in p["input"] for p in num["poisoned_inputs"])
    assert num["source"] and num["line"]
    summ = global_stats.summary()
    num_rows = {k: v for k, v in summ.items() if k.startswith(f"num/{num['node']}/")}
    assert num_rows, sorted(summ)
    assert any(v["nonfinite"] for v in num_rows.values())


def test_unarmed_is_untouched_and_armed_changes_nothing(tmp_path):
    """Unarmed, the capture counter never moves; arming the sanitizer
    (observe-only) leaves the trained params bit-identical."""
    base = global_stats.count("num_sanitizer/captures")
    flags.set_flag("divergence_sentinel", True)
    flags.set_flag("num_sanitizer", False)
    t1 = _small_trainer(seed=3)
    t1.train(_reader(), num_passes=1)
    assert global_stats.count("num_sanitizer/captures") == base  # unarmed
    p1 = _final_params(t1)

    flags.set_flag("num_sanitizer", True)
    flags.set_flag("trace_dir", str(tmp_path))
    t2 = _small_trainer(seed=3)
    t2.train(_reader(), num_passes=1)
    assert global_stats.count("num_sanitizer/captures") == base + 6  # armed: one per step
    p2 = _final_params(t2)
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
