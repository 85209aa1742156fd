"""The port's precision-flow lint (paddle_tpu_torch/analysis/numerics_lint.py)
against the JAX package's (paddle_tpu/analysis/numerics_lint.py) on the CPU.

Each case of ``tests/test_numerics_lint.py`` has a torch twin: the same
hazard planted in a torch function and linted over its traced FX graph.
Where the JAX function runs on this jax (with the ``jax.core`` names it
imports aliased from ``jax.extend.core`` for one case), the port is held
to it live.  Cases that drift on this jax — the long-bf16-reduce, the
-1e9-under-f16, the two pragma cases and the quantized-psum and
shard_map N405 cases — hold the port to the JAX test's assertion as a
specification (this jax no longer hands the JAX pass a
source line, so its pragmas cannot anchor; ``jnp.cumsum`` and ``where``
trace to other primitives).

Differences by design, listed where they show:

* N401's GEMM subject is cuBLAS's reduced-precision switch, read when the
  trace is taken (no ``preferred_element_type`` in torch); a torch
  ``sum`` over bf16 accumulates in f32 and never fires; the scan-carry
  accumulator is a chain of more than 32 adds through an unrolled Python
  loop, so the probes' 6-step recurrences do not fire where JAX's scan
  carries do (JAX justifies those with pragmas the port has no site for).
* N405 has no torch subject (no collective until a device mesh is ported).
* N406: this jax cannot anchor the JAX findings on the lines its pragmas
  sit on, so at bf16 the JAX lint reports its pragma'd casts raw.

The corpus cases are in ``test_torch_numerics_parity.py`` (the mnist
spec, the live parity per config, the slow corpus sweep) and
``test_torch_numerics_probes.py`` (the package probes, live).  The
bench satellites of the JAX file (``bench.py``'s non-finite guards)
have no port counterpart: the port has no benchmark yet.
"""

import io
import os
import re
import textwrap
import tokenize

import numpy as np
import pytest
import torch

from paddle_tpu_torch.analysis import format_diagnostics
from paddle_tpu_torch.analysis import numerics_lint as NL
from paddle_tpu_torch.analysis import trace_lint as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "tests", "configs")
PORT = os.path.join(REPO, "paddle_tpu_torch")


def rules(diags):
    return [d.rule for d in diags]


def lint_fn(fn, *args, **kw):
    return NL.lint_numerics_graph(TL.trace_step(fn, *args), apply_pragmas=False, **kw)


@pytest.fixture
def jax_shim(monkeypatch):
    """Alias the ``jax.core`` names the JAX passes import lazily, for one
    case (undone by monkeypatch)."""
    import jax
    import jax.extend.core as jec

    for name in ("Literal", "Jaxpr", "ClosedJaxpr"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)
    return jax


@pytest.fixture
def reduced_precision():
    """cuBLAS's reduced-precision switches, restored after the case
    (``test_torch_hygiene.py`` watches process-wide defaults)."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction)

    def set_(on):
        m.allow_bf16_reduced_precision_reduction = on
        m.allow_fp16_reduced_precision_reduction = on

    yield set_
    m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction = saved


def _jax_rules(jax, fn, *args):
    from paddle_tpu.analysis.numerics_lint import lint_numerics_jaxpr

    return rules(lint_numerics_jaxpr(jax.make_jaxpr(fn)(*args), apply_pragmas=False))


# ---------------------------------------------------------------------------
# N401 low-precision accumulation
# ---------------------------------------------------------------------------


def test_n401_bf16_gemm_with_reduced_precision_reduction_fires(reduced_precision):
    x = torch.ones(4, 128, dtype=torch.bfloat16)
    w = torch.ones(128, 8, dtype=torch.bfloat16)
    reduced_precision(True)
    d = lint_fn(lambda a, b: a @ b, x, w)
    assert "N401" in rules(d), format_diagnostics(d)


def test_n401_silent_with_f32_accumulation(reduced_precision):
    """The twin of ``preferred_element_type=f32``: the switches False."""
    x = torch.ones(4, 128, dtype=torch.bfloat16)
    w = torch.ones(128, 8, dtype=torch.bfloat16)
    reduced_precision(False)
    d = lint_fn(lambda a, b: a @ b, x, w)
    assert "N401" not in rules(d), format_diagnostics(d)
    reduced_precision(True)
    assert "N401" not in rules(lint_fn(lambda a, b: a @ b, x.float(), w.float()))


def test_init_and_compiled_network_pin_f32_accumulation(reduced_precision):
    """Repair: selecting a sub-f32 compute dtype pins cuBLAS's f32
    accumulation (ops.pin_f32_accumulation), through init and through a
    network built for bf16."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import compiler, device

    m = torch.backends.cuda.matmul
    reduced_precision(True)
    saved = (compiler._default_compute_dtype, device._default_device, dict(P.flags._VALUES))
    try:
        P.init(compute_dtype="bfloat16", device="cpu")
        assert not m.allow_bf16_reduced_precision_reduction
        assert not m.allow_fp16_reduced_precision_reduction
    finally:
        compiler._default_compute_dtype, device._default_device = saved[0], saved[1]
        P.flags._VALUES.clear()
        P.flags._VALUES.update(saved[2])
    # an f32 network leaves the switches alone, a bf16 one pins them
    reduced_precision(True)
    from paddle_tpu_torch.core.topology import Topology, reset_auto_names

    reset_auto_names()
    x = P.layer.data("x", P.data_type.dense_vector(8))
    cost = P.layer.classification_cost(
        input=P.layer.fc(x, size=4, act=P.activation.Softmax()),
        label=P.layer.data("y", P.data_type.integer_value(4)))
    compiler.CompiledNetwork(Topology([cost]), compute_dtype="float32")
    assert m.allow_bf16_reduced_precision_reduction
    compiler.CompiledNetwork(Topology([cost]), compute_dtype="bfloat16")
    assert not m.allow_bf16_reduced_precision_reduction


def test_n401_long_bf16_cumsum_fires_short_and_sum_do_not():
    # spec (drifts on this jax): a long low-dtype running reduction fires;
    # a short one and the (f32-accumulating) sum do not
    big = torch.ones(4, 256, dtype=torch.bfloat16)
    assert "N401" in rules(lint_fn(lambda a: torch.cumsum(a, dim=-1), big))
    small = torch.ones(4, 8, dtype=torch.bfloat16)
    assert "N401" not in rules(lint_fn(lambda a: torch.cumsum(a, dim=-1), small))
    assert "N401" not in rules(lint_fn(lambda a: a.sum(dim=-1), big))


def test_n401_loop_carry_accumulator_fires_state_carry_does_not(jax_shim):
    xs = torch.ones(64, 8, dtype=torch.bfloat16)

    def accumulating(xs):
        c = torch.zeros(8, dtype=torch.bfloat16)
        for t in range(xs.shape[0]):
            c = c + xs[t]  # running sum: quantizes every step
        return c

    d = lint_fn(accumulating, xs)
    assert "N401" in rules(d), format_diagnostics(d)
    assert any("carry" in x.message for x in d if x.rule == "N401")

    def overwriting(xs):
        c = torch.zeros(8, dtype=torch.bfloat16)
        for t in range(xs.shape[0]):
            c = torch.tanh(xs[t]) * 0.5 + 0.5 * torch.tanh(c)
        return c

    d2 = lint_fn(overwriting, xs)
    assert not any("carry" in x.message for x in d2 if x.rule == "N401"), format_diagnostics(d2)
    # live: the JAX scan twins agree on both
    jnp = jax_shim.numpy
    jx = jnp.ones((64, 8), jnp.bfloat16)
    acc = _jax_rules(jax_shim, lambda xs: jax_shim.lax.scan(
        lambda c, x: (c + x, x), jnp.zeros((8,), jnp.bfloat16), xs), jx)
    ovr = _jax_rules(jax_shim, lambda xs: jax_shim.lax.scan(
        lambda c, x: (jnp.tanh(x) * 0.5 + 0.5 * jnp.tanh(c), c),
        jnp.zeros((8,), jnp.bfloat16), xs), jx)
    assert ("N401" in acc) and ("N401" not in ovr)


# ---------------------------------------------------------------------------
# N402 master-precision escape (via the step-level entry point)
# ---------------------------------------------------------------------------


def _fake_step(update_in_bf16):
    def step(params, state, opt_state, batch, rng):
        g = batch["x"].sum(dim=0) * 1e-3
        if update_in_bf16:
            p16 = params["w"].to(torch.bfloat16) - g.to(torch.bfloat16)
            params["w"].copy_(p16.float())  # upcast AFTER the math, written in place
        else:
            params["w"].sub_(g)
        return params, state, opt_state, {"cost": g.sum()}

    return step, ({"w": torch.zeros(8)}, {}, {}, {"x": torch.ones(4, 8)}, 0)


def test_n402_update_math_below_master_precision_fires():
    step, args = _fake_step(update_in_bf16=True)
    d = NL.lint_numerics_step(step, *args, master_argnums=(0,), apply_pragmas=False)
    assert "N402" in rules(d), format_diagnostics(d)


def test_n402_silent_on_f32_update_math():
    step, args = _fake_step(update_in_bf16=False)
    d = NL.lint_numerics_step(step, *args, master_argnums=(0,), apply_pragmas=False)
    assert "N402" not in rules(d), format_diagnostics(d)


def test_n402_master_leaf_left_at_bf16_fires():
    def step(params, state, opt_state, batch, rng):
        params["w"].sub_(batch["x"].sum(dim=0))
        return params, state, opt_state, {"cost": batch["x"].sum()}

    d = NL.lint_numerics_step(step, {"w": torch.zeros(8, dtype=torch.bfloat16)}, {}, {},
                              {"x": torch.ones(4, 8, dtype=torch.bfloat16)}, 0,
                              master_argnums=(0,), apply_pragmas=False)
    assert "N402" in rules(d), format_diagnostics(d)


# ---------------------------------------------------------------------------
# N403 unguarded domain hazards
# ---------------------------------------------------------------------------


def test_n403_unguarded_exp_fires_max_subtracted_does_not(jax_shim):
    x = torch.ones(4, 16)
    assert "N403" in rules(lint_fn(torch.exp, x))

    def softmaxish(a):
        return torch.exp(a - a.amax(-1, keepdim=True).detach())

    assert "N403" not in rules(lint_fn(softmaxish, x))
    jnp = jax_shim.numpy
    assert "N403" in _jax_rules(jax_shim, jnp.exp, jnp.ones((4, 16)))


def test_n403_att_softmax_is_the_positive_pattern():
    """ops/rnn.py:_att_softmax — masked fill + softmax — lints clean."""
    from paddle_tpu_torch.ops.rnn import _att_softmax

    d = lint_fn(_att_softmax, torch.ones(4, 16), torch.ones(4, 16, dtype=torch.bool))
    assert "N403" not in rules(d), format_diagnostics(d)


def test_n403_unguarded_log_and_div_fire_epsilon_idiom_does_not():
    x = torch.ones(4, 16)
    assert "N403" in rules(lint_fn(torch.log, x))
    assert "N403" not in rules(lint_fn(lambda a: torch.log(a + 1e-6), x))
    y = torch.ones(4, 16)
    assert "N403" in rules(lint_fn(lambda a, b: a / b, x, y))
    assert "N403" not in rules(lint_fn(lambda a, b: a / torch.clamp(b, min=1e-6), x, y))
    assert "N403" not in rules(lint_fn(lambda a, b: a / torch.maximum(b, torch.tensor(1e-6)),
                                       x, y))
    assert "N403" in rules(lint_fn(torch.rsqrt, x))
    assert "N403" not in rules(lint_fn(lambda a: torch.rsqrt(a + 1e-8), x))


# ---------------------------------------------------------------------------
# N404 sentinel literal overflow
# ---------------------------------------------------------------------------


def test_n404_1e9_mask_under_f16_fires():
    # spec (drifts on this jax): the -1e9 fill under f16 fires
    score = torch.ones(4, 16, dtype=torch.float16)
    mask = torch.ones(4, 16, dtype=torch.bool)
    d = lint_fn(lambda s, m: torch.where(m, s, -1e9), score, mask)
    assert "N404" in rules(d), format_diagnostics(d)


def test_n404_silent_under_bf16_and_with_dtype_aware_fill():
    mask = torch.ones(4, 16, dtype=torch.bool)
    d = lint_fn(lambda s, m: torch.where(m, s, -1e9), torch.ones(4, 16, dtype=torch.bfloat16),
                mask)
    assert "N404" not in rules(d)

    def dtype_aware(s, m):
        return torch.where(m, s, torch.finfo(s.dtype).min)

    d2 = lint_fn(dtype_aware, torch.ones(4, 16, dtype=torch.float16), mask)
    assert "N404" not in rules(d2), format_diagnostics(d2)


# ---------------------------------------------------------------------------
# N405: no torch subject until a device mesh is ported
# ---------------------------------------------------------------------------


def _jax_n405_case(jax, case):
    """The JAX N405 case's verdict on this jax (None where it drifts)."""
    jnp = jax.numpy
    from paddle_tpu.analysis.numerics_lint import lint_numerics_jaxpr

    def lint(fn, *args):
        closed = jax.make_jaxpr(fn, axis_env=[("dp", 2)])(*args)
        return rules(lint_numerics_jaxpr(closed, apply_pragmas=False))

    g = jnp.ones((8,), jnp.bfloat16)
    if case == "lone_bf16_psum_fires":
        return "N405" in lint(lambda x: jax.lax.psum(x, "dp"), g)
    if case == "block_scaled_psum_passes":
        def block_scaled(x, scale):
            return jax.lax.psum(x, "dp").astype(jnp.float32) * jax.lax.psum(scale, "dp")

        return "N405" not in lint(block_scaled, g, jnp.ones((1,), jnp.float32))
    if case == "mutated_quantized_psum_fires":
        def local_scale_only(x):
            amax = jnp.max(jnp.abs(x))
            scale = jnp.where(amax == 0.0, jnp.float32(1.0), amax / 127.0)
            q = jnp.round(x / scale).astype(jnp.int8)
            return jax.lax.psum(q, "dp").astype(jnp.float32) * scale

        return "N405" in lint(local_scale_only, jnp.ones((64,), jnp.float32))
    return None  # quantized_psum_helper_lints_zero, sees_through_shard_map: drift


@pytest.mark.parametrize("case", ["lone_bf16_psum_fires", "block_scaled_psum_passes",
                                  "quantized_psum_helper_lints_zero",
                                  "mutated_quantized_psum_fires", "sees_through_shard_map"])
def test_n405_has_no_torch_subject(jax_shim, case):
    """By design, one twin per JAX N405 case: the JAX lint gives its
    verdict live where it runs on this jax (two cases drift: the quantized
    helper and shard_map); the port issues no collective, so its nearest
    twin — the same payload reduced on one device — has no N405, and the
    rule stays reserved."""
    verdict = _jax_n405_case(jax_shim, case)
    assert verdict in (True, None), case
    payload = torch.ones(64, dtype=torch.bfloat16 if "bf16" in case else torch.float32)
    d = lint_fn(lambda x: (x.to(torch.int8) if "quantized" in case else x).sum(), payload)
    assert "N405" not in rules(d)
    assert "N405" in NL.__doc__ and "no torch subject" in NL.__doc__


# ---------------------------------------------------------------------------
# N406 dtype round-trip churn
# ---------------------------------------------------------------------------


def test_n406_f32_bf16_f32_roundtrip_fires(jax_shim):
    x = torch.ones(4, 16)
    d = lint_fn(lambda a: a.to(torch.bfloat16).float() * 2.0, x)
    assert "N406" in rules(d), format_diagnostics(d)
    jnp = jax_shim.numpy
    assert "N406" in _jax_rules(jax_shim, lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)
                                * 2.0, jnp.ones((4, 16)))


def test_n406_one_way_casts_do_not_fire():
    x = torch.ones(4, 16)
    assert "N406" not in rules(lint_fn(lambda a: a.to(torch.bfloat16) * 2, x))
    # widening round trip (bf16 -> f32 -> bf16 loses nothing on the way up)
    y = torch.ones(4, 16, dtype=torch.bfloat16)
    assert "N406" not in rules(lint_fn(lambda a: a.float().to(torch.bfloat16), y))


# ---------------------------------------------------------------------------
# pragma plane
# ---------------------------------------------------------------------------


def _write_module(tmp_path, name, body):
    p = tmp_path / f"{name}.py"
    p.write_text(textwrap.dedent(body))
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_num_pragma_suppresses_with_justification(tmp_path):
    # spec (drifts on this jax: its pass gets no source line to anchor on)
    mod = _write_module(tmp_path, "praggood", """
        import torch

        def f(x):
            return torch.exp(x)  # num: allow[N403] scores are clipped by the caller
    """)
    tr = TL.trace_step(mod.f, torch.ones(4, 16))
    assert "N403" not in rules(NL.lint_numerics_graph(tr)), \
        format_diagnostics(NL.lint_numerics_graph(tr))
    assert "N403" in rules(NL.lint_numerics_graph(tr, apply_pragmas=False))


def test_num_pragma_without_justification_is_rejected(tmp_path):
    # spec (drifts on this jax)
    mod = _write_module(tmp_path, "pragbad", """
        import torch

        def f(x):
            return torch.exp(x)  # num: allow[N403]
    """)
    f = NL._PragmaFilter()
    d = NL.lint_numerics_graph(TL.trace_step(mod.f, torch.ones(4, 16)), _filter=f)
    assert "N403" in rules(d)
    assert "N400" in rules(f.pragma_diags)


def _pragma_sites(planes):
    """(relpath, line) of every pragma comment of `planes` in the port."""
    pat = re.compile(r"#\s*(?:%s):" % "|".join(planes))
    out = set()
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                    if tok.type == tokenize.COMMENT and pat.match(tok.string):
                        out.add((os.path.relpath(path, REPO), tok.start[0]))
    return out


# the pragma lines only a CUDA step reaches: fetch_metrics copies CUDA
# metrics only, so the CPU trace never issues its float64 carrier
_CUDA_ONLY = {("paddle_tpu_torch/trainer/step.py", "fetch_metrics")}


def test_stripped_pragmas_each_report_their_finding(tmp_path):
    """Mutation check: with the port's ``# num:`` and ``# trace:`` pragmas
    stripped (a copy of the package, read by the pragma filters), each
    pragma's line reports the finding it justifies; with them, clean."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.batch import SeqTensor
    from paddle_tpu_torch.core.topology import Topology, reset_auto_names
    from paddle_tpu_torch.models.transformer import transformer_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.trainer.step import (
        _train_step_body,
        make_epoch_program,
        make_train_carry,
    )
    from test_torch_self_lint import stripped_copy

    stripped_copy(tmp_path, ("num", "trace"))
    num = NL._PragmaFilter(root=str(tmp_path))
    trc = TL.SitePragmaFilter("trace", root=str(tmp_path))
    found = set()

    def note(diags):
        found.update((d.source, d.line) for d in diags if d.source)

    # the bf16 Transformer step: the mixed-contract casts and the LN affine
    reset_auto_names()
    cost, _ = transformer_cost(30, 30, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    net = P.CompiledNetwork(Topology(cost), compute_dtype="bfloat16")
    params, state = net.init(1, device="cpu")
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    rng = np.random.RandomState(0)
    feeder = DataFeeder(net.topology.data_types(), {"src_word": 0, "trg_word": 1,
                                                    "trg_next": 2}, device="cpu")
    batch = feeder([tuple(list(rng.randint(2, 30, 16)) for _ in range(3)) for _ in range(2)])
    tr = TL.trace_step(_train_step_body(net, opt), params, state, opt.init(params), batch, 1)
    note(NL.lint_numerics_graph(tr, _filter=num))
    note(TL.lint_graph(tr, _filter=trc))
    assert NL.lint_numerics_graph(tr) == [] and TL.lint_graph(tr) == []
    # the epoch program's snapshot of the carry
    k = 2
    stacked = {n: SeqTensor(torch.stack([t.data] * k), torch.stack([t.lengths] * k))
               for n, t in batch.items()}
    carry = make_train_carry(params, state, opt.init(params), torch.Generator().manual_seed(0))
    note(TL.donation_audit(make_epoch_program(net, opt), carry, stacked, torch.arange(k),
                           carry_elem_threshold=256, _filter=trc))
    sites = _pragma_sites(("num", "trace"))
    missing = set()
    for src, line in sites:
        with open(os.path.join(REPO, src), encoding="utf-8") as f:
            text = f.read().split("\n")
        fn = next((ln.split("def ")[1].split("(")[0] for ln in reversed(text[:line])
                   if ln.startswith("def ")), "")
        if (src, fn) in _CUDA_ONLY:
            continue
        if (src, line) not in found:
            missing.add((src, line))
    assert not missing, (sorted(missing), sorted(found))


# ---------------------------------------------------------------------------
# certify_precision_plan
# ---------------------------------------------------------------------------


def test_certify_rejects_bf16_master_accepts_bf16_compute_f32_master():
    from paddle_tpu_torch.v1_compat import parse_config

    topo = parse_config(os.path.join(CONFIGS, "demo_text_lstm.py"), "").topology
    good = NL.certify_precision_plan(topo, {"compute_dtype": "bfloat16"}, device="cpu")
    assert good.ok, good.format()
    assert good.master_dtype == "float32"
    text = good.format()
    assert "ACCEPT" in text and "__lstmemory_0__" in text and "(float32)" in text

    bad = NL.certify_precision_plan(
        topo, {"compute_dtype": "bfloat16", "master_dtype": "bfloat16"}, device="cpu")
    assert not bad.ok, bad.format()
    assert "N402" in {d.rule for d in bad.diagnostics}
    assert "REJECT" in bad.format()


def test_certify_int8_weight_only_accepts_int8_master_rejects():
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.topology import Topology, reset_auto_names

    reset_auto_names()
    x = P.layer.data("x", P.data_type.dense_vector(8))
    h = P.layer.fc(x, size=16, act=P.activation.Relu())
    pred = P.layer.fc(h, size=4, act=P.activation.Softmax())
    y = P.layer.data("y", P.data_type.integer_value(4))
    topo = Topology([P.layer.classification_cost(input=pred, label=y)])

    ok = NL.certify_precision_plan(topo, {"compute_dtype": "bfloat16",
                                          "quantized_weights": True}, device="cpu")
    assert ok.ok, ok.format()
    for plan in ({"master_dtype": "int8"}, {"compute_dtype": "int8"},
                 {"compute_dtype": "bfloat16", "master_dtype": "int8",
                  "quantized_weights": True}):
        bad = NL.certify_precision_plan(topo, plan, device="cpu")
        assert not bad.ok, (plan, bad.format())
        assert "N402" in {d.rule for d in bad.diagnostics}
        assert "weight-only" in bad.diagnostics[0].message
        assert "quantized_weights" in (bad.diagnostics[0].hint or "")
        assert bad.rows == []  # rejected without a trace


# ---------------------------------------------------------------------------
# satellite: StatSet non-finite bucket
# ---------------------------------------------------------------------------


def test_statset_observe_nonfinite_goes_to_own_bucket():
    from paddle_tpu_torch.utils.timers import StatSet

    s = StatSet()
    s.observe("num/x", 2.0)
    s.observe("num/x", float("nan"))
    s.observe("num/x", float("inf"))
    s.observe("num/x", 4.0)
    row = s.summary()["num/x"]
    assert row["count"] == 2 and row["nonfinite"] == 2
    assert row["avg"] == 3.0 and row["max"] == 4.0  # unpoisoned
    assert np.isfinite(row["total"])
