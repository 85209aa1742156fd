"""The port's trace-hygiene analyzer (paddle_tpu_torch/analysis/trace_lint.py)
against the JAX package's (paddle_tpu/analysis/trace_lint.py) on the CPU.

Each case of ``tests/test_trace_lint.py`` has a twin here: the same hazard
planted in a torch function, traced with ``make_fx`` into an FX graph.
Where the JAX function runs on this jax (the recompile audit, ``lint_step``
and ``donation_audit`` on plain functions, with the ``jax.core`` names it
imports aliased from ``jax.extend.core`` for the length of one case), the
port is held to it live: the same rule ids (and, for T104/T105, the same
messages).  ``test_t101_f64_leak_detected`` and
``test_t106_shipped_builders_are_clean`` drift on this jax
(``jax.experimental.enable_x64`` moved; the shipped builders' audit), so
their twins hold the port to the JAX test's assertion as a specification.

Rules that differ by design: T103's subject is a host sync
(``aten._local_scalar_dense``, a device-to-host copy, data-dependent sizes)
where JAX's is a host callback; T106's donation is an in-place update of
the input.  The step's own host decision (``trainer/step.py``) and the
epoch program's snapshot of the carry carry justified ``# trace:`` pragmas.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.analysis import format_diagnostics
from paddle_tpu_torch.analysis import trace_lint as TL
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.compiler import CompiledNetwork, provenance
from paddle_tpu_torch.core.topology import Topology, reset_auto_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rules(diags):
    return [d.rule for d in diags]


@pytest.fixture
def jax_shim(monkeypatch):
    """The ``jax.core`` names the JAX package's passes import lazily
    (Literal, Jaxpr, ClosedJaxpr), aliased from ``jax.extend.core`` for one
    case; monkeypatch undoes it, so no JAX test in the same worker sees it."""
    import jax
    import jax.extend.core as jec

    for name in ("Literal", "Jaxpr", "ClosedJaxpr"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)
    return jax


# ---------------------------------------------------------------------------
# mutations: each hazard fires with its exact rule id
# ---------------------------------------------------------------------------


def test_t101_f64_leak_detected():
    # spec: the JAX twin drifts on this jax (jax.experimental.enable_x64 moved)
    def leaky(x):
        return x * torch.tensor(2.0, dtype=torch.float64)

    d = TL.lint_step(leaky, torch.ones(4, dtype=torch.float64))
    assert "T101" in rules(d), format_diagnostics(d)


def test_t101_silent_in_f32(jax_shim):
    import jax.numpy as jnp
    from paddle_tpu.analysis import trace_lint as JTL

    d = TL.lint_step(lambda x: x * 2.0, torch.ones(4))
    assert "T101" not in rules(d)
    assert rules(d) == rules(JTL.lint_step(lambda x: x * 2.0, jnp.ones((4,), jnp.float32)))


def test_t102_closure_captured_weights(jax_shim):
    from paddle_tpu.analysis import trace_lint as JTL

    w = torch.ones(256, 256)  # 64k elements, over the threshold
    x = torch.ones(4, 256)
    d = TL.lint_step(lambda a: a @ w, x)
    assert "T102" in rules(d), format_diagnostics(d)
    # as an ARGUMENT the same tensor is fine
    d2 = TL.lint_step(lambda wt, a: a @ wt, w, x)
    assert "T102" not in rules(d2)
    wn, xn = w.numpy(), x.numpy()
    assert rules(d) == rules(JTL.lint_step(lambda a: a @ wn, xn))
    assert rules(d2) == rules(JTL.lint_step(lambda wt, a: a @ wt, wn, xn))


def test_t102_threshold_respected(jax_shim):
    from paddle_tpu.analysis import trace_lint as JTL

    small = torch.ones(8, 8)
    d = TL.lint_step(lambda a: a @ small, torch.ones(4, 8))
    assert "T102" not in rules(d)
    sn = small.numpy()
    assert rules(d) == rules(JTL.lint_step(lambda a: a @ sn, np.ones((4, 8), np.float32)))


def test_t103_host_sync_in_hot_path():
    """The twin of JAX's debug_print in the hot path: a host read."""
    def step(x):
        if float(x.sum()) > 0:  # .item(): the host waits for the device
            x = x * 2
        return x

    d = TL.lint_step(step, torch.ones(4))
    assert "T103" in rules(d), format_diagnostics(d)
    assert "1 host sync(s) per step" in d[0].message


def test_t103_counts_syncs_inside_a_loop_body():
    """The twin of JAX's callback inside a scan body: the port's loop is a
    Python loop, so each iteration's read is one sync of the step."""
    def step(x):
        c = x[0]
        for t in range(4):
            _ = float(c)
            c = c + x[t]
        return c

    d = TL.lint_step(step, torch.ones(4))
    assert rules(d) == ["T103"] and "4 host sync(s) per step" in d[0].message


def test_t103_nonzero_and_boolean_index_are_syncs():
    d = TL.lint_step(lambda x: x[x > 0].sum() + torch.nonzero(x).sum(), torch.ones(4))
    assert rules(d) == ["T103"] and "2 host sync(s)" in d[0].message, format_diagnostics(d)


# ---------------------------------------------------------------------------
# recompile audit (T104/T105): pure shape logic, live against the JAX package
# ---------------------------------------------------------------------------


def _both_audits(keys, **kw):
    from paddle_tpu.analysis import trace_lint as JTL

    got = TL.recompile_audit(keys, **kw)
    want = JTL.recompile_audit(keys, **kw)
    assert [(d.rule, d.message) for d in got] == [(d.rule, d.message) for d in want]
    return got


def test_t104_off_ladder_shapes():
    keys = [
        (("x", (32, 17, 8), "float32"),),   # 17 is no rung
        (("x", (32, 32, 8), "float32"),),   # 32 is
    ]
    d = _both_audits(keys)
    assert rules(d) == ["T104"]
    assert "x axis 1: [17]" in d[0].message


def test_t104_silent_on_ladder():
    keys = [(("x", (32, r, 8), "float32"),) for r in (16, 32, 64, 128)]
    assert _both_audits(keys) == []


def test_t105_shape_explosion():
    keys = [(("x", (b, 32, 8), "float32"),) for b in range(1, 40)]
    assert "T105" in rules(_both_audits(keys, max_shapes=10))


def test_audit_accepts_compile_shape_cache():
    from paddle_tpu_torch.core.compiler import CompileShapeCache
    from paddle_tpu_torch.utils.timers import StatSet

    cache = CompileShapeCache("t", stats=StatSet())
    for t in (17, 33):  # unladdered VARYING lengths: one shape per batch
        cache.observe({"x": SeqTensor(torch.zeros(4, t, 3), torch.full((4,), t, dtype=torch.int32))})
    d = TL.recompile_audit(cache)
    assert "T104" in rules(d)
    assert [x.message for x in d] == [x.message for x in _both_audits(list(cache.shapes))]


def test_audit_accepts_feeder_batches():
    batches = [
        {"x": SeqTensor(torch.zeros(4, 16, 3), torch.full((4,), 9, dtype=torch.int32))},
        {"x": SeqTensor(torch.zeros(4, 64, 3), torch.full((4,), 40, dtype=torch.int32))},
    ]
    assert TL.recompile_audit(batches) == []


# ---------------------------------------------------------------------------
# the real steps stay clean
# ---------------------------------------------------------------------------


def _lenet_step(seed=0):
    from paddle_tpu_torch.models.lenet import lenet_cost
    from paddle_tpu_torch.trainer.step import _train_step_body

    reset_auto_names()
    cost, _ = lenet_cost()
    net = CompiledNetwork(Topology([cost]))
    params, state = net.init(0, device="cpu")
    opt = P.optimizer.Adam(learning_rate=1e-3)
    rng = np.random.RandomState(seed)
    batch = {
        "pixel": SeqTensor(torch.from_numpy(rng.rand(8, 784).astype(np.float32))),
        "label": SeqTensor(torch.from_numpy(rng.randint(0, 10, (8,)).astype(np.int32))),
    }
    step = _train_step_body(net, opt)
    return step, (params, state, opt.init(params), batch, 1)


def test_train_step_is_hazard_free():
    """The LeNet train step lints clean: its one host decision (the
    sentinel's) carries a justified ``# trace: allow[T103]`` pragma, and
    without pragmas it is exactly that one sync."""
    step, args = _lenet_step()
    d = TL.lint_step(step, *args)
    assert d == [], format_diagnostics(d)
    raw = TL.lint_step(step, *args, apply_pragmas=False)
    assert rules(raw) == ["T103"] and "1 host sync(s) per step" in raw[0].message
    assert "trainer/step.py" in raw[0].source


def test_train_step_with_host_read_flagged():
    """Control for the clean-step test: the same step with a host read
    spliced in is caught — the linter sees through autograd."""
    step, args = _lenet_step()

    def noisy(params, state, opt_state, batch, rng):
        print(float(batch["pixel"].data.sum()))
        return step(params, state, opt_state, batch, rng)

    d = TL.lint_step(noisy, *args)
    assert rules(d) == ["T103"] and "1 host sync(s)" in d[0].message


def test_trace_leaves_the_inputs_untouched_and_names_layers():
    """The trace runs the in-place step on clones; forward nodes carry
    their layer and site, backward nodes those of the forward op they are
    the gradient of; apply() leaves no layer set behind."""
    step, args = _lenet_step()
    before = {k: {kk: v.clone() for kk, v in d.items()} for k, d in args[0].items()}
    tr = TL.trace_step(step, *args)
    for k, d in args[0].items():
        for kk, v in d.items():
            assert torch.equal(v, before[k][kk]), (k, kk)
    mms = [n for n in tr.graph.nodes if n.op == "call_function"
           and TL.op_name(n) in ("aten.mm", "aten.addmm", "aten.convolution")]
    fwd = [n for n in mms if not n.meta.get("backward")]
    bwd = [n for n in mms if n.meta.get("backward")]
    assert fwd and bwd
    assert all(TL.node_layer(n) for n in fwd + bwd)
    assert all(TL.node_site(n)[0].startswith("paddle_tpu_torch/") for n in fwd)
    for n in bwd:  # each backward GEMM names a layer that has a forward one
        assert TL.node_layer(n) in {TL.node_layer(f) for f in fwd}
    assert getattr(provenance, "layer", None) is None


def test_generator_params_as_argument_no_t102():
    """Satellite twin: the decoder step with its weights passed as an
    ARGUMENT keeps them out of the graph's constants; the closure form
    bakes every weight in (T102)."""
    from paddle_tpu_torch.models.seq2seq import seq2seq_cost

    reset_auto_names()
    cost, _ = seq2seq_cost(40, 45, word_dim=16, hidden_dim=16)
    net = CompiledNetwork(Topology([cost]))
    params, state = net.init(0, device="cpu")
    from paddle_tpu_torch.reader.feeder import DataFeeder

    rng = np.random.RandomState(0)
    feeder = DataFeeder(net.topology.data_types(), device="cpu")
    batch = feeder([(list(rng.randint(2, 40, 6)), list(rng.randint(2, 45, 6)),
                     list(rng.randint(2, 45, 6))) for _ in range(2)])

    def fwd(p, b):
        return net.cost(p, b, state=state, train=False)[0]

    good = TL.lint_graph(TL.trace_step(fwd, params, batch), const_elem_threshold=256)
    assert "T102" not in rules(good), format_diagnostics(good)
    bad = TL.lint_graph(TL.trace_step(lambda b: fwd(params, b), batch),
                        const_elem_threshold=256)
    assert "T102" in rules(bad)


# ---------------------------------------------------------------------------
# T106: buffer-donation audit (the port's donation is an in-place update)
# ---------------------------------------------------------------------------


def _mlp_step_parts():
    reset_auto_names()
    x = P.layer.data("x", P.data_type.dense_vector(64))
    h = P.layer.fc(x, size=256, act=P.activation.Relu())
    pred = P.layer.fc(h, size=10, act=P.activation.Softmax())
    y = P.layer.data("y", P.data_type.integer_value(10))
    cost = P.layer.classification_cost(input=pred, label=y)
    net = CompiledNetwork(Topology([cost]))
    opt = P.optimizer.Adam(learning_rate=1e-3)
    params, state = net.init(0, device="cpu")
    batch = {"x": SeqTensor(torch.zeros(8, 64)), "y": SeqTensor(torch.zeros(8, dtype=torch.int32))}
    return net, opt, (params, state, opt.init(params), batch, 1)


def _out_of_place_body(net, opt):
    """A train step that returns FRESH parameters and slots (the update
    applied to copies): what an undonated jitted step is to the JAX
    package."""
    from paddle_tpu_torch.trainer.step import _train_step_body

    inner = _train_step_body(net, opt, sentinel=False)

    def step(params, state, opt_state, batch, rng):
        fresh = {k: {kk: v.clone() for kk, v in d.items()} for k, d in params.items()}
        slots = {k: ({kk: {kkk: v.clone() for kkk, v in dd.items()} for kk, dd in d.items()}
                     if isinstance(d, dict) else d) for k, d in opt_state.items()}
        return inner(fresh, state, slots, batch, rng)

    return step


def test_t106_undonated_carry_fires():
    """A step that returns its params and Adam slots fresh (not written in
    place) double-buffers them — T106 names the copied argnums."""
    net, opt, args = _mlp_step_parts()
    d = TL.donation_audit(_out_of_place_body(net, opt), *args)
    assert "T106" in rules(d)
    assert any("argument 0" in x.message for x in d), format_diagnostics(d)
    assert any("argument 2" in x.message for x in d), format_diagnostics(d)


def test_t106_explicit_donate_argnums_on_plain_fn():
    """``donate_argnums`` is the caller's promise to drop the old values;
    the shipped body updates in place and needs none."""
    from paddle_tpu_torch.trainer.step import _train_step_body

    net, opt, args = _mlp_step_parts()
    fresh = _out_of_place_body(net, opt)
    assert "T106" in rules(TL.donation_audit(fresh, *args))
    d = TL.donation_audit(fresh, *args, donate_argnums=(0, 1, 2))
    assert d == [], format_diagnostics(d)
    d = TL.donation_audit(_train_step_body(net, opt), *args)
    assert d == [], format_diagnostics(d)


def test_t106_shipped_builders_are_clean():
    """spec (the JAX twin drifts on this jax): make_train_step,
    make_multi_train_step and the epoch program audit clean.  The epoch
    program keeps a snapshot of the carry for its on-device skip — without
    pragmas that is its one T106 finding, at the justified line."""
    from paddle_tpu_torch.trainer.step import (
        make_epoch_program,
        make_multi_train_step,
        make_train_carry,
        make_train_step,
    )

    net, opt, args = _mlp_step_parts()
    params, state, opt_state, batch, rng = args
    assert TL.donation_audit(make_train_step(net, opt), *args) == []
    k = 4
    stacked = {n: SeqTensor(torch.stack([t.data] * k)) for n, t in batch.items()}
    d = TL.donation_audit(make_multi_train_step(net, opt, k), params, state, opt_state,
                          stacked, rng)
    assert d == [], format_diagnostics(d)
    carry = make_train_carry(params, state, opt_state, torch.Generator().manual_seed(0))
    epoch = make_epoch_program(net, opt)
    d = TL.donation_audit(epoch, carry, stacked, torch.arange(k))
    assert d == [], format_diagnostics(d)
    raw = TL.donation_audit(epoch, carry, stacked, torch.arange(k), apply_pragmas=False)
    assert rules(raw) == ["T106"] and "clones" in raw[0].message
    assert raw[0].source == "paddle_tpu_torch/trainer/step.py"


def test_t106_read_only_inputs_never_flag(jax_shim):
    """A large input that is NOT returned (batch data) has no copy to save;
    live against the JAX audit on the same function."""
    import jax.numpy as jnp
    from paddle_tpu.analysis import trace_lint as JTL

    d = TL.donation_audit(lambda w, big: w + big.sum(), torch.zeros(256, 256),
                          torch.zeros(512, 512), donate_argnums=())
    assert all("argument 1" not in x.message for x in d)
    assert any("argument 0" in x.message for x in d)
    want = JTL.donation_audit(lambda w, big: w + big.sum(), jnp.zeros((256, 256)),
                              jnp.zeros((512, 512)), donate_argnums=())
    assert rules(d) == rules(want)
    assert [x.message.split(" carries")[0] for x in d] == \
        [x.message.split(" carries")[0] for x in want]


# ---------------------------------------------------------------------------
# the flash kernels are graph nodes
# ---------------------------------------------------------------------------


def test_flash_custom_ops_are_one_node_per_launch():
    """A Transformer step with flash attention traces one forward and one
    backward custom-op node per attention (encoder self, decoder self,
    decoder cross), each in its layer; on the CPU they run the plain
    versions and count no launch."""
    from paddle_tpu_torch.models.transformer import transformer_cost
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.trainer.step import _train_step_body
    from paddle_tpu_torch.utils import flags

    saved = dict(flags._VALUES)
    flags.set_flag("use_flash_attention", True)
    try:
        reset_auto_names()
        cost, _ = transformer_cost(30, 30, d_model=16, n_heads=2, n_layers=1, d_ff=32)
        net = CompiledNetwork(Topology(cost))
        params, state = net.init(1, device="cpu")
        opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        rng = np.random.RandomState(0)
        feeder = DataFeeder(net.topology.data_types(), {"src_word": 0, "trg_word": 1,
                                                        "trg_next": 2}, device="cpu")
        batch = feeder([tuple(list(rng.randint(2, 30, 128)) for _ in range(3))
                        for _ in range(2)])
        launches = fa.flash_attention.launches
        tr = TL.trace_step(_train_step_body(net, opt), params, state, opt.init(params), batch, 1)
    finally:
        flags._VALUES.clear()
        flags._VALUES.update(saved)
    flash = [n for n in tr.graph.nodes if n.op == "call_function"
             and TL.op_name(n).startswith("paddle_tpu_torch.")]
    fwd = [n for n in flash if TL.op_name(n).endswith("fwd")]
    bwd = [n for n in flash if TL.op_name(n).endswith("bwd")]
    assert len(fwd) == 3 and len(bwd) == 3
    assert sorted(TL.node_layer(n) for n in fwd) == ["dec0_cross", "dec0_self", "enc0_att"]
    assert all(n.meta.get("backward") for n in bwd)
    assert fa.flash_attention.launches == launches


def test_public_names_cover_the_jax_modules():
    """Each ported module exposes the JAX module's public names."""
    import importlib

    from paddle_tpu_torch import analysis

    for mod, extra in (("trace_lint", ("DEFAULT_CONST_ELEMS", "lint_jaxpr", "trace_step",
                                       "lint_step", "donation_audit", "recompile_audit")),
                       ("numerics_lint", ()), ("num_sanitizer", ())):
        jax_mod = importlib.import_module(f"paddle_tpu.analysis.{mod}")
        port = importlib.import_module(f"paddle_tpu_torch.analysis.{mod}")
        want = set(getattr(jax_mod, "__all__", ())) | set(extra)
        assert want <= set(port.__all__), (mod, sorted(want - set(port.__all__)))
        for name in port.__all__:
            assert getattr(port, name) is getattr(analysis, name, getattr(port, name))
