"""The port's config-time graph lint (paddle_tpu_torch/analysis/graph_lint.py)
against the JAX package's (paddle_tpu/analysis/graph_lint.py) on the CPU.

Every topology is built twice from the same builder, once with each
package's DSL, and linted by each package: the (rule, severity, layer)
lists must be equal, and the rule the fixture plants must fire.  The
topologies are the configs of ``tests/configs/``, the model zoo of
``tests/test_graph_lint.py`` and one fixture per G-rule of that file,
rebuilt with the port's DSL.  Also: ``lint_parsed`` with a mesh raises
naming ROADMAP item 6, and ``python -m paddle_tpu_torch lint`` exits 0 on a
clean config, 1 with G002 on a planted dangling input, and 1 with J001 on
a master journal with one corrupt frame.
"""

import contextlib
import importlib
import io
import os
import types

import pytest

import paddle_tpu as jpaddle
import paddle_tpu.activation as jA
import paddle_tpu.layers as jL
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.activation as tA
import paddle_tpu_torch.layers as tL
from paddle_tpu import analysis as janalysis
from paddle_tpu.core import topology as jtopo
from paddle_tpu.core.data_types import integer_value as jint
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.core import topology as ttopo
from paddle_tpu_torch.core.data_types import integer_value as tint
from paddle_tpu_torch.models import seq2seq as tseq2seq

HERE = os.path.dirname(__file__)
CONFIGS = os.path.join(HERE, "configs")



def _models(pkg):
    return types.SimpleNamespace(**{
        m: importlib.import_module(f"{pkg}.models.{m}")
        for m in ("lenet", "resnet", "sequence_tagging", "transformer")})


JAX = types.SimpleNamespace(paddle=jpaddle, L=jL, A=jA, topo=jtopo, analysis=janalysis,
                            integer_value=jint, seq2seq=jseq2seq, models=_models("paddle_tpu"))
PORT = types.SimpleNamespace(paddle=tpaddle, L=tL, A=tA, topo=ttopo, analysis=tanalysis,
                             integer_value=tint, seq2seq=tseq2seq,
                             models=_models("paddle_tpu_torch"))


def triples(diags):
    return [(d.rule, d.severity.name, d.layer) for d in diags]


def lint_both(build):
    """(JAX package's triples, port's triples) of the topology `build(ns)`
    returns as (outputs, lint_topology keyword arguments)."""
    got = []
    for ns in (JAX, PORT):
        ns.topo.reset_auto_names()
        outs, kw = build(ns)
        got.append(triples(ns.analysis.lint_topology(ns.topo.Topology(list(outs)), **kw)))
    return got


# ---------------------------------------------------------------------------
# one builder per G-rule fixture of tests/test_graph_lint.py
# ---------------------------------------------------------------------------


def _mlp(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    h = ns.L.fc(x, size=8, act=ns.A.Tanh(), name="hidden")
    return x, h


def _bad_after_mlp(**conf):
    def build(ns):
        _, h = _mlp(ns)
        return [ns.topo.LayerOutput(ns.topo.LayerConf(**conf), [h])], {}

    return build


def _g004_addto(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    a, b = ns.L.fc(x, size=8, name="a"), ns.L.fc(x, size=12, name="b")
    return [ns.topo.LayerOutput(
        ns.topo.LayerConf(name="sum", type="addto", size=8, inputs=("a", "b")), [a, b])], {}


def _g004_gru(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    gates = ns.L.fc(x, size=16, name="gates")  # needs 3 * size = 24
    state = ns.L.fc(x, size=8, name="state")
    return [ns.topo.LayerOutput(
        ns.topo.LayerConf(name="gru", type="gru_step", size=8, inputs=("gates", "state")),
        [gates, state])], {}


def _g005(ns):
    x, h = _mlp(ns)
    ns.L.fc(x, size=4, name="orphan")  # built, reaches no output
    return [h], {"created": ["x", "hidden", "orphan"]}


def _g006(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    y = ns.L.data("y", ns.paddle.data_type.dense_vector(12))
    a = ns.L.fc(x, size=8, name="a", param_attr=ns.paddle.attr.ParamAttr(name="shared"))
    b = ns.L.fc(y, size=8, name="b", param_attr=ns.paddle.attr.ParamAttr(name="shared"))
    return [ns.L.concat([a, b], name="cat")], {}


def _g009(bucketing):
    def build(ns):
        _, h = _mlp(ns)
        bad = ns.topo.LayerOutput(ns.topo.LayerConf(
            name="dyn", type="fc", size=8, inputs=("hidden",),
            attrs={"dynamic_width_in": (0,)}), [h])
        return [bad], {"bucketing": bucketing}

    return build


def _g009_group(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    inner = ns.topo.LayerOutput(ns.topo.LayerConf(
        name="dyn", type="fc", size=8, inputs=(), attrs={"dynamic_width_in": (0,)}))
    group = ns.topo.LayerOutput(ns.topo.LayerConf(
        name="grp", type="recurrent_group", size=8, inputs=("x",),
        attrs={"_sub_topology": ns.topo.Topology([inner])}), [x])
    return [group], {"bucketing": True}


def _g010(drop):
    def build(ns):
        L, A = ns.L, ns.A
        enc, enc_proj, boot = ns.seq2seq._encoder_and_boot(30, 8, 8)
        trg = L.data("trg_word", ns.paddle.data_type.integer_value_sequence(30))
        trg_emb = L.embedding(trg, size=8, name="trg_emb")

        def step(trg_emb_t, enc_seq, enc_p):
            state = L.memory("dec_state", 8, boot_layer=boot)
            context = ns.paddle.networks.simple_attention(
                encoded_sequence=enc_seq, encoded_proj=enc_p, decoder_state=state, name="att")
            extra = {"layer_attr": ns.paddle.attr.ExtraAttr(drop_rate=drop)} if drop else {}
            inputs = L.fc([context, trg_emb_t], size=24, act=A.Identity(), bias_attr=False,
                          name="dec_in_proj", **extra)
            gru = L.gru_step(inputs, state, size=8, name="dec_state")
            return L.fc(gru, size=30, act=A.Softmax(), name="dec_out")

        return [L.recurrent_group(
            step, [trg_emb, L.StaticInput(enc, is_seq=True),
                   L.StaticInput(enc_proj, is_seq=True)], name="decoder")], {}

    return build


def _g011(ns):
    conf = ns.topo.LayerConf(name="w", type="data", size=10,
                             input_type=ns.paddle.data_type.dense_vector(10),
                             attrs={"_v1_unresolved": "provider module not importable"})
    lo = ns.topo.LayerOutput(conf)
    return [ns.topo.LayerOutput(
        ns.topo.LayerConf(name="fc", type="fc", size=4, inputs=("w",)), [lo])], {}


def _g015(ns):
    return [ns.topo.LayerOutput(ns.topo.LayerConf(
        name="pix", type="data", size=784,
        input_type=ns.paddle.data_type.dense_vector(100)))], {}


def _g017(ns):
    x = ns.L.data("x", ns.paddle.data_type.dense_vector(8))
    pred = ns.L.fc(x, size=10, act=ns.A.Softmax(), name="pred")
    lbl = ns.topo.LayerOutput(ns.topo.LayerConf(name="lbl", type="data", size=7,
                                                input_type=ns.integer_value(7)))
    return [ns.topo.LayerOutput(ns.topo.LayerConf(
        name="ce", type="cross_entropy", size=1, inputs=("pred", "lbl"), bias=False),
        [pred, lbl])], {}


RULE_FIXTURES = {
    "G001": (_bad_after_mlp(name="mystery", type="warp_drive", size=8, inputs=("hidden",)),
             "G001"),
    "G002": (_bad_after_mlp(name="sum", type="addto", size=8,
                            inputs=("hidden", "ghost_layer")), "G002"),
    "G003": (_bad_after_mlp(name="gru", type="gru_step", size=8, inputs=("hidden",)), "G003"),
    "G004_addto": (_g004_addto, "G004"),
    "G004_gru_gates": (_g004_gru, "G004"),
    "G005": (_g005, "G005"),
    "G006": (_g006, "G006"),
    "G007": (_bad_after_mlp(name="opt", type="fc", size=8, inputs=("hidden",),
                            attrs={"kernel_sz": 3}), "G007"),
    "G008": (_bad_after_mlp(name="wide", type="fc", size=8, inputs=("hidden",),
                            shard_axis="tensor"), "G008"),
    "G009": (_g009(True), "G009"),
    "G009_off": (_g009(False), None),
    "G009_group": (_g009_group, "G009"),
    "G010": (_g010(0.3), "G010"),
    "G010_fuses": (_g010(0.0), None),
    "G011": (_g011, "G011"),
    "G013": (_bad_after_mlp(name="act", type="fc", size=8, inputs=("hidden",),
                            act="quantum"), "G013"),
    "G014": (_bad_after_mlp(name="drp", type="fc", size=8, inputs=("hidden",),
                            drop_rate=1.5), "G014"),
    "G015": (_g015, "G015"),
    "G017": (_g017, "G017"),
}


@pytest.mark.parametrize("name", sorted(RULE_FIXTURES))
def test_rule_fixture_diagnostics_equal_the_jax_package(name):
    build, rule = RULE_FIXTURES[name]
    jax_diags, port_diags = lint_both(build)
    assert port_diags == jax_diags
    if rule is None:
        assert port_diags == []
    else:
        assert rule in [r for r, _, _ in port_diags], port_diags


def _zoo():
    return {
        "lenet": lambda ns: list(ns.models.lenet.lenet_cost()),
        "resnet18": lambda ns: [ns.models.resnet.resnet_cost(depth=18, class_num=10,
                                                             img_size=32)[0]],
        "seq2seq": lambda ns: [ns.seq2seq.seq2seq_cost(40, 45, word_dim=16, hidden_dim=16)[0]],
        "ner_crf": lambda ns: list(ns.models.sequence_tagging.ner_crf_cost(60, 5)),
        "transformer": lambda ns: [ns.models.transformer.transformer_cost(
            src_vocab=50, trg_vocab=50, n_layers=1, d_model=32, n_heads=4, d_ff=64)],
        "transformer_moe": lambda ns: [ns.models.transformer.transformer_cost(
            src_vocab=50, trg_vocab=50, n_layers=1, d_model=32, n_heads=4, d_ff=64,
            moe_experts=4)],
    }


@pytest.mark.parametrize("name", sorted(_zoo()))
def test_model_zoo_lints_clean_in_both(name):
    def build(ns):
        outs = _zoo()[name](ns)
        return [o for o in outs if isinstance(o, ns.topo.LayerOutput)], {}

    jax_diags, port_diags = lint_both(build)
    assert port_diags == jax_diags == []


@pytest.mark.parametrize("cfg", sorted(f for f in os.listdir(CONFIGS) if f.endswith(".py")))
def test_config_corpus_lints_equal_and_clean(cfg):
    from paddle_tpu.v1_compat import parse_config as jparse
    from paddle_tpu_torch.v1_compat import parse_config as tparse

    path = os.path.join(CONFIGS, cfg)
    jax_diags = triples(janalysis.lint_parsed(jparse(path)))
    port_diags = triples(tanalysis.lint_parsed(tparse(path)))
    assert port_diags == jax_diags == []


def test_duplicate_name_and_feed_errors_raise_as_in_the_jax_package():
    for ns in (JAX, PORT):
        ns.topo.reset_auto_names()
        x = ns.L.data("x", ns.paddle.data_type.dense_vector(4))
        a = ns.topo.LayerOutput(ns.topo.LayerConf(name="twin", type="fc", size=4,
                                                  inputs=("x",)), [x])
        b = ns.topo.LayerOutput(ns.topo.LayerConf(name="twin", type="fc", size=8,
                                                  inputs=("x",)), [x])
        cat = ns.topo.LayerOutput(ns.topo.LayerConf(name="cat", type="concat", size=12,
                                                    inputs=("twin", "twin")), [a, b])
        with pytest.raises(ns.analysis.DiagnosticError) as ei:
            ns.topo.Topology([cat])
        assert ei.value.rules == ["G016"]
        outs, _ = _g011(ns)
        with pytest.raises(ns.analysis.DiagnosticError) as ei:
            ns.topo.Topology(outs).data_types()
        assert ei.value.rules == ["G011"]


def test_lint_with_a_mesh_raises_naming_item_6():
    from paddle_tpu_torch.v1_compat import parse_config

    parsed = parse_config(os.path.join(CONFIGS, "demo_mnist_mlp.py"))
    with pytest.raises(NotImplementedError, match="item 6"):
        tanalysis.lint_parsed(parsed, mesh=object())


# ---------------------------------------------------------------------------
# python -m paddle_tpu_torch lint: exit codes
# ---------------------------------------------------------------------------

_DANGLING = """
from paddle.trainer_config_helpers import *

x = data_layer(name="x", size=8)
hidden = fc_layer(input=x, size=8, act=TanhActivation(), name="hidden")
bad = LayerOutput(LayerConf(name="sum", type="addto", size=8,
                            inputs=("hidden", "ghost_layer")), [hidden])
outputs(bad)
"""


def _lint(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["lint"] + argv)
    return rc, out.getvalue()


def test_lint_config_exit_codes(tmp_path):
    rc, out = _lint(["--config", os.path.join(CONFIGS, "demo_text_lstm.py")])
    assert rc == 0 and "no diagnostics" in out
    bad = tmp_path / "dangling.py"
    bad.write_text(_DANGLING)
    rc, out = _lint(["--config", str(bad)])
    assert rc == 1 and "error[G002]" in out and "ghost_layer" in out
    # --min-severity filters, and a warning-only config is filtered to clean
    rc, out = _lint(["--config", os.path.join(CONFIGS, "demo_mnist_mlp.py"),
                     "--min-severity", "error"])
    assert rc == 0
    # no mode is the self-lint of the port's source, which is clean
    rc, out = _lint([])
    assert rc == 0 and "no diagnostics" in out
    # the traced-step modes combine with the graph lint of --config; they
    # trace on the card unless --device=cpu (no card here: the device error)
    rc, out = _lint(["--donation", "--device=cpu", "--config", str(bad)])
    assert rc == 1 and "error[G002]" in out and "0 T106 finding(s)" in out
    assert _lint(["--numerics"])[0] == 1


def test_lint_journal_exit_codes(tmp_path):
    from paddle_tpu_torch.master_journal import JournalWriter

    path = str(tmp_path / "master_journal-000001.log")
    w = JournalWriter(path, fsync=False)
    for i in range(3):
        w.append(i + 1, {"t": "join", "worker": f"w{i}"})
    w.close()
    rc, out = _lint(["--journal", path])
    assert rc == 0 and "no diagnostics" in out, out
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # one corrupt frame in the middle
    open(path, "wb").write(bytes(raw))
    rc, out = _lint(["--journal", path])
    assert rc == 1 and "J001" in out, out
