"""The port's v1 front end against the JAX package on the CPU (f32):

- ``parse_config(...).topology.serialize()`` is byte-identical to the JAX
  package's for the three shipped demo configs (the MNIST MLP also with
  ``is_predict=1``), a callable config and the model zoo builds both
  packages have;
- the three demos train 3 steps through the port's ``v1_compat`` (the
  parsed topology and ``make_optimizer(settings)``) with dropout off, from
  the JAX package's parameters: the costs agree at rtol 1e-5;
- a v1 config with a ``@provider`` data provider trains through
  ``make_provider_reader``, ``DataFeeder`` and ``SGD.train`` in both
  packages with the same costs, and ``make_batched_reader`` buckets alike;
- the provider cases of ``tests/test_v1_compat.py`` (positional binding
  with a feeding map, a label-first config, first-sample inference, an
  explicit ``Inputs``) give the same feeding order and slot types;
- ``make_optimizer`` maps settings to the same rule and hyperparameters;
- the raw-face cases (a CRF sharing a parameter, a raw recurrent group, a
  malformed group that must not poison the next parse) agree;
- a JAX -> port -> JAX parse sequence in one process builds each package's
  own Topology from its own layers (the shared ``paddle`` import shim).
No case needs a download or a reference checkout: every config and
provider is written here."""

import importlib
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import v1_compat as JV
from paddle_tpu.core.batch import SeqTensor as JSeq
from paddle_tpu.core.compiler import CompiledNetwork as JNet
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer import step as jstep
from paddle_tpu_torch import v1_compat as TV
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.trainer import step as tstep
from test_torch_parity import build_both, carry, numpy_tree, rel_l2

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(HERE, "configs")
RTOL = 1e-5


def _parse_both(config, arg=""):
    return JV.parse_config(config, arg), TV.parse_config(config, arg)


@pytest.mark.parametrize("name,arg", [("demo_mnist_mlp", ""), ("demo_mnist_mlp", "is_predict=1"),
                                      ("demo_text_lstm", ""), ("demo_seq2seq_attention", "")])
def test_demo_configs_serialize_identically(name, arg):
    j, t = _parse_both(os.path.join(CONFIGS, name + ".py"), arg)
    assert t.serialize() == j.serialize()
    assert type(t.topology).__module__ == "paddle_tpu_torch.core.topology"
    assert t.output_layers == j.output_layers and t.all_layer_names == j.all_layer_names
    assert list(t.topology.data_layers()) == list(j.topology.data_layers())


def _callable_config():
    import paddle.trainer_config_helpers as H

    H.settings(batch_size=8, learning_rate=1e-2, learning_method=H.MomentumOptimizer(0.9))
    words = H.data_layer(name="w", size=50)
    emb = H.embedding_layer(input=words, size=8)
    fw = H.simple_gru(input=emb, size=8)
    bw = H.simple_lstm(input=emb, size=8, reverse=True)
    pooled = H.pooling_layer(input=H.concat_layer(input=[fw, bw]), pooling_type=H.AvgPooling())
    scaled = H.layer_math.tanh(pooled) * 0.5 + pooled
    pred = H.fc_layer(input=scaled, size=3, act=H.SoftmaxActivation())
    H.outputs(H.classification_cost(input=pred, label=H.data_layer(name="y", size=3)))


def test_callable_config_serializes_identically():
    j, t = _parse_both(_callable_config)
    assert t.serialize() == j.serialize()
    assert t.settings.learning_rate == j.settings.learning_rate == 1e-2


def _zoo(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.models.{name}")


ZOO = {
    "lenet": lambda pkg: _zoo(pkg, "lenet").lenet_cost(10)[0],
    "resnet": lambda pkg: _zoo(pkg, "resnet").resnet_cost(depth=18, class_num=8, img_size=32)[0],
    "seq2seq": lambda pkg: _zoo(pkg, "seq2seq").seq2seq_cost(30, 40, 8, 12)[0],
    "seq2seq_generation": lambda pkg: _zoo(pkg, "seq2seq").seq2seq_generation(
        30, 40, 8, 12, bos_id=0, eos_id=1, beam_size=3, max_length=6),
    "sequence_tagging": lambda pkg: _zoo(pkg, "sequence_tagging").ner_crf_cost(60, 5)[0],
    "transformer": lambda pkg: _zoo(pkg, "transformer").transformer_cost(
        20, 20, d_model=16, n_heads=2, n_layers=2, d_ff=32)[0],
}


@pytest.mark.parametrize("model", sorted(ZOO))
def test_model_zoo_serializes_identically(model):
    jout, tout = build_both(ZOO[model])
    jt = paddle_tpu.Topology(jout if isinstance(jout, list) else [jout])
    tt = paddle_tpu_torch.Topology(tout if isinstance(tout, list) else [tout])
    assert tt.serialize() == jt.serialize()


# -- the demos train through v1_compat ----------------------------------------

def _demo_samples(name, rs, n):
    if name == "demo_mnist_mlp":
        types = lambda dt: [("pixel", dt.dense_vector(784)), ("label", dt.integer_value(10))]  # noqa: E731
        return types, [(rs.randn(784).astype(np.float32), int(rs.randint(0, 10)))
                       for _ in range(n)]
    if name == "demo_text_lstm":
        types = lambda dt: [("word", dt.integer_value_sequence(100)),  # noqa: E731
                            ("label", dt.integer_value(2))]
        return types, [(rs.randint(0, 100, size=rs.randint(3, 12)).tolist(),
                        int(rs.randint(0, 2))) for _ in range(n)]
    types = lambda dt: [("src_word", dt.integer_value_sequence(40)),  # noqa: E731
                        ("trg_word", dt.integer_value_sequence(45)),
                        ("trg_next", dt.integer_value_sequence(45))]
    out = []
    for _ in range(n):
        t = rs.randint(2, 9)
        trg = rs.randint(0, 45, size=t + 1).tolist()
        out.append((rs.randint(0, 40, size=rs.randint(3, 10)).tolist(), trg[:-1], trg[1:]))
    return types, out


@pytest.mark.parametrize("name", ["demo_mnist_mlp", "demo_text_lstm", "demo_seq2seq_attention"])
def test_demo_configs_train_alike(name):
    j, t = _parse_both(os.path.join(CONFIGS, name + ".py"))
    rs = np.random.RandomState(17)
    types, samples = _demo_samples(name, rs, 3 * 8)
    jnet, tnet = JNet(j.topology, compute_dtype=jnp.float32), TNet(t.topology,
                                                                  compute_dtype=torch.float32)
    jparams = paddle_tpu.parameters.create(j.topology.outputs, seed=5)
    tp = carry(jparams)
    jopt, topt = JV.make_optimizer(j.settings), TV.make_optimizer(t.settings)
    # the port's parameters first: the JAX step donates its inputs
    tparams, tstate, tos = tp.params, tp.state, topt.init(tp.params)
    jpar, jstate, jos = jparams.params, jparams.state, jopt.init(jparams.params)
    jrun = jstep.make_train_step(jnet, jopt, mesh=None)
    trun = tstep.make_train_step(tnet, topt)
    jfeed = JFeeder(types(paddle_tpu.data_type))
    tfeed = TFeeder(types(paddle_tpu_torch.data_type), device="cpu")
    jc, tc = [], []
    for step in range(3):
        rows = samples[step * 8:(step + 1) * 8]
        jb = {k: JSeq(jnp.asarray(v.data), None if v.lengths is None else jnp.asarray(v.lengths))
              for k, v in jfeed(rows).items()}
        tparams, tstate, tos, tm = trun(tparams, tstate, tos, tfeed(rows), None)
        jpar, jstate, jos, jm = jrun(jpar, jstate, jos, jb, None)  # dropout off: no key
        jc.append(float(jm["cost"]))
        tc.append(float(tm["cost"]))
    print(name, "costs JAX", jc, "port", tc)
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    assert rel_l2(tparams, numpy_tree(jpar)) <= 1e-4


# -- a provider-fed config, as bench.py runs one --------------------------------

_TEXTCLS = """
from paddle.trainer_config_helpers import *

hidden = get_config_arg("hidden_size", int, 8)
lstm_num = get_config_arg("lstm_num", int, 1)
batch_size = get_config_arg("batch_size", int, 4)
settings(batch_size=batch_size, learning_rate=5e-3, learning_method=AdamOptimizer())
define_py_data_sources2("train.list", None, module="provider", obj="process",
                        args={"vocab": 30})
net = data_layer("data", 30)
net = embedding_layer(input=net, size=8)
for i in range(lstm_num):
    net = simple_lstm(input=net, size=hidden)
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer("label", 2)
outputs(classification_cost(input=net, label=lab))
"""

_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

def hook(settings, vocab, **kwargs):
    settings.vocab = vocab
    settings.input_types = [integer_value_sequence(vocab), integer_value(2)]

@provider(init_hook=hook, should_shuffle=False)
def process(settings, path):
    with open(path, "rb") as f:
        x, y = pickle.load(f)  # the rnn benchmark's schema: (token lists, labels)
    for ids, label in zip(x, y):
        yield [int(i) % settings.vocab for i in ids], int(label)
"""


def _write_textcls(d, n=16):
    import pickle

    rs = np.random.RandomState(0)
    lengths = rs.randint(3, 12, size=n)
    data = ([rs.randint(0, 30, size=k).tolist() for k in lengths],
            rs.randint(0, 2, size=n).tolist())
    with open(os.path.join(d, "reviews.pkl"), "wb") as f:
        pickle.dump(data, f)
    with open(os.path.join(d, "train.list"), "w") as f:
        f.write("reviews.pkl\n")
    with open(os.path.join(d, "provider.py"), "w") as f:
        f.write(textwrap.dedent(_PROVIDER))
    with open(os.path.join(d, "textcls.py"), "w") as f:
        f.write(textwrap.dedent(_TEXTCLS))
    return os.path.join(d, "textcls.py")


def test_provider_config_trains_alike(tmp_path):
    cfg = _write_textcls(str(tmp_path))
    args = "hidden_size=8,lstm_num=2,batch_size=4"
    j, t = _parse_both(cfg, args)
    assert t.serialize() == j.serialize()
    assert t.topology.data_types() == [(n, paddle_tpu_torch.data_type.integer_value_sequence(30))
                                       if n == "data" else (n, paddle_tpu_torch.data_type
                                                            .integer_value(2))
                                       for n, _ in t.topology.data_types()]
    jparams = paddle_tpu.parameters.create(j.topology.outputs, seed=1)
    costs = []
    for pkg, V, p, params, kw in ((paddle_tpu_torch, TV, t, carry(jparams), {"device": "cpu"}),
                                  (paddle_tpu, JV, j, jparams, {})):
        rd = V.make_provider_reader(p, str(tmp_path))
        trainer = pkg.trainer.SGD(p.topology, params, V.make_optimizer(p.settings), **kw)
        got = []
        trainer.train(pkg.batch(rd, p.settings.batch_size), num_passes=1, feeding=p.feeding,
                      event_handler=lambda e, g=got, m=pkg: g.append(e.cost)
                      if isinstance(e, m.event.EndIteration) else None)
        costs.append(got)
    assert len(costs[0]) == 4
    np.testing.assert_allclose(costs[0], costs[1], rtol=RTOL)


def test_batched_reader_buckets_alike(tmp_path):
    cfg = _write_textcls(str(tmp_path), n=40)
    j, t = _parse_both(cfg)
    jf, tf = paddle_tpu.utils.flags, paddle_tpu_torch.flags
    saved_j, saved_t = dict(jf._VALUES), dict(tf._VALUES)
    try:
        for f in (jf, tf):
            f.set_flag("use_bucketing", True)
            f.set_flag("bucketing_token_budget", 32)
        jb = list(JV.make_batched_reader(j, str(tmp_path), 4)())
        tb = list(TV.make_batched_reader(t, str(tmp_path), 4)())
    finally:
        for f, saved in ((jf, saved_j), (tf, saved_t)):
            f._VALUES.clear()
            f._VALUES.update(saved)
    assert tb == jb and len(tb) > 1


# -- the provider cases of tests/test_v1_compat.py ------------------------------

_PROVIDER_CASES = {
    "positional": ("""
        from paddle.trainer_config_helpers import *
        define_py_data_sources2(train_list='t', test_list=None, module='prov_mod', obj='process')
        settings(batch_size=4, learning_rate=1e-3, learning_method=MomentumOptimizer())
        lbl = data_layer(name='label', size=10)
        img = data_layer(name='pixel', size=784)
        fc1 = fc_layer(input=img, size=10, act=SoftmaxActivation())
        outputs(classification_cost(input=fc1, label=lbl))
        """, "prov_mod", """
        from paddle.trainer.PyDataProvider2 import *
        @provider(input_types=[integer_value(10), dense_vector(784)])
        def process(settings, f):
            yield 0, [0.0] * 784
        """),
    "label_first": ("""
        from paddle.trainer_config_helpers import *
        define_py_data_sources2(train_list='t', test_list=None, module='prov_lf', obj='process')
        settings(batch_size=4, learning_rate=1e-3, learning_method=MomentumOptimizer())
        lbl = data_layer(name='label', size=10)
        img = data_layer(name='input', size=48)
        fc1 = fc_layer(input=img, size=10, act=SoftmaxActivation())
        outputs(classification_cost(input=fc1, label=lbl))
        """, "prov_lf", """
        from paddle.trainer.PyDataProvider2 import *
        def hook(settings, **kw):
            settings.slots = [dense_vector(48), integer_value(10)]
        @provider(init_hook=hook)
        def process(settings, f):
            for i in range(8):
                yield [0.1] * 48, i % 10
        """),
    "first_sample": ("""
        from paddle.trainer_config_helpers import *
        define_py_data_sources2(train_list='t', test_list=None, module='prov_inf', obj='process')
        settings(batch_size=4, learning_rate=1e-3)
        lbl = data_layer(name='label', size=7)
        img = data_layer(name='input', size=32)
        emb = embedding_layer(input=data_layer(name='ids', size=32), size=8)
        pooled = pooling_layer(input=emb, pooling_type=SumPooling())
        fc1 = fc_layer(input=[img, pooled], size=7, act=SoftmaxActivation())
        outputs(classification_cost(input=fc1, label=lbl))
        """, "prov_inf", """
        from paddle.trainer.PyDataProvider2 import *
        @provider()
        def process(settings, f):
            for i in range(8):
                yield [0.1] * 32, [3] * 32, i % 7
        """),
    "explicit_inputs": ("""
        from paddle.trainer_config_helpers import *
        settings(batch_size=4, learning_rate=1e-3)
        lbl = data_layer(name='label', size=10)
        img = data_layer(name='pixel', size=16)
        Inputs('label', 'pixel')
        fc1 = fc_layer(input=img, size=10, act=SoftmaxActivation())
        outputs(classification_cost(input=fc1, label=lbl))
        """, None, None),
}


@pytest.mark.filterwarnings("ignore:.*unique dim-consistent assignment")
@pytest.mark.parametrize("case", sorted(_PROVIDER_CASES))
def test_provider_cases_bind_alike(case, tmp_path):
    conf, mod, prov = _PROVIDER_CASES[case]
    (tmp_path / "conf.py").write_text(textwrap.dedent(conf))
    if mod:
        (tmp_path / f"{mod}.py").write_text(textwrap.dedent(prov))
    j, t = _parse_both(str(tmp_path / "conf.py"))
    assert t.serialize() == j.serialize()
    assert t.feeding == j.feeding
    assert list(t.topology.data_layers()) == list(j.topology.data_layers())
    assert [(n, repr(ty)) for n, ty in t.topology.data_types()] == \
        [(n, repr(ty)) for n, ty in j.topology.data_types()]
    if mod is None:
        return
    sample = next(iter(TV.make_provider_reader(t, str(tmp_path), train=False)()))
    jb = JFeeder(j.topology.data_types(), j.feeding)([sample])
    tb = TFeeder(t.topology.data_types(), t.feeding, device="cpu")([sample])
    for k in jb:
        assert np.array_equal(tb[k].data.numpy(), np.asarray(jb[k].data)), k


SETTINGS = [
    "settings(batch_size=16, learning_rate=0.1)",
    "settings(batch_size=16, learning_rate=0.1, learning_method=MomentumOptimizer(0.9),"
    " regularization=L2Regularization(1e-4), gradient_clipping_threshold=5.0)",
    "settings(batch_size=32, learning_rate=2e-3, learning_method=AdamOptimizer(beta1=0.8),"
    " learning_rate_schedule='poly', learning_rate_decay_a=0.1, learning_rate_decay_b=0.5)",
    "settings(batch_size=8, learning_rate=1e-2, learning_method=AdaGradOptimizer(),"
    " regularization=L1Regularization(1e-5), model_average=ModelAverage(0.5))",
    "settings(batch_size=8, learning_rate=1e-2, learning_method=RMSPropOptimizer(rho=0.9))",
    "settings(batch_size=8, learning_rate=1e-2, learning_method=AdaDeltaOptimizer())",
    "settings(batch_size=8, learning_rate=1e-2, learning_method=DecayedAdaGradOptimizer())",
    "settings(batch_size=8, learning_rate=1e-2, learning_method=AdamaxOptimizer())",
]


def _describe(opt):
    def norm(v):
        if callable(v):  # a learning-rate schedule: its f32 values at a few steps
            return [float(np.float32(v(s))) for s in (0, 1, 10, 1000)]
        if hasattr(v, "__dict__"):
            return (type(v).__name__, {k: norm(x) for k, x in sorted(vars(v).items())})
        return v
    return type(opt).__name__, {k: norm(v) for k, v in sorted(vars(opt).items())
                                if not k.startswith("_")}


@pytest.mark.parametrize("line", SETTINGS)
def test_make_optimizer_maps_settings_alike(line, tmp_path):
    cfg = tmp_path / "conf.py"
    cfg.write_text("from paddle.trainer_config_helpers import *\n" + line + "\n"
                   "x = data_layer(name='x', size=4)\n"
                   "outputs(fc_layer(input=x, size=2))\n")
    j, t = _parse_both(str(cfg))
    assert _describe(TV.make_optimizer(t.settings)) == _describe(JV.make_optimizer(j.settings))


# -- the raw face ----------------------------------------------------------------

def _raw_crf():
    import paddle.trainer_config_helpers as H

    H.Layer(name="word", type="data", size=30)
    H.Layer(name="chunk", type="data", size=5)
    H.Layer(name="emb", type="mixed", size=8, bias=False,
            inputs=[H.TableProjection("word", parameter_name="emb_w")])
    H.Layer(name="output", type="fc", size=5, active_type="", bias=True,
            inputs=[H.Input("emb", parameter_name="out_w")])
    H.Layer(name="crf", type="crf", size=5, inputs=[H.Input("output", parameter_name="crfw"),
                                                    H.Input("chunk")])
    H.Layer(name="crf_decoding", type="crf_decoding", size=5,
            inputs=[H.Input("output", parameter_name="crfw"), H.Input("chunk")])
    H.Evaluator(name="error", type="sum", inputs="crf_decoding")
    H.settings(batch_size=4, learning_rate=1e-3)
    H.Inputs("word", "chunk")
    H.Outputs("crf")


def test_raw_face_crf_shares_its_parameter_alike():
    j, t = _parse_both(_raw_crf)
    assert t.serialize() == j.serialize() and t.output_layers == ["crf"]
    assert len(t.evaluators) == len(j.evaluators) == 1
    rs = np.random.RandomState(0)
    lens = np.asarray([5, 3], np.int32)
    word = rs.randint(0, 30, size=(2, 8)).astype(np.int32)
    chunk = rs.randint(0, 5, size=(2, 8)).astype(np.int32)
    jnet = JNet(j.topology, compute_dtype=jnp.float32)
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    tnet = TNet(t.topology, compute_dtype=torch.float32)
    assert sorted(jparams) == sorted(tnet.init_params(0, device="cpu"))
    jb = {"word": JSeq(jnp.asarray(word), jnp.asarray(lens)),
          "chunk": JSeq(jnp.asarray(chunk), jnp.asarray(lens))}
    tb = {"word": paddle_tpu_torch.core.batch.seq(word, lens),
          "chunk": paddle_tpu_torch.core.batch.seq(chunk, lens)}
    jouts, _ = jnet.apply(jparams, jb, state=jstate, train=False)
    tparams = paddle_tpu_torch.parameters.from_numpy(numpy_tree(jparams), {}, device="cpu").params
    touts, _ = tnet.apply(tparams, tb, state={}, train=False)
    assert rel_l2(touts["crf"].data, np.asarray(jouts["crf"].data)) <= RTOL


def _raw_group():
    import paddle.trainer_config_helpers as H

    H.Layer(name="in", type="data", size=6)
    H.RecurrentLayerGroupBegin("g_layer_group", in_links=["in"], out_links=["g"])
    mem = H.Memory(name="g", size=6)
    H.Layer(name="g", type="mixed", size=6, active_type="tanh", bias=False,
            inputs=[H.IdentityProjection("in"), H.FullMatrixProjection(mem, parameter_name="rec_w")])
    H.RecurrentLayerGroupEnd("g_layer_group")
    H.settings(batch_size=4, learning_rate=1e-3)
    H.Outputs("g")


def test_raw_face_recurrent_group_alike():
    j, t = _parse_both(_raw_group)
    assert t.serialize() == j.serialize()
    rs = np.random.RandomState(0)
    x = rs.randn(2, 4, 6).astype(np.float32)
    lens = np.asarray([4, 2], np.int32)
    jnet = JNet(j.topology, compute_dtype=jnp.float32)
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    jouts, _ = jnet.apply(jparams, {"in": JSeq(jnp.asarray(x), jnp.asarray(lens))},
                          state=jstate, train=False)
    tnet = TNet(t.topology, compute_dtype=torch.float32)
    tparams = paddle_tpu_torch.parameters.from_numpy(numpy_tree(jparams), {}, device="cpu").params
    touts, _ = tnet.apply(tparams, {"in": paddle_tpu_torch.core.batch.seq(x, lens)}, state={},
                          train=False)
    name = t.output_layers[0]
    mask = (np.arange(4)[None, :] < lens[:, None])[..., None]
    assert rel_l2(touts[name].data.numpy() * mask, np.asarray(jouts[name].data) * mask) <= RTOL


def test_malformed_raw_group_does_not_poison_the_next_parse():
    from paddle_tpu_torch.layers import memory as dsl_memory
    from paddle_tpu_torch.v1_compat import config_helpers as H

    def bad():
        H.Layer(name="in", type="data", size=4)
        H.RecurrentLayerGroupBegin("g_layer_group", in_links=["in"], out_links=["g"])
        H.Layer(name="g", type="no_such_type", size=4)

    with pytest.raises(KeyError):
        TV.parse_config(bad)

    def good():
        H.Layer(name="in", type="data", size=4)
        H.RecurrentLayerGroupBegin("g2_layer_group", in_links=["in"], out_links=["g2"])
        mem = H.Memory(name="g2", size=4)
        H.Layer(name="g2", type="mixed", size=4, active_type="tanh", bias=False,
                inputs=[H.IdentityProjection("in"), H.FullMatrixProjection(mem)])
        H.RecurrentLayerGroupEnd("g2_layer_group")
        H.settings(batch_size=4, learning_rate=1e-3)
        H.Outputs("g2")

    p = TV.parse_config(good)
    assert p.output_layers == ["g2_layer_group"]
    with pytest.raises(RuntimeError, match="inside a recurrent_group"):
        dsl_memory(name="x", size=3)


def test_import_shim_rebinds_per_package():
    """JAX -> port -> JAX in one process: each parse builds its own
    package's Topology from its own layers, and each package accepts the
    other's `paddle` shim module."""
    import sys

    cfg = os.path.join(CONFIGS, "demo_text_lstm.py")
    seq = [JV, TV, JV, TV]
    for V in seq:
        p = V.parse_config(cfg)
        pkg = V.__name__.split(".")[0]
        assert type(p.topology).__module__ == f"{pkg}.core.topology"
        assert sys.modules["paddle.trainer_config_helpers"].__name__ == f"{pkg}.v1_compat.config_helpers"
        assert sys.modules["paddle.trainer.PyDataProvider2"].__name__ == f"{pkg}.data_provider"
        for conf in p.topology.layers.values():
            assert type(conf).__module__ == f"{pkg}.core.topology"
    assert getattr(sys.modules["paddle"], "__paddle_tpu_shim__", False)
