"""Package rules of the port: paddle_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package (every module, the evaluators and checkpoints
included), and the entry points run on the card unless the caller asks for
the CPU (raising, not falling back, without one)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.reader.feeder import DataFeeder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["paddle_tpu"] = None   # and so does any `import paddle_tpu...`
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "jaxlib" or m.startswith(("jax.", "jaxlib.", "paddle_tpu."))]
assert not bad, bad
print(len(names))
print(" ".join(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, names = proc.stdout.strip().splitlines()
    assert int(count) >= 25  # every module of the package was walked
    for mod in ("layers.conv", "models.lenet", "models.resnet", "pooling", "evaluator",
                "checkpoint", "trainer.step", "optimizer", "ops.rnn", "layers.recurrent_group",
                "layers.sequence", "layers.networks", "models.seq2seq", "reader.bucketing",
                "ops.beam", "layers.generation", "serving", "serving.engine", "serving.pages",
                "serving.scheduler", "utils.timers", "layers.mixed", "layers.structured",
                "models.sequence_tagging", "v1_compat", "v1_compat.config_helpers",
                "v1_compat.raw_face", "data_provider", "io.protodata", "io.recordio",
                "reader.creator", "reader.decorator", "layers.layer_math", "dataset.imdb",
                "image", "utils.queues", "utils.debug", "ops.detection", "framework",
                "framework.scope", "framework.op", "framework.ops", "framework.net",
                "framework.backward", "framework.recurrent", "framework.gradient_checker",
                "models.gan", "models.vae", "model", "plot", "utils.plotcurve",
                "utils.model_tools", "utils.preprocess_img", "reader.prefetch",
                "reader.pass_cache", "robustness", "robustness.chaos", "robustness.sentinel",
                "robustness.recovery", "robustness.preemption", "analysis.lock_sanitizer",
                "obs", "obs.tracer", "obs.metrics", "obs.merge", "master_wire", "ops.quantize",
                "robustness.netem", "master_journal", "master", "master_ha", "trainer.elastic",
                "launcher", "cli", "__main__", "serving.router", "reader.loadgen",
                "robustness.traces", "core.aot_cache", "analysis.diagnostics",
                "analysis.graph_lint", "utils.profiler"):
        assert f"paddle_tpu_torch.{mod}" in names.split()


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|paddle_tpu(?!_torch)\b)", re.M)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
    # the scan does see an offending line
    assert _FORBIDDEN.search("from paddle_tpu.core import batch")
    assert not _FORBIDDEN.search("from paddle_tpu_torch.core import batch")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.init()
    _, probs = paddle_tpu_torch.models.transformer.transformer_cost(
        20, 20, d_model=16, n_heads=2, n_layers=1, d_ff=32
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.parameters.create(probs)
    params = paddle_tpu_torch.parameters.create(probs, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.Inference(probs, params)
    cost, _ = paddle_tpu_torch.models.transformer.transformer_cost(
        20, 20, d_model=16, n_heads=2, n_layers=1, d_ff=32
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.trainer.SGD(
            cost, update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1)
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.CompiledNetwork(paddle_tpu_torch.Topology(cost)).init_params(0)
    data_types = paddle_tpu_torch.Topology(cost).data_types()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataFeeder(data_types)
    assert DataFeeder(data_types, device="cpu").device == torch.device("cpu")


def test_image_entry_points_raise_without_cuda():
    """Parameters.create, Inference and SGD on a ResNet topology: the card
    unless the caller asks for the CPU, where they carry the batch-norm
    state."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    cost, probs = paddle_tpu_torch.models.resnet.resnet_cost(depth=18, class_num=4, img_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.parameters.create(cost)
    params = paddle_tpu_torch.parameters.create(cost, device="cpu")
    assert len(params.state) == 20
    assert all(v.device.type == "cpu" for s in params.state.values() for v in s.values())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.Inference(probs, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.trainer.SGD(
            cost, params, paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.CompiledNetwork(paddle_tpu_torch.Topology(cost)).init_state()
    trainer = paddle_tpu_torch.trainer.SGD(
        cost, params, paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1, momentum=0.9),
        device="cpu",
    )
    assert trainer.parameters is params and set(params.state) == {
        name for name, conf in trainer.topology.layers.items() if conf.type == "batch_norm"}


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_generation_and_serving_entry_points_raise_without_cuda():
    """Seq2SeqGenerator, ServingEngine and Inference over a beam_search
    layer: the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.serving import ServingEngine

    cost, _ = seq2seq.seq2seq_cost(20, 20, 8, 8)
    params = paddle_tpu_torch.parameters.create(cost, device="cpu")
    kw = dict(word_dim=8, hidden_dim=8, max_length=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seq2seq.Seq2SeqGenerator(params, 20, 20, **kw)
    gen = seq2seq.Seq2SeqGenerator(params, 20, 20, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(gen, hbm_budget_mb=1)
    assert ServingEngine(gen, hbm_budget_mb=1, device="cpu").device == torch.device("cpu")
    beam = seq2seq.seq2seq_generation(20, 20, 8, 8, beam_size=2, max_length=4)
    beam_params = paddle_tpu_torch.parameters.create(beam, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.infer(beam, beam_params, [([2, 3],)], field="id")
    assert paddle_tpu_torch.infer(beam, beam_params, [([2, 3],)], field="id",
                                  device="cpu").shape == (1, 2, 4)


def test_lstm_and_tagger_entry_points_raise_without_cuda():
    """SGD.train's trainer and paddle.infer over the LSTM text classifier
    and the CRF tagger: the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    P = paddle_tpu_torch
    from paddle_tpu_torch.models.sequence_tagging import ner_crf_cost

    L = P.layer
    words = L.data(name="word", type=P.data_type.integer_value_sequence(50))
    lstm = P.networks.simple_lstm(L.embedding(words, size=8), 8)
    probs = L.fc(L.last_seq(lstm), size=2, act=P.activation.Softmax())
    text_cost = L.classification_cost(
        input=probs, label=L.data(name="label", type=P.data_type.integer_value(2)))
    tag_cost, decode = ner_crf_cost(50, 5, word_dim=8, hidden_dim=8)
    for cost, out in ((text_cost, probs), (tag_cost, decode)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.trainer.SGD(cost, update_equation=P.optimizer.Adam(learning_rate=1e-3))
        params = P.parameters.create(cost, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.infer(out, params, [([1, 2, 3],)])
        trainer = P.trainer.SGD(cost, params, P.optimizer.Adam(learning_rate=1e-3), device="cpu")
        assert trainer.device == torch.device("cpu")
        assert P.infer(out, params, [([1, 2, 3],)], device="cpu").shape[0] in (1, 3)


# the port's layer types: the 24 of the Transformer, image, spine, NMT and
# generation slices, then the six of the LSTM, simple-RNN and CRF slice
_EARLIER_TYPES = {
    "addto", "batch_norm", "beam_search", "concat", "conv", "cross_entropy", "data",
    "embedding", "expand", "fc", "get_output", "gru", "gru_step", "layer_norm", "memory",
    "multi_head_attention", "pool", "pos_encoding", "recurrent_group", "scaling",
    "seqlastins", "seqpool", "softmax_with_cost", "step_input"}
_SLICE_TYPES = {"lstmemory", "recurrent", "lstm_step", "mixed", "crf", "crf_decoding"}
# the two costs that take the sparse-label form, with the batch contract
_BATCH_SLICE_TYPES = {"square_error", "multi_binary_label_cross_entropy"}
# the 13 sequence types of the nested-sequence slice
_SEQUENCE_SLICE_TYPES = {
    "seqreshape", "seqconcat", "sampling_id", "eos_id", "context_projection", "row_conv",
    "conv_shift", "slice_time", "sub_seq", "kmax_seq_score", "agent", "scatter_agent",
    "gather_agent"}


# the 34 costs, sampled outputs and elementwise and misc types
_COST_SLICE_TYPES = {
    "soft_binary_class_cross_entropy", "smooth_l1", "huber_regression", "huber_classification",
    "rank_cost", "sum_cost", "cross_entropy_with_selfnorm", "multi_nn_cost", "nce", "hsigmoid",
    "selective_fc", "lambda_cost", "slope_intercept", "interpolation", "sum_to_one_norm",
    "row_l2_norm", "maxid", "multiplex", "trans", "repeat", "resize", "clip", "dotmul",
    "out_prod", "cos", "tensor", "prelu", "power", "data_norm", "rotate", "linear_comb",
    "cos_vm", "print", "scale_shift"}


# the 11 image, conv-operator and CTC types (warp_ctc builds a ctc layer)
_IMAGE_SLICE_TYPES = {
    "convt", "norm", "maxout", "pad", "crop", "bilinear_interp", "spp", "featmap_expand",
    "block_expand", "conv_op", "ctc"}


# the last 5: the SSD detection types, moe and the 2D LSTM
_LAST_SLICE_TYPES = {"priorbox", "multibox_loss", "detection_output", "moe", "mdlstmemory"}


def test_registered_layer_types_grow_by_the_slice():
    from paddle_tpu_torch.layers.base import registered_layer_types

    assert set(registered_layer_types()) == (
        _EARLIER_TYPES | _SLICE_TYPES | _BATCH_SLICE_TYPES | _SEQUENCE_SLICE_TYPES
        | _COST_SLICE_TYPES | _IMAGE_SLICE_TYPES | _LAST_SLICE_TYPES)
    assert len(_COST_SLICE_TYPES) == 34
    assert len(registered_layer_types()) == 95


def test_v1_front_end_entry_points_raise_without_cuda():
    """The feeder of nested and sparse slots, DataProviderConverter, and
    SGD and Inference over a v1-parsed topology: the card unless the caller
    asks for the CPU, where every tensor (lengths and sub-lengths included)
    lies on it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    P = paddle_tpu_torch
    from paddle_tpu_torch import data_provider, v1_compat

    dt = P.data_type
    types = [("n", dt.integer_value_sub_sequence(10)), ("s", dt.sparse_binary_vector(70000)),
             ("f", dt.sparse_float_vector_sequence(6))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataFeeder(types)
    batch = DataFeeder(types, device="cpu")([([[1, 2], [3]], [5, 69999], [[(1, 0.5)], []])])
    tensors = [t for v in batch.values() for t in (v.data, v.lengths, v.sub_lengths)
               if t is not None]
    assert len(tensors) == 6 and all(t.device.type == "cpu" for t in tensors)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_provider.DataProviderConverter([dt.dense_vector(2)])
    parsed = v1_compat.parse_config(os.path.join(ROOT, "tests", "configs", "demo_mnist_mlp.py"),
                                    "is_predict=1")
    params = P.parameters.create(parsed.topology.outputs, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Inference(parsed.topology.outputs, params)
    probs = P.Inference(parsed.topology.outputs, params, device="cpu").infer(
        [(np.zeros(784, np.float32),)])
    assert probs.shape == (1, 10)
    train = v1_compat.parse_config(os.path.join(ROOT, "tests", "configs", "demo_mnist_mlp.py"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.trainer.SGD(train.topology, update_equation=v1_compat.make_optimizer(train.settings))


def test_framework_and_generative_entry_points_raise_without_cuda():
    """Scope (and so check_gradients, which builds one, and
    numeric_gradient), GANTrainer and VAETrainer: the card unless the caller
    asks for the CPU, by argument or through init(device="cpu")."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    from paddle_tpu_torch import framework as fw
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.models.gan import GANTrainer
    from paddle_tpu_torch.models.vae import VAETrainer

    op = fw.create_op("sigmoid", X="x", Y="y")
    x = {"x": np.zeros((2, 3), np.float32)}
    for make in (fw.Scope, lambda: fw.check_gradients(op, x),
                 lambda: fw.numeric_gradient(op, x, "x"),
                 lambda: GANTrainer(3, 2, hidden=4), lambda: VAETrainer(4, 2, hidden=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    scope = fw.Scope(device="cpu")
    assert scope.new_scope().device == torch.device("cpu")
    fw.check_gradients(op, x, device="cpu")
    assert GANTrainer(3, 2, hidden=4, device="cpu").device.type == "cpu"
    assert VAETrainer(4, 2, hidden=4, device="cpu").device.type == "cpu"
    flags = paddle_tpu_torch.flags
    saved = dict(flags._VALUES)
    try:
        paddle_tpu_torch.init(device="cpu")
        assert fw.Scope().device == torch.device("cpu")
        assert GANTrainer(3, 2, hidden=4).d_params["d_out"]["w0"].device.type == "cpu"
    finally:
        tdevice._default_device = "cuda"
        flags._VALUES.clear()
        flags._VALUES.update(saved)



def test_async_feed_raises_without_cuda_unless_on_the_cpu():
    """SGD.train(async_load_data=True) on the CPU trains; a trainer whose
    device is the card raises without CUDA, before any step, and never goes
    back to an inline feed on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    L, A, dt = paddle_tpu_torch.layer, paddle_tpu_torch.activation, paddle_tpu_torch.data_type
    x = L.data(name="x", type=dt.dense_vector(4))
    cost = L.square_error_cost(input=L.fc(input=x, size=1, act=A.Linear()),
                               label=L.data(name="y", type=dt.dense_vector(1)))
    opt = paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.trainer.SGD(cost, update_equation=opt)
    trainer = paddle_tpu_torch.trainer.SGD(cost, update_equation=opt, device="cpu")
    samples = [(np.ones(4, np.float32), np.ones(1, np.float32))] * 8
    reader = paddle_tpu_torch.batch(lambda: iter(samples), 4)
    steps = []
    trainer.train(reader, async_load_data=True, event_handler=lambda e: steps.append(e)
                  if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    assert len(steps) == 2
    trainer.device = torch.device("cuda")
    steps.clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(reader, async_load_data=True, event_handler=steps.append)
    assert not steps
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataFeeder(trainer.topology.data_types(), device="cuda")
    # a feeder bound to the card stages there or raises: no quiet CPU copy
    feeder = DataFeeder(trainer.topology.data_types(), device="cpu")
    feeder.device = torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        feeder.stage(samples[:4])


def test_elastic_entry_points_raise_without_cuda_unless_on_the_cpu(tmp_path):
    """TrainerTaskModel, SGD.elastic_model and the mlp worker run on the
    card unless asked for the CPU, and raise without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.trainer import elastic
    from paddle_tpu_torch.utils import flags

    L, A, dt = paddle_tpu_torch.layer, paddle_tpu_torch.activation, paddle_tpu_torch.data_type
    x = L.data(name="x", type=dt.dense_vector(4))
    cost = L.square_error_cost(input=L.fc(input=x, size=1, act=A.Linear()),
                               label=L.data(name="y", type=dt.dense_vector(1)))
    trainer = paddle_tpu_torch.trainer.SGD(
        cost, update_equation=paddle_tpu_torch.optimizer.Momentum(learning_rate=0.1),
        device="cpu")
    assert isinstance(trainer.elastic_model(bytes), elastic.TrainerTaskModel)
    trainer.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.elastic_model(bytes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic.TrainerTaskModel(trainer, bytes)
    saved = dict(flags._VALUES)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            elastic._build_model("mlp", {"dim": "4"}, 0)
        model = elastic._build_model("mlp", {"dim": "4", "device": "cpu"}, 0)
        assert model._t.device == torch.device("cpu")
        # the worker process exits nonzero when its CUDA work cannot run
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.trainer.elastic", "--dir",
             str(tmp_path), "--model", "mlp", "--client-timeout", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    finally:
        tdevice._default_device = "cuda"
        flags._VALUES.clear()
        flags._VALUES.update(saved)


_TORCH_IMPORT = re.compile(r"^(?:import|from)\s+torch\b", re.M)


def test_router_loadgen_and_traces_import_no_torch_at_module_level():
    """Like their JAX twins, which import no jax, these three modules keep
    torch out of their own top level (``ops/quantize.py`` imports it only
    inside its tensor functions)."""
    for rel in ("serving/router.py", "reader/loadgen.py", "robustness/traces.py",
                "ops/quantize.py"):
        with open(os.path.join(PKG, rel)) as f:
            assert not _TORCH_IMPORT.search(f.read()), rel
    assert _TORCH_IMPORT.search("import torch\n")


def test_serve_raises_without_cuda_unless_on_the_cpu():
    """The scheduler over an engine and ``serve`` run on the card unless
    asked for the CPU: without CUDA, ``serve`` exits nonzero naming the
    CPU option, and with ``--device cpu`` it serves."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-CUDA error cannot show")
    args = [sys.executable, "-m", "paddle_tpu_torch", "serve", "--src-vocab", "20",
            "--trg-vocab", "20", "--word-dim", "8", "--hidden-dim", "8", "--max-length", "4",
            "--synthetic", "3", "--max-slots", "2", "--hbm-budget-mb", "1"]
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run(args + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["served"] == 3 and summary["unfinished"] == 0
