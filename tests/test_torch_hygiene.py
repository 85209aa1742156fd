"""Package rules of the port: paddle_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package (every module, the evaluators and checkpoints
included), and the entry points run on the card unless the caller asks for
the CPU (raising, not falling back, without one)."""

import os
import re
import subprocess
import sys

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
                "serving.scheduler", "utils.timers"):
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
