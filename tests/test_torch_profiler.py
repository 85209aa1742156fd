"""The port's profiler and NaN trap (paddle_tpu_torch/utils/profiler.py) on
the CPU:

- ``profile(d)`` writes a torch profiler trace under ``d`` in which the obs
  host spans (an explicit span, and the trainer's ``train_step``/``feed``
  spans of two training steps) appear as ``record_function`` ranges; the
  annotation factory is cleared on exit, an exception included; without a
  directory it falls back to the ``profile_dir`` flag and raises without
  one; ``start``/``stop`` do the same by hand;
- ``enable_nan_checks`` raises ``FloatingPointError`` naming the aten op for
  ``log(-1)``; for a NaN planted in a batch, inside a compiled network, the
  message names the layer that first computed with it (and the compiler's
  T100 note names it too); for a NaN made only in the backward
  (``sqrt(x) * 0`` at x = 0, by hand and inside a network), the message
  names the backward node and the layer; the trainer's step raises it;
- disarmed, no dispatch mode is on the stack, uninitialised memory from
  ``empty`` never trips the trap, and the same NaN batch goes to the
  divergence sentinel's skip.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

import paddle_tpu_torch as P
from paddle_tpu_torch import obs
from paddle_tpu_torch.utils import profiler

L = P.layer
A = P.activation


@pytest.fixture
def trap():
    """Arms the trap for one test and always disarms it."""
    profiler.enable_nan_checks(True)
    try:
        yield profiler.active_trap()
    finally:
        profiler.enable_nan_checks(False)
    assert _get_current_dispatch_mode() is None


def _trace_events(d):
    files = glob.glob(os.path.join(str(d), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _mlp(nan_backward=False):
    x = L.data("x", P.data_type.dense_vector(4))
    if nan_backward:
        # sqrt(relu(W x)) * 0 at x = 0: the forward is 0, the backward of the
        # sqrt is 0 / (2 sqrt(0))
        h = L.fc(x, size=4, act=A.Relu(), bias_attr=False, name="h")
        q = L.addto([h], act=A.Sqrt(), bias_attr=False, name="q")
        return L.sum_cost(L.slope_intercept(q, slope=0.0, name="z"))
    h = L.fc(x, size=3, act=A.Tanh(), name="h")
    out = L.fc(h, size=3, act=A.Softmax(), name="out")
    return L.classification_cost(out, L.data("y", P.data_type.integer_value(3)))


def _trainer(cost):
    return P.trainer.SGD(cost, P.parameters.create(cost, seed=3, device="cpu"),
                         P.optimizer.Momentum(learning_rate=0.1), device="cpu")


def _rows(planted=None):
    rng = np.random.RandomState(0)
    rows = [(rng.standard_normal(4).astype(np.float32), int(rng.randint(3))) for _ in range(4)]
    if planted is not None:
        rows[planted][0][1] = np.nan
    return rows


def test_profile_writes_trace_with_obs_spans(tmp_path):
    trainer = _trainer(_mlp())
    rows = _rows()
    assert obs.tracer.recording
    with profiler.profile(str(tmp_path)) as prof:
        assert obs.tracer._annotation_factory is torch.profiler.record_function
        with obs.span("probe_span", cat="test"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        trainer.train(P.batch(lambda: iter(rows), 2), feeding={"x": 0, "y": 1})
    assert obs.tracer._annotation_factory is None
    assert prof.key_averages()  # the profiler recorded ops
    names = {e.get("name") for e in _trace_events(tmp_path)
             if e.get("cat") == "user_annotation"}
    assert {"probe_span", "train_step", "block_fetch"} <= names, names
    assert any(e.get("name") == "aten::mm" for e in _trace_events(tmp_path))


def test_profile_clears_annotation_on_error_and_uses_flag(tmp_path, monkeypatch):
    with pytest.raises(KeyError):
        with profiler.profile(str(tmp_path / "a")):
            raise KeyError("boom")
    assert obs.tracer._annotation_factory is None
    monkeypatch.delenv("PADDLE_TPU_TORCH_PROFILE_DIR", raising=False)
    with pytest.raises(ValueError, match="profile_dir"):
        with profiler.profile():
            pass
    monkeypatch.setenv("PADDLE_TPU_TORCH_PROFILE_DIR", str(tmp_path / "flag"))
    with profiler.profile():
        torch.ones(4).sum()
    assert glob.glob(str(tmp_path / "flag" / "*.pt.trace.json"))
    profiler.start(str(tmp_path / "manual"))
    with pytest.raises(RuntimeError, match="already running"):
        profiler.start(str(tmp_path / "other"))
    with obs.span("manual_span"):
        torch.ones(4).sum()
    profiler.stop()
    assert obs.tracer._annotation_factory is None
    assert "manual_span" in {e.get("name") for e in _trace_events(tmp_path / "manual")}
    with pytest.raises(RuntimeError, match="no profile"):
        profiler.stop()


def test_trap_names_the_op(trap):
    assert _get_current_dispatch_mode() is trap
    with pytest.raises(FloatingPointError, match=r"aten\.log\.default produced NaN outside any layer"):
        torch.log(torch.tensor([-1.0]))
    torch.log(torch.tensor([2.0]))  # finite: passes
    torch.exp(torch.tensor([1000.0]))  # inf is not NaN: passes, as in JAX
    torch.empty(1 << 16)  # uninitialised memory is not checked


def test_trap_names_the_layer_of_a_planted_input(trap):
    trainer = _trainer(_mlp())
    with pytest.raises(FloatingPointError) as ei:
        trainer.train(P.batch(lambda: iter(_rows(planted=2)), 4), feeding={"x": 0, "y": 1})
    assert "aten.mm" in str(ei.value) and "forward of layer 'h'" in str(ei.value)
    assert any("layer 'h'" in n and "T100" in n for n in ei.value.__notes__)


def test_trap_catches_a_nan_made_in_the_backward_only(trap):
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0).sum()
    assert float(y.detach()) == 0.0  # the forward is finite
    with pytest.raises(FloatingPointError, match=r"aten\.div.*backward \(SqrtBackward0\)"):
        y.backward()
    cost = _mlp(nan_backward=True)
    trainer = _trainer(cost)
    zeros = [(np.zeros(4, np.float32),) for _ in range(2)]
    with pytest.raises(FloatingPointError) as ei:
        trainer.train(P.batch(lambda: iter(zeros), 2), feeding={"x": 0})
    assert "backward (SqrtBackward0) of layer 'q'" in str(ei.value), str(ei.value)


def test_disarmed_trap_is_off_the_stack_and_the_sentinel_skips():
    profiler.enable_nan_checks(True)
    profiler.enable_nan_checks(False)
    assert _get_current_dispatch_mode() is None and profiler.active_trap() is None
    torch.log(torch.tensor([-1.0]))  # no trap
    trainer = _trainer(_mlp())
    before = {k: v.clone() for k, v in trainer.parameters.params["h"].items()}
    seen = []
    trainer.train(P.batch(lambda: iter(_rows(planted=2)), 4), feeding={"x": 0, "y": 1},
                  event_handler=lambda e: seen.append(e.cost)
                  if isinstance(e, P.event.EndIteration) else None)
    assert len(seen) == 1 and np.isnan(seen[0])  # reported, and skipped:
    for k, v in trainer.parameters.params["h"].items():
        assert torch.equal(v, before[k])
