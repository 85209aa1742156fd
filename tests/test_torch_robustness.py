"""The port's robustness plane (paddle_tpu_torch/robustness/, the sharded
checkpoint plane and ``SGD.train``'s ``checkpoint_dir``/``resume``) on the
CPU, with the trainer, sentinel, chaos, marker and checkpoint cases of
``tests/test_robustness.py`` and ``tests/test_chaos_e2e.py``:

- the sentinel's verdicts on the same cost and health sequences equal the
  JAX package's ``DivergenceSentinel``'s exactly (and its EMA, bit for
  bit: the same float arithmetic);
- the chaos registry (occurrences, unknown points, the audit report), the
  NaN batch it poisons (a clone: the reader's array is untouched);
- a skipped step leaves parameters and optimizer state bit-identical; a
  poisoned batch in ``SGD.train`` is skipped once and training still
  learns;
- a rollback restores optimizer state, the generator and the counters
  exactly; a poisoned window rolls back ``failure_max`` times and is
  quarantined; a lost anchor or an over-long window quarantines;
- SIGTERM mid-pass writes a checkpoint and the marker, and a resumed
  trainer with another seed ends bit for bit where an uninterrupted run
  does; a torn newest checkpoint falls back;
- ``save_shard``/``commit`` round trip, and a shard set written by either
  package restores in the other;
- one subprocess drill: SIGKILL at step 5 through the ``kill`` point, then
  ``resume=True`` from the mid-pass checkpoint of step 3 ends bit for bit
  where an uninterrupted run does."""

import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch.core.topology import reset_auto_names
from paddle_tpu_torch.robustness import chaos
from paddle_tpu_torch.robustness.preemption import clear_marker, read_marker, write_marker
from paddle_tpu_torch.robustness.recovery import RecoveryCoordinator
from paddle_tpu_torch.robustness.sentinel import DivergenceSentinel
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.timers import StatSet, global_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.disarm()
    flags.reset_flags()


def _trainer(seed=0):
    reset_auto_names()
    x = P.layer.data(name="x", type=P.data_type.dense_vector(4))
    y = P.layer.data(name="y", type=P.data_type.dense_vector(1))
    pred = P.layer.fc(input=x, size=1, act=P.activation.Linear())
    cost = P.layer.square_error_cost(input=pred, label=y)
    return P.trainer.SGD(cost=cost, parameters=P.parameters.create(cost, seed=seed, device="cpu"),
                         update_equation=P.optimizer.Momentum(learning_rate=0.05, momentum=0.9),
                         device="cpu")


_W = np.array([1.0, -1.0, 2.0, 0.5], np.float32)


def _reader(n=48, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            xv = rng.randn(4).astype(np.float32)
            yield xv, np.array([float(xv @ _W)], np.float32)

    return reader


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


# ---------------------------------------------------------------------------
# the sentinel against the JAX package's
# ---------------------------------------------------------------------------


def _sequence(seed, n=200):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        r = rng.rand()
        if r < 0.08:
            out.append((float("nan"), False))
        elif r < 0.14:
            out.append((float(rng.uniform(5, 80)), True))  # spikes
        elif r < 0.16:
            out.append((float("inf"), True))  # the device half off
        else:
            out.append((float(1.0 + 0.1 * rng.randn()) * (0.99 ** i) + 1e-4, True))
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"skip_limit": 1}), (2, {"spike_patience": 1, "warmup_steps": 0}),
    (3, {"spike_factor": 2.0, "warmup_steps": 5, "ema_decay": 0.9}),
    (4, {"skip_limit": 2, "min_spike_cost": 10.0, "warmup_steps": 0}),
])
def test_sentinel_verdicts_equal_jax(seed, kw):
    from paddle_tpu.robustness.sentinel import DivergenceSentinel as JSentinel
    from paddle_tpu.utils.timers import StatSet as JStatSet

    t, j = DivergenceSentinel(stats=StatSet(), **kw), JSentinel(stats=JStatSet(), **kw)
    for i, (cost, healthy) in enumerate(_sequence(seed)):
        assert t.observe(cost, healthy) == j.observe(cost, healthy), i
        assert t.ema == j.ema and t.steady == j.steady, i
        if i % 37 == 36:
            t.reset(), j.reset()
    assert (t.total_skipped, t.total_spikes) == (j.total_skipped, j.total_spikes)


def test_sentinel_from_flags_and_the_eleven_flags_match_jax():
    from paddle_tpu.utils import flags as jflags

    names = ("cache_pass_in_mem", "data_echo_factor", "pass_cache_hbm_budget_mb",
             "whole_pass_program", "sentinel_check_interval", "sentinel_skip_limit",
             "sentinel_ema_decay", "sentinel_spike_factor", "sentinel_spike_patience",
             "failure_max", "chaos", "checkpoint_period_batches")
    for n in names:
        assert flags.get_flag(n) == jflags.get_flag(n), n
    flags.set_flag("sentinel_skip_limit", 5)
    s = DivergenceSentinel.from_flags(stats=StatSet())
    assert s.skip_limit == 5 and s.spike_factor == 4.0 and s.spike_patience == 3


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------


def test_chaos_spec_occurrence_and_audit(tmp_path):
    chaos.arm("nan_batch@2,kill")
    assert not chaos.fire("nan_batch") and chaos.fire("nan_batch") and not chaos.fire("nan_batch")
    assert chaos.fire("kill") and chaos.fire("kill")
    assert not chaos.fire("torn_checkpoint")
    assert chaos.active_spec() == "kill,nan_batch@2"
    rep = chaos.consult_report()
    assert rep["nan_batch"] == {"occurrence": 2, "consultations": 3, "fired": 1}
    assert chaos.write_report(str(tmp_path / "r.json")) == rep
    assert json.loads((tmp_path / "r.json").read_text()) == rep
    chaos.arm("kill_worker@5")  # re-arming clears the audit
    assert chaos.consult_report() == {
        "kill_worker": {"occurrence": 5, "consultations": 0, "fired": 0}}
    chaos.disarm()
    assert not chaos.fire("kill") and chaos.armed_points() == frozenset()
    with pytest.raises(ValueError, match="unknown chaos point"):
        chaos.arm("nan_batch,typo_point@3")
    from paddle_tpu.robustness.chaos import KNOWN_POINTS as JPOINTS

    assert chaos.KNOWN_POINTS == JPOINTS


def test_chaos_exit_report_counts_and_writes(tmp_path, monkeypatch):
    path = tmp_path / "exit.json"
    monkeypatch.setenv("PADDLE_TPU_TORCH_CHAOS_REPORT", str(path))
    chaos.arm("nan_batch,stale_lease@9")
    assert chaos.fire("nan_batch")
    before = global_stats.count("chaos/unfired/stale_lease")
    chaos._exit_report()
    assert global_stats.count("chaos/unfired/stale_lease") == before + 1
    rep = json.loads(path.read_text())
    assert rep["nan_batch"]["fired"] == 1 and rep["stale_lease"]["consultations"] == 0


def test_poison_batch_clones_the_first_float_slot():
    tr = _trainer()
    feeder = tr._make_feeder(None)
    host = feeder.convert([(np.ones(4, np.float32), np.ones(1, np.float32))])
    x0 = host["x"].data
    out = chaos.poison_batch(host)
    assert torch.isnan(out["x"].data.reshape(-1)[0]) and not torch.isnan(x0).any()
    from paddle_tpu_torch.core.batch import SeqTensor

    ids = {"i": SeqTensor(torch.zeros(3, dtype=torch.int32))}  # no float slot: untouched
    assert torch.equal(chaos.poison_batch(ids)["i"].data, torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the step's device half and the trainer
# ---------------------------------------------------------------------------


def test_skipped_step_keeps_state_and_healthy_step_updates():
    tr = _trainer()
    feeder = tr._make_feeder(None)
    bad = feeder([(np.full(4, np.nan, np.float32), np.ones(1, np.float32))])
    p0, o0 = _clone(tr.parameters.params), _clone(tr._opt_state)
    p2, _, o2, m = tr._train_step(tr.parameters.params, tr.parameters.state, tr._opt_state, bad, 7)
    assert float(m["health"]) == 0.0 and not math.isfinite(float(m["cost"]))
    assert _equal(p2, p0) and _equal(o2, o0)
    good = feeder([(np.ones(4, np.float32), np.ones(1, np.float32))])
    p3, _, _, m = tr._train_step(p2, tr.parameters.state, o2, good, 7)
    assert float(m["health"]) == 1.0 and math.isfinite(float(m["grad_norm"]))
    assert not _equal(p3, p0)
    flags.set_flag("divergence_sentinel", False)
    _, _, _, m = _trainer()._train_step(p3, {}, P.optimizer.Momentum(0.9).init(p3), good, 0)
    assert "health" not in m and "grad_norm" not in m


def test_poisoned_batch_is_skipped_and_training_learns():
    tr = _trainer()
    chaos.arm("nan_batch@2")
    base = global_stats.count("robustness.skipped_steps")
    costs = []
    tr.train(P.batch(_reader(96), 16), num_passes=2,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, P.event.EndIteration) else None)
    assert global_stats.count("robustness.skipped_steps") == base + 1
    assert sum(not math.isfinite(c) for c in costs) == 1
    finite = [c for c in costs if math.isfinite(c)]
    assert finite[-1] < finite[0]


def test_rollback_restores_opt_state_generator_and_counters(tmp_path):
    tr = _trainer()
    reader = P.batch(_reader(), 16)
    tr.train(reader, num_passes=1)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    tr.save_checkpoint(mgr, extra={"pass_id": 1, "batch_id": -1})
    snap = (_clone(tr.parameters.params), _clone(tr._opt_state), tr._rng.get_state().clone(),
            tr._step_count)
    tr.train(reader, num_passes=1)
    assert tr._step_count != snap[3]
    extra = tr._restore_latest_full(mgr)
    assert extra["pass_id"] == 1 and tr._step_count == snap[3]
    assert torch.equal(tr._rng.get_state(), snap[2])
    assert _equal(tr.parameters.params, snap[0]) and _equal(tr._opt_state, snap[1])


def test_divergence_rolls_back_then_quarantines(tmp_path):
    flags.set_flag("sentinel_skip_limit", 1)
    flags.set_flag("failure_max", 3)
    tr = _trainer()
    chaos.arm("nan_batch@1")
    rb = global_stats.count("robustness.rollbacks")
    q = global_stats.count("robustness.quarantined_batches")
    tr.train(P.batch(_reader(), 16), num_passes=1, checkpoint_dir=str(tmp_path / "ck"))
    assert global_stats.count("robustness.rollbacks") - rb == 3
    assert global_stats.count("robustness.quarantined_batches") - q == 1
    for n in tr.parameters.names():
        assert np.isfinite(np.asarray(tr.parameters.get(n))).all()


def test_divergence_without_checkpoint_dir_continues():
    flags.set_flag("sentinel_skip_limit", 1)
    tr = _trainer()
    chaos.arm("nan_batch@1")
    tr.train(P.batch(_reader(), 16), num_passes=1)
    for n in tr.parameters.names():
        assert np.isfinite(np.asarray(tr.parameters.get(n))).all()


def test_lost_anchor_and_long_window_quarantine():
    restore_step = {"v": 100}
    rc = RecoveryCoordinator(save_fn=lambda step, extra: None,
                             restore_fn=lambda: {"step_count": restore_step["v"]},
                             failure_max=3, stats=StatSet())
    rc.checkpoint(100, {"step_count": 100})
    rc.record(0, 5, "b5")
    rc.record(0, 6, "b6")
    action, window = rc.on_divergence()
    assert action == "retry" and [w[2] for w in window] == ["b5", "b6"]
    rc.replay_done()
    restore_step["v"] = 50
    assert rc.on_divergence() == ("quarantine", []) and rc.quarantined == 2
    stats = StatSet()
    rc = RecoveryCoordinator(save_fn=lambda s, e: None, restore_fn=lambda: {"step_count": 0},
                             failure_max=3, max_window_batches=4, stats=stats)
    rc.checkpoint(0, {"step_count": 0})
    for i in range(9):
        rc.record(0, i, f"b{i}")
    assert rc.on_divergence() == ("quarantine", [])
    assert stats.count("robustness.quarantined_batches") == 9


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------


def test_marker_roundtrip_and_resume_rules(tmp_path):
    d = str(tmp_path)
    assert read_marker(d) is None
    write_marker(d, {"pass_id": 1, "batch_id": 7})
    assert read_marker(d)["batch_id"] == 7
    clear_marker(d)
    assert read_marker(d) is None
    clear_marker(d)
    with pytest.raises(ValueError, match="resume=True requires"):
        _trainer().train(P.batch(_reader(), 16), resume=True)
    tr = _trainer()
    tr.train(P.batch(_reader(), 16), checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert not tr.preempted


def test_sigterm_checkpoints_and_resume_is_bitwise(tmp_path, caplog):
    ckdir = str(tmp_path / "ck")
    reader = P.batch(_reader(96, seed=3), 16)
    ref = _trainer(seed=1)
    ref.train(reader, num_passes=2)
    tr = _trainer(seed=1)
    steps = [0]

    def handler(e):
        if isinstance(e, P.event.EndIteration):
            steps[0] += 1
            if steps[0] == 4:
                os.kill(os.getpid(), signal.SIGTERM)

    tr.train(reader, num_passes=2, event_handler=handler, checkpoint_dir=ckdir,
             checkpoint_period_batches=2)
    assert tr.preempted and read_marker(ckdir)["preempted"] is True
    tr2 = _trainer(seed=99)
    tr2.train(reader, num_passes=2, checkpoint_dir=ckdir, resume=True)
    assert read_marker(ckdir) is None
    for n in ref.parameters.names():
        assert np.array_equal(tr2.parameters.get(n), ref.parameters.get(n)), n
    # a second run into the same directory without resume warns
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        _trainer().train(reader, num_passes=1, checkpoint_dir=ckdir)
    assert any("already holds checkpoints" in r.getMessage() for r in caplog.records)


def test_torn_checkpoint_falls_back(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    tree = {"a": torch.arange(256, dtype=torch.float32)}
    chaos.arm("torn_checkpoint@2")
    mgr.save(1, tree, extra={"tag": "good"})
    mgr.save(2, tree, extra={"tag": "torn"})
    step, restored, extra = mgr.restore_latest(tree)
    assert step == 1 and extra["tag"] == "good" and torch.equal(restored["a"], tree["a"])
    with pytest.raises(Exception):
        mgr.restore(2, tree)  # a named restore stays strict
    chaos.disarm()
    mgr2 = ckpt.CheckpointManager(str(tmp_path / "ck2"))
    mgr2.save(1, tree)
    chaos.tear_file(os.path.join(str(tmp_path / "ck2"), "ckpt-00000001", "state.npz"))
    assert mgr2.restore_latest(tree) is None


# ---------------------------------------------------------------------------
# the sharded checkpoint plane, across the two packages
# ---------------------------------------------------------------------------


def _state_tree(rng):
    return {"params": {"fc0": {"w0": rng.randn(4, 3).astype(np.float32),
                               "b": rng.randn(3).astype(np.float32)},
                       "fc1": {"w0": rng.randn(3, 2).astype(np.float32)}},
            "opt_state": {"step": np.asarray(7, np.int32),
                          "m": {"fc0": {"w0": rng.randn(4, 3).astype(np.float32)}}}}


def _as_torch(tree):
    return {k: _as_torch(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(np.array(tree))


def _assert_equal_np(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal_np(a[k], b[k])
    else:
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_checkpoint_round_trip_across_packages(tmp_path, writer):
    from paddle_tpu import checkpoint as jckpt

    tree = _state_tree(np.random.RandomState(0))
    d = str(tmp_path / "ck")
    make = (lambda: ckpt.CheckpointManager(d)) if writer == "port" else (
        lambda: jckpt.CheckpointManager(d))
    data = _as_torch(tree) if writer == "port" else tree
    writers = [make() for _ in range(3)]
    for i, m in enumerate(writers):
        m.save_shard(5, i, 3, data, async_=(i == 1))
        if i < 2:
            assert not writers[0].commit(5, 3)  # a shard is missing
    for m in writers:
        m.wait()
    assert writers[2].commit(5, 3, extra={"pass_id": 2}) and writers[0].commit(5, 3)
    for reader_mgr, template in ((ckpt.CheckpointManager(d), _as_torch(tree)),
                                 (jckpt.CheckpointManager(d), tree)):
        step, got, extra = reader_mgr.restore_latest(template)
        assert step == 5 and extra == {"pass_id": 2}
        _assert_equal_np(got, tree)
    man = json.load(open(os.path.join(d, "ckpt-00000005", "MANIFEST.json")))
    assert man["num_shards"] == 3 and man["n_leaves"] == 5


def test_torn_shard_falls_back_to_the_previous_manifest(tmp_path):
    tree = _as_torch(_state_tree(np.random.RandomState(1)))
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    for i in range(2):
        mgr.save_shard(1, i, 2, tree)
    assert mgr.commit(1, 2, extra={"tag": "good"})
    chaos.arm("torn_checkpoint@2")
    for i in range(2):
        mgr.save_shard(2, i, 2, tree)
    assert mgr.commit(2, 2, extra={"tag": "torn"})
    step, _, extra = mgr.restore_latest(tree)
    assert step == 1 and extra["tag"] == "good"
    assert mgr.meta(2)["extra"]["tag"] == "torn"


# ---------------------------------------------------------------------------
# the kill drill, in a subprocess
# ---------------------------------------------------------------------------

_DRILL = r"""
import sys, numpy as np
sys.path.insert(0, {root!r})
import paddle_tpu_torch as P
from paddle_tpu_torch.core.topology import reset_auto_names
reset_auto_names()
x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
h = P.layer.fc(input=x, size=16, act=P.activation.Tanh())
pred = P.layer.fc(input=h, size=4, act=P.activation.Softmax())
lbl = P.layer.data(name="label", type=P.data_type.integer_value(4))
cost = P.layer.classification_cost(input=pred, label=lbl)
def reader():
    rng = np.random.RandomState(7)
    centers = rng.randn(4, 8).astype("float32") * 2.0
    for i in range(96):
        yield (centers[i % 4] + 0.3 * rng.randn(8)).astype("float32"), i % 4
tr = P.trainer.SGD(cost, P.parameters.create(cost, seed={seed}, device="cpu"),
                   P.optimizer.Momentum(learning_rate=0.05, momentum=0.9), seed={seed},
                   device="cpu")
kw = dict(checkpoint_dir={ck!r}, checkpoint_period_batches=3) if {ck!r} else {{}}
tr.train(P.batch(reader, 16), num_passes=2, resume={resume}, **kw)
np.savez({out!r}, **{{n: np.asarray(tr.parameters.get(n)) for n in tr.parameters.names()}})
"""


def _drill(tmp_path, name, seed, ck="", resume=False, env=None):
    out = str(tmp_path / f"{name}.npz")
    code = _DRILL.format(root=ROOT, seed=seed, ck=ck, resume=resume, out=out)
    e = {k: v for k, v in os.environ.items() if k != "PADDLE_TPU_TORCH_CHAOS"}
    e.update(env or {})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=e, cwd=str(tmp_path))
    return proc, out


def test_kill9_resume_matches_uninterrupted_run(tmp_path):
    ref, ref_out = _drill(tmp_path, "ref", seed=5)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ck = str(tmp_path / "ck")
    killed, _ = _drill(tmp_path, "killed", seed=5, ck=ck,
                       env={"PADDLE_TPU_TORCH_CHAOS": "kill@5"})
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    mgr = ckpt.CheckpointManager(ck)
    extra = mgr.meta(mgr.latest_step())["extra"]
    assert (extra["step_count"], extra["pass_id"], extra["batch_id"]) == (3, 0, 2)  # mid-pass
    resumed, res_out = _drill(tmp_path, "resumed", seed=11, ck=ck, resume=True)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    want, got = np.load(ref_out), np.load(res_out)
    assert sorted(want.files) == sorted(got.files)
    for n in want.files:
        assert np.array_equal(want[n], got[n]), n
