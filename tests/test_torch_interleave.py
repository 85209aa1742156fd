"""The port's interleaving explorer (paddle_tpu_torch/analysis/interleave.py)
against the JAX package's (paddle_tpu/analysis/interleave.py) on the CPU.

* For the router, HA lease and master models at 20 schedules, seeds 0-2,
  both packages return the same verdict and ``schedules_run``, and their
  first seeded schedules apply the same events: the port's state machines
  enable the same transitions as the JAX package's.
* The planted ``double_serve`` canary (router, seed 7, at most 12 events)
  shrinks to the same events and violations in both packages, to at most
  6 events, and each package's spec replays on the other's
  ``replay_spec``.
* Bounded DFS sweeps of the router (depth 3) and the HA lease (depth 4)
  run the same number of paths, clean, in both packages.
* The targeted schedules of ``tests/test_interleave.py`` (the duplicate
  ack, the re-route livelock regression) end alike in both packages.
* ``python -m paddle_tpu_torch explore``, in-process: a clean batch at 20
  schedules exits 0, the canary exits 1 and writes its spec, ``--replay``
  of it exits 0, and the replay of a stale spec exits 1.
"""

import json
import logging
import random

import pytest

from paddle_tpu.analysis import interleave as jil
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.analysis import interleave as til


@pytest.fixture(autouse=True)
def _quiet_router_logs():
    # fault injection makes both routers narrate every simulated transport
    # failure; hundreds of schedules would drown the test output
    loggers = [logging.getLogger(n) for n in ("paddle_tpu", "paddle_tpu_torch")]
    prev = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)
    yield
    for lg, level in zip(loggers, prev):
        lg.setLevel(level)


def _both(tmp_path, fn, name, planted=None):
    """``fn(package module, model)`` for the JAX package then the port, each
    on a fresh model in its own directory."""
    out = []
    for tag, mod in (("jax", jil), ("port", til)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        m = mod.make_model(name, str(d), planted=planted)
        try:
            out.append(fn(mod, m))
        finally:
            m.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["router", "ha", "master"])
def test_seeded_batches_equal_the_jax_package(tmp_path, name, seed):
    def run(mod, m):
        res = mod.explore_schedules(m, schedules=20, seed=seed)
        traces = [mod._random_schedule(m, random.Random(f"{seed}:{i}"), 14)["trace"]
                  for i in range(3)]
        return res["violation_found"], res["schedules_run"], traces

    want, got = _both(tmp_path, run, name)
    assert got == want
    assert got[:2] == (False, 20)


@pytest.fixture(scope="module")
def canaries(tmp_path_factory):
    logging.getLogger("paddle_tpu").setLevel(logging.ERROR)
    logging.getLogger("paddle_tpu_torch").setLevel(logging.ERROR)
    return _both(tmp_path_factory.mktemp("canary"),
                 lambda mod, m: mod.explore_schedules(m, schedules=200, seed=7, max_events=12),
                 "router", planted="double_serve")


def test_canary_shrinks_to_the_same_spec(canaries):
    want, got = canaries
    assert got["violation_found"] and want["violation_found"]
    assert got["schedules_run"] == want["schedules_run"]
    assert got["spec"]["events"] == want["spec"]["events"]
    assert got["spec"]["violations"] == want["spec"]["violations"]
    assert len(got["spec"]["events"]) <= 6, got["spec"]["events"]
    assert any("double-serve" in v for v in got["spec"]["violations"])
    ops = [e["op"] for e in got["spec"]["events"]]
    assert "crash_router" in ops and "retry" in ops


@pytest.mark.parametrize("spec_of, replay", [(0, til.replay_spec), (1, jil.replay_spec)],
                         ids=["jax_spec_on_the_port", "port_spec_on_jax"])
def test_each_canary_spec_replays_on_the_other_package(canaries, tmp_path, spec_of, replay):
    out = replay(canaries[spec_of]["spec"], workdir=str(tmp_path))
    assert out["reproduced"], out
    assert out["violations"] == canaries[1 - spec_of]["spec"]["violations"]


@pytest.mark.parametrize("name, depth", [("router", 3), ("ha", 4)])
def test_dfs_sweeps_equal_the_jax_package(tmp_path, name, depth):
    want, got = _both(tmp_path, lambda mod, m: mod.dfs_explore(
        m, depth=depth, branch_limit=5, max_paths=400), name)
    assert got == want
    assert not got["violation_found"] and got["paths_run"] > 50


@pytest.mark.parametrize("name, events", [
    ("master", [{"op": "get", "worker": "w0"}, {"op": "finish", "worker": "w0"},
                {"op": "stale_ack"}]),
    ("router", [{"op": "partition", "engine": "e1"}, {"op": "partition", "engine": "e2"},
                {"op": "submit", "req": "q1"}]),
], ids=["duplicate_ack", "reroute_livelock"])
def test_targeted_schedules_equal_the_jax_package(tmp_path, name, events):
    def run(mod, m):
        out = mod.run_schedule(m, events)
        last = m.results[-1]["status"] if name == "router" else None
        return out["violations"], out["applied"], last

    want, got = _both(tmp_path, run, name)
    assert got == want
    assert got[:2] == ([], 3)


def test_cli_explore_batch_canary_and_replay(tmp_path, capsys):
    capsys.readouterr()
    assert tcli.main(["explore", "--model", "router", "--schedules", "20", "--seed", "0"]) == 0
    assert "clean: 20 schedules on model 'router' (seed 0), no violation" in capsys.readouterr().out
    spec_path = str(tmp_path / "double_serve.spec.json")
    assert tcli.main(["explore", "--model", "router", "--schedules", "200", "--seed", "7",
                      "--max-events", "12", "--plant", "double_serve", "--out", spec_path]) == 1
    out = capsys.readouterr().out
    assert "VIOLATION on model 'router'" in out and "double-serve" in out
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    assert spec["model"] == "router" and spec["planted"] == "double_serve"
    assert len(spec["events"]) <= 6
    assert tcli.main(["explore", "--replay", spec_path]) == 0
    assert "reproduced" in capsys.readouterr().out
    stale = tmp_path / "stale.spec.json"
    stale.write_text(json.dumps({"version": 1, "model": "router", "planted": None, "seed": 0,
                                 "events": [{"op": "submit", "req": "q1"}],
                                 "violations": ["(fixed long ago)"]}))
    assert tcli.main(["explore", "--replay", str(stale)]) == 1
    assert "did NOT reproduce" in capsys.readouterr().err
