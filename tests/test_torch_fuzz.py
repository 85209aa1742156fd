"""The port's chaos-composition fuzzer (``paddle_tpu_torch/robustness/fuzz.py``)
on the CPU, against the JAX package's ``robustness/fuzz.py``:

- composition ``i`` of seed ``s`` (``random.Random(f"{s}:{i}")``) is the JAX
  package's for s in 0-3 and i in 0-24;
- ``shrink_items`` (ddmin) gives the JAX package's minimal set on synthetic
  predicates;
- a spec the JAX package's ``save_spec`` wrote loads in the port with the
  same items, and the port's spec file is byte-for-byte the JAX package's;
- one ``ledger_skew``-planted composition holding only an overload arrival
  item flags the ledger violation on a CPU engine, and a clean one-item
  composition flags none.
"""

import random

import pytest

from paddle_tpu.robustness import fuzz as jfz
from paddle_tpu_torch.robustness import fuzz, scenarios


@pytest.fixture(scope="module")
def engine():
    return scenarios.make_serving_engine(seed=0, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampled_compositions_equal_jax(seed):
    for i in range(25):
        got = fuzz.sample_composition(random.Random(f"{seed}:{i}"))
        want = jfz.sample_composition(random.Random(f"{seed}:{i}"))
        assert got == want, (seed, i)


def test_exports_equal_jax():
    assert set(fuzz.__all__) == set(jfz.__all__)
    assert fuzz.FUZZ_SPEC_VERSION == jfz.FUZZ_SPEC_VERSION


@pytest.mark.parametrize("needs", [
    ("b",), ("a", "d"), ("c", "e", "f"), ("f",), ("a", "b", "c", "d", "e", "f"),
])
def test_shrink_items_gives_jax_minimal_set(needs):
    items = [{"axis": x} for x in "abcdef"]
    calls = []

    def fails(cand):
        calls.append(len(cand))
        return set(needs) <= {it["axis"] for it in cand}

    got = fuzz.shrink_items(items, fails)
    want = jfz.shrink_items(items, lambda c: set(needs) <= {it["axis"] for it in c})
    assert got == want
    assert [it["axis"] for it in got] == sorted(needs)
    assert calls  # the predicate drove the search


def test_shrink_items_returns_a_clean_input_as_is():
    items = [{"axis": "arrival"}, {"axis": "netem"}]
    assert fuzz.shrink_items(items, lambda c: False) == items == \
        jfz.shrink_items(items, lambda c: False)


def test_spec_files_are_the_same_json(tmp_path):
    items = jfz.sample_composition(random.Random("7:3"))
    spec = jfz._spec(7, 3, items, "ledger_skew", ["ledger_sum_mismatch:offered=16:sum=17"])
    jpath, tpath = str(tmp_path / "j.spec.json"), str(tmp_path / "t.spec.json")
    jfz.save_spec(spec, jpath)
    loaded = fuzz.load_spec(jpath)
    assert loaded == spec and loaded["items"] == items
    fuzz.save_spec(fuzz._spec(7, 3, items, "ledger_skew",
                              ["ledger_sum_mismatch:offered=16:sum=17"]), tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    assert jfz.load_spec(tpath) == loaded


def test_replay_refuses_a_foreign_spec():
    with pytest.raises(ValueError, match="not a chaos-fuzz spec"):
        fuzz.replay_fuzz_spec({"kind": "interleave", "version": 1})
    with pytest.raises(ValueError, match="unsupported fuzz spec version"):
        fuzz.replay_fuzz_spec({"kind": "chaos-fuzz", "version": 99})


def test_planted_ledger_skew_is_flagged_and_a_clean_item_is_not(engine, tmp_path):
    overload = [{"axis": "arrival", "process": "burst", "rate_factor": 2.0}]
    out = fuzz.run_composition(overload, engine=engine, workdir=str(tmp_path),
                               planted="ledger_skew")
    assert any(v.startswith("ledger_sum_mismatch:") for v in out["violations"]), out
    assert out["observed"]["n_offered"] == 16
    clean = [{"axis": "arrival", "process": "uniform", "rate_factor": 0.5}]
    out = fuzz.run_composition(clean, engine=engine, workdir=str(tmp_path),
                               planted="ledger_skew")
    assert out["violations"] == [], out
    assert sum(out["observed"]["statuses"].values()) == 16
    assert engine.pages.n_used == 0


def test_training_legs_in_one_workdir_each_lease_their_tasks(engine, tmp_path):
    """Two compositions with a training item in one work directory (as the
    ``fuzz`` subcommand runs a batch): each faulted leg starts a fresh
    master, so its armed ``worker_hang`` is consulted and its parameters
    equal the reference leg's.  (Sharing one leg directory, the second
    master restored the first's finished snapshot and never leased a task:
    ``armed_never_consulted:worker_hang`` at composition 5 of seed 0.)"""
    hang = [{"axis": "train_chaos", "point": "worker_hang", "occurrence": 1, "hang_secs": 0.5}]
    for _ in range(2):
        out = fuzz.run_composition(hang, engine=engine, workdir=str(tmp_path), n_requests=4)
        assert out["violations"] == [], out
        assert out["observed"]["chaos_report"]["worker_hang"]["consultations"] >= 1
