"""The port's scenario harness (``paddle_tpu_torch/robustness/scenarios.py``)
on the CPU, against the JAX package's ``robustness/scenarios.py``:

- twins of ``tests/test_scenarios.py``: the flags and their defaults, the
  registries and an unknown name, the SLO precedence, the status counts and
  percentiles, the rejected chaos occurrence, the unknown fleet fault, and
  ``scenario --list`` with its argument check;
- the registries' keys and the sources ``_srcs(seed, n)`` equal the JAX
  package's;
- five fast scenarios in-process at 16 requests, on one prewarmed engine:
  only structural fields are asserted (the status ledger sums to the offered
  count, only the poisoned request fails, training is bit-identical to the
  solo run, the codec rejected the corrupt frame and the journal lints
  clean, the replayed offer equals the live one).  Their latency, goodput
  and recovery-time gates run on the card (``chip_smoke.py`` phase 26), not
  on a shared CPU.
"""

import pytest

from paddle_tpu.robustness import scenarios as jsc
from paddle_tpu_torch.robustness import scenarios
from paddle_tpu_torch.utils import flags as _flags

N = 16  # requests per window in the in-process scenarios


@pytest.fixture(scope="module")
def engine():
    return scenarios.make_serving_engine(seed=0, device="cpu")


def _ledger_sums(win):
    assert sum(win["statuses"].values()) == win["n_offered"], win


def test_new_flags_registered_with_defaults():
    assert _flags.get_flag("serving_default_deadline_s") == 0.0
    assert _flags.get_flag("serving_queue_limit") == 0
    assert _flags.get_flag("serving_prefill_chunk_tokens") == 0
    assert _flags.get_flag("scenario_slo_ms") == 0.0
    assert _flags.get_flag("serving_priority_aging_s") == 2.0
    assert _flags.get_flag("serving_class_deadline_s") == ""
    assert _flags.get_flag("serving_class_shed_slack") == ""


def test_registry_names_and_unknown():
    assert set(scenarios.FAST_SCENARIOS) == {
        "overload", "burst_overload", "nan_request_under_load",
        "slow_client_under_load", "mixed_train_serve",
        "partition_under_load", "trace_replay_drift",
    }
    assert set(scenarios.SLOW_SCENARIOS) == {
        "fleet_kill_worker", "fleet_kill_master", "fleet_serving", "fleet_rolling_restart",
    }
    with pytest.raises(KeyError):
        scenarios.run_scenario("frobnicate")


def test_registries_exports_and_sources_equal_jax():
    assert list(scenarios.FAST_SCENARIOS) == list(jsc.FAST_SCENARIOS)
    assert list(scenarios.SLOW_SCENARIOS) == list(jsc.SLOW_SCENARIOS)
    assert set(scenarios.__all__) == set(jsc.__all__)
    assert all(callable(getattr(scenarios, n)) or isinstance(getattr(scenarios, n), dict)
               for n in jsc.__all__)
    for seed in (0, 3, 11):
        assert scenarios._srcs(seed, 24) == jsc._srcs(seed, 24)
    assert (scenarios._V, scenarios._E, scenarios._H, scenarios._MAXLEN) == \
        (jsc._V, jsc._E, jsc._H, jsc._MAXLEN)


def test_resolve_slo_precedence():
    wave = {"p95_service_ms": 40.0, "mean_service_ms": 12.0}
    assert scenarios._resolve_slo_s(200.0, wave) == pytest.approx(0.2)
    _flags.set_flag("scenario_slo_ms", 120.0)
    try:
        assert scenarios._resolve_slo_s(None, wave) == pytest.approx(0.12)
        assert jsc._resolve_slo_s(120.0, wave) == scenarios._resolve_slo_s(None, wave)
    finally:
        _flags.set_flag("scenario_slo_ms", 0.0)
    assert scenarios._resolve_slo_s(None, wave) == pytest.approx(0.1)
    assert scenarios._resolve_slo_s(None, {"p95_service_ms": 1.0}) == 0.05
    for w in (wave, {"p95_service_ms": 1.0}, {"mean_service_ms": 30.0}, {}):
        assert scenarios._resolve_slo_s(None, w) == jsc._resolve_slo_s(None, w)


def test_status_counts_and_percentiles():
    class R:
        def __init__(self, status):
            self.status = status

    reqs = [R("served"), R("served"), R("shed"), R("timeout")]
    counts = scenarios._status_counts(reqs)
    assert counts["served"] == 2 and counts["shed"] == 1
    assert counts["rejected"] == 0 and counts["timeout"] == 1
    assert counts == jsc._status_counts(reqs)
    assert scenarios._pct([], 0.5) is None
    assert scenarios._pct([3.0, 1.0, 2.0], 0.5) == 2.0
    assert scenarios._ms(None) is None
    assert scenarios._ms(0.0123) == 12.3


def test_chaos_scenario_rejects_calibration_clobbering_occurrence():
    with pytest.raises(ValueError, match="occurrence"):
        scenarios.scenario_chaos_under_load(occurrence=2)
    with pytest.raises(ValueError, match="serving chaos point"):
        scenarios.scenario_chaos_under_load(point="kill")


def test_fleet_chaos_rejects_unknown_fault(tmp_path):
    with pytest.raises(ValueError, match="unknown fleet fault"):
        scenarios.run_fleet_chaos(str(tmp_path), kill="kill_everything")


def test_cli_scenario_list_and_arg_validation(capsys):
    from paddle_tpu_torch.cli import cmd_scenario

    assert cmd_scenario(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("overload", "fleet_kill_master", "mixed_train_serve"):
        assert name in out
    assert cmd_scenario([]) == 2  # no names given


def test_overload_ledgers_sum_to_the_offer(engine):
    r = scenarios.run_scenario("overload", n_requests=N, engine=engine)
    assert r["scenario"] == "overload" and r["arrival"] == "poisson"
    assert r["saturation"]["n_offered"] == N
    assert r["at_1x"]["n_offered"] == N and r["at_2x"]["n_offered"] == 2 * N
    for win in (r["saturation"], r["at_1x"], r["at_2x"]):
        _ledger_sums(win)
        assert win["statuses"]["closed"] == 0
    assert r["slo_ms"] >= 50.0  # the derived SLO's floor
    assert isinstance(r["gate_goodput_2x_ge_80pct"], bool)
    assert isinstance(r["gate_p99_within_slo"], bool)


def test_nan_request_under_load_fails_only_the_poisoned_request(engine):
    r = scenarios.run_scenario("nan_request_under_load", n_requests=N, engine=engine)
    _ledger_sums(r)
    assert r["n_chaos_victims"] == 1
    # the poisoned request is rejected at validation; nothing else fails
    assert r["statuses"]["rejected"] == 1 and r["statuses"]["closed"] == 0
    assert r["passed"], r


def test_mixed_train_serve_keeps_training_bit_identical(engine):
    r = scenarios.run_scenario("mixed_train_serve", n_requests=N, train_steps=100,
                               engine=engine)
    _ledger_sums(r)
    assert r["train_bit_identical_to_solo"] is True
    assert r["statuses"]["rejected"] == 1 and r["statuses"]["closed"] == 0
    assert r["passed"], r


def test_partition_under_load_rejects_the_frame_and_lints_clean(engine):
    r = scenarios.run_scenario("partition_under_load", n_requests=N, engine=engine)
    _ledger_sums(r)
    assert r["gate_train_bit_identical"] and r["train_params_bit_identical"]
    assert r["gate_codec_rejected_corrupt_frame"]
    assert r["wire"]["server_rejected_frames"] >= 1
    assert r["gate_partition_fired"]
    assert r["gate_journal_lints_clean"] and r["journal_findings"] == []
    assert r["gate_serving_only_shed_or_timeout"]


def test_trace_replay_offers_the_recorded_window_again(engine, tmp_path):
    path = str(tmp_path / "window.ptt")
    r = scenarios.run_scenario("trace_replay_drift", n_requests=N, engine=engine,
                               trace_path=path)
    assert r["trace_path"] == path and r["trace_records"] == N
    assert r["gate_offer_bit_identical"]
    assert r["live"]["n_offered"] == r["replay"]["n_offered"] == N
    for win in (r["live"], r["replay"]):
        _ledger_sums(win)
        assert sum(c["offered"] for c in win["classes"].values()) == N
        assert set(win["classes"]) == {"p0", "p2"}
