"""``python -m paddle_tpu_torch fuzz`` and the serve trace record/replay loop
as subprocesses on the CPU (slow), twins of tests/test_fuzz_e2e.py: a clean
seeded batch, the planted-canary loop (detect with exit 1, shrink to a spec
file, replay from disk with exit 0), a clean spec's replay exiting 1, and a
recorded serving day replayed through a fresh process with the identical
per-class status ledger.  Subprocesses, so the exit codes are what is
tested; the module is slow-marked (tests/test_torch_hygiene.py checks the
mark)."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, timeout=600):
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_fuzz_clean_seeded_batch():
    p = _cli("fuzz", "--device=cpu", "--count", "5", "--seed", "0")
    assert p.returncode == 0, (p.stdout, p.stderr)
    assert "clean: 5 compositions" in p.stdout


def test_fuzz_canary_detect_shrink_replay(tmp_path):
    spec_path = str(tmp_path / "ledger_skew.spec.json")
    p = _cli("fuzz", "--device=cpu", "--count", "10", "--seed", "7",
             "--plant", "ledger_skew", "--out", spec_path)
    assert p.returncode == 1, (p.stdout, p.stderr)
    assert "VIOLATION" in p.stdout
    assert "ledger_sum_mismatch" in p.stdout
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    assert spec["kind"] == "chaos-fuzz"
    assert spec["planted"] == "ledger_skew"
    # ddmin left only what the planted bug needs: the overload arrival item
    assert spec["items"] == [{"axis": "arrival", "process": "burst", "rate_factor": 2.0}]
    r = _cli("fuzz", "--device=cpu", "--replay", spec_path)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "reproduced" in r.stdout


def test_fuzz_replay_of_clean_spec_fails(tmp_path):
    spec_path = str(tmp_path / "clean.spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump({
            "version": 1, "kind": "chaos-fuzz", "seed": 0, "index": 0,
            "items": [{"axis": "arrival", "process": "uniform", "rate_factor": 0.5}],
            "planted": None, "violations": ["stale"],
        }, fh)
    r = _cli("fuzz", "--device=cpu", "--replay", spec_path)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "did NOT reproduce" in r.stderr


def _serve(*extra, timeout=300):
    return _cli("serve", "--device", "cpu", "--src-vocab", "60", "--trg-vocab", "60",
                "--word-dim", "32", "--hidden-dim", "64", "--max-length", "16",
                *extra, timeout=timeout)


def test_serve_record_then_replay_reproduces_class_ledger(tmp_path):
    trace = str(tmp_path / "day.ptt")
    rec = _serve("--synthetic", "10", "--rate", "40", "--seed", "3",
                 "--priority-every", "4", "--sessions", "3",
                 "--deadline-s", "10", "--record-trace", trace)
    assert rec.returncode == 0, (rec.stdout, rec.stderr)
    rec_summary = json.loads(rec.stdout.strip().splitlines()[-1])
    assert rec_summary["recorded_trace"] == trace
    assert set(rec_summary["classes"]) == {"p0", "p2"}

    from paddle_tpu_torch.robustness.traces import read_trace

    t = read_trace(trace)
    assert len(t.requests()) == 10
    assert t.serialize().encode() == open(trace, "rb").read()

    rep = _serve("--replay", trace, "--seed", "99")
    assert rep.returncode == 0, (rep.stdout, rep.stderr)
    rep_summary = json.loads(rep.stdout.strip().splitlines()[-1])
    assert rep_summary["replayed_trace"] == trace
    assert rep_summary["classes"] == rec_summary["classes"]
    for k in ("served", "shed", "rejected", "timeout", "unfinished"):
        assert rep_summary[k] == rec_summary[k], (k, rep_summary)
    rep_ids = [json.loads(line)["req"]
               for line in rep.stdout.strip().splitlines()[:-1] if line.startswith("{")]
    assert sorted(rep_ids) == sorted(r["id"] for r in t.requests())


def test_serve_replay_rejects_torn_trace(tmp_path):
    trace = str(tmp_path / "torn.ptt")
    rec = _serve("--synthetic", "4", "--rate", "50", "--seed", "1", "--record-trace", trace)
    assert rec.returncode == 0, (rec.stdout, rec.stderr)
    with open(trace) as f:
        lines = f.read().splitlines()
    with open(trace, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")  # drop the footer
    rep = _serve("--replay", trace)
    assert rep.returncode != 0
    assert "ptt-end" in (rep.stderr + rep.stdout)
