"""End-to-end ``python -m paddle_tpu_torch explore`` (a CLI subprocess each),
the twin of ``tests/test_explore_e2e.py``: clean seeded batches across
every model, and the planted-canary loop (detect, shrink to a replayable
spec file, replay from disk and reproduce).  Subprocess-level, so the
exit-code contract (0 clean / 1 violation, 0 reproduced / 1 not) is what is
tested.  Slow-marked: tier-1 covers the same command in-process
(``tests/test_torch_interleave.py``)."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _explore(*argv):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "explore", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )


def test_clean_batches_across_models():
    for model, schedules in (("router", "200"), ("ha", "200"), ("master", "60")):
        p = _explore("--model", model, "--schedules", schedules, "--seed", "0",
                     "--dfs-depth", "3")
        assert p.returncode == 0, (model, p.stdout, p.stderr)
        assert "clean" in p.stdout


def test_canary_detect_shrink_replay(tmp_path):
    spec_path = str(tmp_path / "double_serve.spec.json")
    p = _explore("--model", "router", "--schedules", "200", "--seed", "7",
                 "--max-events", "12", "--plant", "double_serve", "--out", spec_path)
    assert p.returncode == 1, (p.stdout, p.stderr)
    assert "VIOLATION" in p.stdout and "double-serve" in p.stdout

    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    assert spec["model"] == "router" and spec["planted"] == "double_serve"
    assert len(spec["events"]) <= 6, spec["events"]

    r = _explore("--replay", spec_path)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "reproduced" in r.stdout and "double-serve" in r.stdout


def test_replay_of_stale_spec_fails_loudly(tmp_path):
    # a spec whose bug has since been fixed must NOT silently pass: the
    # replay exits nonzero so a regression suite notices the spec rotted
    spec_path = str(tmp_path / "stale.spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump({
            "version": 1, "model": "router", "planted": None, "seed": 0,
            "events": [{"op": "submit", "req": "q1"}],
            "violations": ["(fixed long ago)"],
        }, fh)
    r = _explore("--replay", spec_path)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "did NOT reproduce" in r.stderr
