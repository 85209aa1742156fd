"""The port's v1 command line (paddle_tpu_torch/cli.py) against the JAX
package's (paddle_tpu/cli.py) on the CPU.

The port runs in-process through ``cli.main([..., "--device=cpu"])``; the
JAX package's CLI runs ONCE, in a subprocess with ``JAX_PLATFORMS=cpu``
(its checkgrad turns ``jax_enable_x64`` on for the whole process and its
train sets flags and logging globally), over a small textcls config (the
reference rnn benchmark's network at vocab 50, width 8) and a small tanh
MLP config, each with its @provider, written into a temporary directory.

- ``--help`` lists the ported commands, every one of the JAX package's;
  an unknown command exits 1; ``cache`` runs and ``train
  --aot_cache_dir`` trains;
- the ignored reference-flag sets equal the JAX package's, and a reference
  ``train.sh`` line is accepted (typos and stray tokens exit 2);
- ``--job=train`` writes pass dirs whose file names equal the JAX CLI's;
- the JAX CLI's ``pass-00000`` tested by the port gives the JAX CLI's test
  cost and metrics (printed to 6 decimals: within 1e-5 relative plus the
  half unit of the last printed digit); a JAX ``merge_model`` bundle loads
  into the port, and the port's into the JAX package, with the same costs;
- ``--start_pass`` resumes from the save dir; ``--job=time`` prints the
  burn-in, the StatSet table and ms/batch (also with ``--feed_data`` and
  the pass cache);
- checkgrad passes, and fails (exit 1, naming the parameter) on a tanh
  whose backward is planted wrong; its per-parameter <g, d> values equal
  those of the JAX package's f64 gradient of the same imported parameters
  to 1e-9 relative;
- ``dump_config`` output and the ``make_diagram`` dot are byte-equal to the
  JAX package's for ``tests/configs/*.py`` and both configs;
- ``trace validate``/``merge`` print the JAX package's JSON over the same
  trace files, and the merged timelines are equal;
- without ``--device=cpu`` and without CUDA, ``train`` exits 1 with the
  device error.
"""

import glob
import json
import os
import pickle
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tests", "configs")

TEXTCLS = """
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 50)
hidden_size = get_config_arg("hidden_size", int, 8)
lstm_num = get_config_arg("lstm_num", int, 1)
batch_size = get_config_arg("batch_size", int, 8)
settings(batch_size=batch_size, learning_rate=5e-3, learning_method=AdamOptimizer())
define_py_data_sources2("train.list", "test.list", module="provider", obj="process",
                        args={"vocab": vocab})
net = data_layer("data", vocab)
net = embedding_layer(input=net, size=8)
for i in range(lstm_num):
    net = simple_lstm(input=net, size=hidden_size)
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer("label", 2)
outputs(classification_cost(input=net, label=lab))
"""
PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[integer_value_sequence(50), integer_value(2)], should_shuffle=False)
def process(settings, path, vocab=50):
    with open(path, "rb") as f:
        x, y = pickle.load(f)
    for ids, label in zip(x, y):
        yield [int(t) % vocab for t in ids], int(label)
"""
MLP = """
from paddle.trainer_config_helpers import *

settings(batch_size=8, learning_rate=1e-2, learning_method=MomentumOptimizer(0.9))
define_py_data_sources2("mlp.list", None, module="mlp_provider", obj="process")
x = data_layer(name="x", size=6)
h = fc_layer(input=x, size=5, act=TanhActivation())
p = fc_layer(input=h, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=p, label=data_layer(name="y", size=3)))
"""
MLP_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[dense_vector(6), integer_value(3)], should_shuffle=False)
def process(settings, path):
    with open(path, "rb") as f:
        for x, y in pickle.load(f):
            yield x, y
"""


def _write_corpus(d):
    rng = np.random.RandomState(0)
    x = [[int(t) for t in rng.randint(0, 50, size=rng.randint(3, 12))] for _ in range(32)]
    with open(os.path.join(d, "reviews.pkl"), "wb") as f:
        pickle.dump((x, [s[0] % 2 for s in x]), f, protocol=2)
    rows = [([float(v) for v in rng.standard_normal(6)], int(rng.randint(3))) for _ in range(16)]
    with open(os.path.join(d, "mlp.pkl"), "wb") as f:
        pickle.dump(rows, f, protocol=2)
    for name, text in (("textcls.py", TEXTCLS), ("provider.py", PROVIDER), ("mlp.py", MLP),
                       ("mlp_provider.py", MLP_PROVIDER), ("train.list", "reviews.pkl\n"),
                       ("test.list", "reviews.pkl\n"), ("mlp.list", "mlp.pkl\n")):
        with open(os.path.join(d, name), "w") as f:
            f.write(text)


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _write_traces(d):
    from paddle_tpu_torch.obs.tracer import Tracer

    paths = []
    for pid, role in ((101, "trainer"), (202, "worker")):
        tr = Tracer(clock=_Clock(), ring_events=64)
        tr._recording = True
        tr.role, tr.pid = role, pid
        with tr.span("train_step", cat="trainer", p=0, b=1):
            tr.instant("feed", cat="trainer")
        obj = tr.trace_object()
        for e in obj["traceEvents"]:
            e["pid"] = pid
        paths.append(os.path.join(d, f"trace-{role}-{pid}.json"))
        with open(paths[-1], "w") as f:
            json.dump(obj, f)
    bad = json.load(open(paths[0]))
    for e in bad["traceEvents"]:
        if e.get("ph") == "E":
            e["name"] = "not_the_open_span"  # breaks the LIFO name pairing
    paths.append(os.path.join(d, "trace-bad.json"))
    with open(paths[-1], "w") as f:
        json.dump(bad, f)
    return paths


# the JAX package's side, in one subprocess: argv[1] is the work dir, and
# the results land in <work>/jax.json
_JAX_SIDE = r"""
import contextlib, glob, io, json, os, sys
import numpy as np
work, configs = sys.argv[1], sys.argv[2]
os.chdir(work)
from paddle_tpu import cli

def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()

res = {}
res["train"] = run(["train", "--config=textcls.py", "--save_dir=jax_out", "--num_passes=1"])
res["test"] = run(["train", "--config=textcls.py", "--job=test",
                   "--init_model_path=jax_out/pass-00000"])
res["merge"] = run(["merge_model", "--model_dir=jax_out/pass-00000",
                    "--config_file=textcls.py", "--model_file=jax_bundle.tgz"])
res["test_port_bundle"] = run(["train", "--config=textcls.py", "--job=test",
                               "--init_model_path=port_bundle.tgz"])
res["pass_files"] = sorted(os.listdir("jax_out/pass-00000"))
cfgs = sorted(glob.glob(os.path.join(configs, "*.py"))) + ["textcls.py", "mlp.py"]
res["dump"] = {os.path.basename(c): run(["dump_config", c]) for c in cfgs}
for c in cfgs:
    run(["make_diagram", c, "jax-" + os.path.basename(c) + ".dot"])
traces = sorted(glob.glob(os.path.join(work, "traces", "*.json")))
res["validate"] = run(["trace", "validate"] + traces)
res["merged"] = run(["trace", "merge"] + [t for t in traces if "bad" not in t]
                    + ["--out", "jax_merged.json"])

# checkgrad's <g, d> of the JAX package's f64 gradient, the JAX CLI's scheme
import jax
jax.config.update("jax_enable_x64", True)
from paddle_tpu import minibatch
from paddle_tpu.parallel.mesh import shard_batch
from paddle_tpu.v1_compat import make_config_reader, parse_config
res["dirs"] = {}
for cfg, init in (("textcls.py", "jax_out/pass-00000"), ("mlp.py", None)):
    parsed = parse_config(os.path.abspath(cfg), "")
    trainer = cli._make_trainer(parsed, 0)
    if init:
        cli._load_init_model(trainer, init)
    else:
        with open("mlp_params.tar", "rb") as f:
            trainer.parameters.from_tar(f)
    raw = next(minibatch.batch(make_config_reader(parsed, work, train=True),
                               min(parsed.settings.batch_size, 8))())
    batch = shard_batch(trainer._make_feeder(parsed.feeding)(raw), trainer.mesh)
    f64 = lambda x: (np.asarray(x).astype(np.float64)
                     if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x))
    batch = jax.tree.map(f64, batch)
    net, state = trainer.network, trainer.parameters.state
    names = list(net.topology.output_names)

    def total_cost(params):
        outs, _ = net.apply(params, batch, state=state, train=True, rng=jax.random.PRNGKey(0))
        total = 0.0
        for name in names:
            v = outs[name]
            total = total + (v.data if hasattr(v, "data") else v).astype("float64").mean()
        return total

    base = jax.tree.map(f64, trainer.parameters.params)
    grads = jax.jit(jax.grad(total_cost))(base)
    rng = np.random.RandomState(0)
    rows = {}
    for pname, g in sorted(grads.items()):
        for wname, gval in sorted(g.items()):
            d = rng.standard_normal(np.asarray(base[pname][wname]).shape)
            d /= max(np.linalg.norm(d), 1e-12)
            rows[f"{pname}.{wname}"] = float((np.asarray(gval, np.float64) * d).sum())
    res["dirs"][cfg] = rows
with open("jax.json", "w") as f:
    json.dump(res, f)
"""


def _main(argv, capsys):
    """(exit code, stdout) of the port's CLI, in-process."""
    capsys.readouterr()
    rc = tcli.main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(autouse=True)
def _flags_restored():
    saved = dict(paddle_tpu_torch.flags._VALUES)
    yield
    paddle_tpu_torch.flags._VALUES.clear()
    paddle_tpu_torch.flags._VALUES.update(saved)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The corpus, the port's pass and bundle, the trace files, then the JAX
    package's run over them (its results in ``jax``)."""
    d = str(tmp_path_factory.mktemp("cli"))
    _write_corpus(d)
    os.makedirs(os.path.join(d, "traces"))
    _write_traces(os.path.join(d, "traces"))
    cwd = os.getcwd()
    saved = dict(paddle_tpu_torch.flags._VALUES)
    os.chdir(d)
    try:
        for argv in (["train", "--config=textcls.py", "--save_dir=port_out", "--num_passes=1",
                      "--device=cpu"],
                     ["merge_model", "--model_dir=port_out/pass-00000",
                      "--config_file=textcls.py", "--model_file=port_bundle.tgz",
                      "--device=cpu"]):
            assert tcli.main(argv) == 0
        params = paddle_tpu_torch.parameters.create(
            paddle_tpu_torch.v1_compat.parse_config(os.path.join(d, "mlp.py")).topology,
            seed=5, device="cpu")
        with open("mlp_params.tar", "wb") as f:
            params.to_tar(f)
    finally:
        os.chdir(cwd)
        paddle_tpu_torch.flags._VALUES.clear()
        paddle_tpu_torch.flags._VALUES.update(saved)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, d, CONFIGS], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(d, "jax.json")) as f:
        jax = json.load(f)
    return {"dir": d, "jax": jax}


def _test_cost(out):
    cost = float(re.search(r"Test cost ([-0-9.e+]+)", out).group(1))
    metrics = {k: float(v) for k, v in re.findall(r"^  (\w+) = ([-0-9.e+]+)$", out, re.M)}
    return cost, metrics


def _close(got, want):
    """Printed to 6 decimals: 1e-5 relative plus the half unit of the last
    printed digit."""
    return abs(got - want) <= 1e-5 * abs(want) + 5e-7


def test_help_unknown_and_not_ported_commands(work, tmp_path, capsys):
    """Every subcommand of the JAX package is ported: ``cache`` runs (it
    raised before the build store was ported) and ``train --aot_cache_dir``
    trains with the flag set (it raised too)."""
    rc, out = _main(["--help"], capsys)
    assert rc == 0
    for cmd in ("train", "version", "dump_config", "make_diagram", "merge_model", "plotcurve",
                "lint", "trace", "master", "worker", "serve", "route", "scenario", "fuzz",
                "explore", "cache"):
        assert f"    {cmd} " in out
    assert "not ported yet" not in out and tcli._NOT_PORTED == ()
    assert tcli.main(["frobnicate"]) == 1
    assert "unknown command" in capsys.readouterr().err
    assert tcli._COMMANDS["explore"] is tcli.cmd_explore
    assert tcli._COMMANDS["cache"] is tcli.cmd_cache
    store = str(tmp_path / "store")
    rc, out = _main(["cache", "ls", "--dir", store], capsys)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["entries"] == 0
    rc, out = _main(["scenario", "--list"], capsys)
    assert rc == 0 and "overload  (fast)" in out and "fleet_kill_worker  (slow" in out
    rc, out = _main(["train", f"--config={os.path.join(work['dir'], 'textcls.py')}",
                     f"--aot_cache_dir={store}", "--num_passes=1", "--device=cpu"], capsys)
    assert rc == 0 and "Pass 0: mean cost" in out
    assert paddle_tpu_torch.flags.get_flag("aot_cache_dir") == store


def test_ignored_flags_equal_the_jax_package_and_train_sh_lines_pass(work, capsys):
    from paddle_tpu import cli as jcli

    assert tcli._IGNORED_REFERENCE_FLAGS == jcli._IGNORED_REFERENCE_FLAGS
    assert tcli._VALUE_REFERENCE_FLAGS == jcli._VALUE_REFERENCE_FLAGS
    cfg = os.path.join(work["dir"], "textcls.py")
    base = ["train", f"--config={cfg}", "--num_passes=0", "--device=cpu"]
    assert tcli.main(base + ["--test_all_data_in_one_period=1", "--num_gradient_servers=1",
                             "--nics=eth0", "--ports_num=1", "--use_gpu=0",
                             "--trainer_count=1"]) == 0
    assert "ignoring reference trainer flags" in capsys.readouterr().err
    assert tcli.main(base + ["--nics", "eth0", "--gpu_id", "-1", "--nolocal",
                             "--notest_wait"]) == 0
    assert paddle_tpu_torch.flags.get_flag("use_gpu") is False
    for bad in (["--save_dri=/tmp/x"], ["num_passes=5"], ["--nolocal", "batch_size=32"]):
        assert tcli.main(base + bad) == 2
        assert "unrecognized arguments" in capsys.readouterr().err


def test_train_writes_the_jax_package_pass_files(work):
    port = sorted(os.listdir(os.path.join(work["dir"], "port_out", "pass-00000")))
    assert port == work["jax"]["pass_files"]
    assert "params.tar" in port and "__fc_layer_0__.w0" in port


def test_jax_pass_and_bundles_test_alike_in_the_port(work, capsys):
    d, jax = work["dir"], work["jax"]
    cfg = os.path.join(d, "textcls.py")
    rc, jax_test = jax["test"]
    assert rc == 0 and jax["merge"][0] == 0
    want_cost, want_metrics = _test_cost(jax_test)
    assert set(want_metrics) == {"classification_error"}
    for init in ("jax_out/pass-00000", "jax_bundle.tgz"):
        rc, out = _main(["train", f"--config={cfg}", "--job=test", "--device=cpu",
                         f"--init_model_path={os.path.join(d, init)}"], capsys)
        assert rc == 0
        cost, metrics = _test_cost(out)
        assert _close(cost, want_cost), (init, cost, want_cost)
        assert metrics.keys() == want_metrics.keys()
        assert all(_close(metrics[k], v) for k, v in want_metrics.items())
    # the reverse: the port's bundle in the JAX package, against the port's
    # test of its own pass
    rc, out = _main(["train", f"--config={cfg}", "--job=test", "--device=cpu",
                     f"--init_model_path={os.path.join(d, 'port_out/pass-00000')}"], capsys)
    rc_j, jax_out = jax["test_port_bundle"]
    assert rc == rc_j == 0
    assert _close(_test_cost(jax_out)[0], _test_cost(out)[0])


def test_test_job_without_a_test_list_reads_the_train_stream(work, capsys):
    """The JAX CLI hands the provider None as its file here and fails
    (ROADMAP Queue 3); the port's test job falls back to the train stream,
    which is also the config's declared test list in textcls.py."""
    d = work["dir"]
    notest = os.path.join(d, "notest.py")
    with open(notest, "w") as f:
        f.write(TEXTCLS.replace('"train.list", "test.list"', '"train.list", None'))
    outs = []
    for cfg in (notest, os.path.join(d, "textcls.py")):
        rc, out = _main(["train", f"--config={cfg}", "--job=test", "--device=cpu",
                         f"--init_model_path={os.path.join(d, 'jax_out/pass-00000')}"], capsys)
        assert rc == 0
        outs.append(out)
    assert "no test data declared; evaluating on the train stream" in outs[0]
    assert "no test data declared" not in outs[1]
    assert _test_cost(outs[0]) == _test_cost(outs[1])


def test_start_pass_resumes_from_the_save_dir(work, tmp_path, capsys):
    save = tmp_path / "model"
    shutil.copytree(os.path.join(work["dir"], "port_out"), save)
    rc, out = _main(["train", f"--config={os.path.join(work['dir'], 'textcls.py')}",
                     f"--save_dir={save}", "--num_passes=1", "--start_pass=1",
                     "--device=cpu"], capsys)
    assert rc == 0 and "Pass 1: mean cost" in out and "Test with Pass 1" in out
    assert (save / "pass-00001" / "params.tar").exists()


def test_time_job_prints_the_stat_table(work, capsys):
    cfg = os.path.join(work["dir"], "textcls.py")
    for extra in ([], ["--feed_data", "--cache_pass_in_mem"]):
        rc, out = _main(["train", f"--config={cfg}", "--job=time", "--test_period=3",
                         "--device=cpu"] + extra, capsys)
        assert rc == 0
        assert "Burning time..." in out and "Burning time end." in out
        assert "FwdBwd" in out and re.search(r"3 batches of 8: [0-9.]+ ms/batch", out)
        assert ("pass cache:" in out) == bool(extra)


class _WrongTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 2.0 * g * (1 - y * y)  # planted: twice the true gradient


def test_checkgrad_passes_and_names_a_wrong_backward(work, capsys, monkeypatch):
    cfg = os.path.join(work["dir"], "mlp.py")
    rc, out = _main(["train", f"--config={cfg}", "--job=checkgrad", "--device=cpu"], capsys)
    assert rc == 0 and "checkgrad PASSED (2 parameters" in out
    assert torch.get_default_dtype() == torch.float32  # restored after the job
    from paddle_tpu_torch.ops import activations

    monkeypatch.setitem(activations._ACTIVATIONS, "tanh", _WrongTanh.apply)
    rc, out = _main(["train", f"--config={cfg}", "--job=checkgrad", "--device=cpu"], capsys)
    assert rc == 1
    failed = re.findall(r"^FAIL (\S+):", out, re.M)
    assert "__fc_layer_0__.w0" in failed and "__fc_layer_1__.w0" not in failed


@pytest.mark.parametrize("cfg", ["textcls.py", "mlp.py"])
def test_checkgrad_directions_equal_the_jax_package(work, cfg):
    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.v1_compat import make_config_reader, parse_config

    d = work["dir"]
    parsed = parse_config(os.path.join(d, cfg))
    trainer = tcli._make_trainer(parsed, 0, "cpu")
    if cfg == "textcls.py":
        tcli._load_init_model(trainer, os.path.join(d, "jax_out", "pass-00000"))
    else:
        tcli._load_init_model(trainer, os.path.join(d, "mlp_params.tar"))
    raw = next(minibatch.batch(make_config_reader(parsed, d, train=True),
                               min(parsed.settings.batch_size, 8))())
    rows = tcli.directional_derivatives(trainer, trainer._make_feeder(parsed.feeding)(raw))
    want = work["jax"]["dirs"][cfg]
    assert [name for name, *_ in rows] == list(want)
    for name, an, fd, rel in rows:
        assert abs(an - want[name]) <= 1e-9 * abs(want[name]), (name, an, want[name])
        assert rel <= 1e-6, (name, an, fd)


def test_dump_config_and_make_diagram_are_byte_equal(work, capsys, tmp_path):
    d = work["dir"]
    cfgs = sorted(glob.glob(os.path.join(CONFIGS, "*.py"))) + [
        os.path.join(d, "textcls.py"), os.path.join(d, "mlp.py")]
    for c in cfgs:
        name = os.path.basename(c)
        rc, out = _main(["dump_config", c], capsys)
        assert [rc, out] == work["jax"]["dump"][name], name
        dot = tmp_path / (name + ".dot")
        assert _main(["make_diagram", c, str(dot)], capsys)[0] == 0
        with open(os.path.join(d, f"jax-{name}.dot"), "rb") as f:
            assert dot.read_bytes() == f.read(), name


def test_trace_validate_and_merge_equal_the_jax_package(work, capsys, tmp_path):
    traces = sorted(glob.glob(os.path.join(work["dir"], "traces", "*.json")))
    rc, out = _main(["trace", "validate"] + traces, capsys)
    assert [rc, out] == work["jax"]["validate"] and rc == 1
    lines = [json.loads(x) for x in out.splitlines()]
    assert [x["valid"] for x in lines] == [False, True, True]  # the bad one is sorted first
    merged = str(tmp_path / "port_merged.json")
    rc, out = _main(["trace", "merge"] + [t for t in traces if "bad" not in t]
                    + ["--out", merged], capsys)
    rc_j, out_j = work["jax"]["merged"]
    assert rc == rc_j == 0
    summary, summary_j = json.loads(out), json.loads(out_j)
    assert summary.pop("merged") == merged and summary_j.pop("merged") == "jax_merged.json"
    assert summary == summary_j and summary["events"] > 0
    with open(merged) as f, open(os.path.join(work["dir"], "jax_merged.json")) as g:
        assert json.load(f) == json.load(g)


def test_version_and_the_device_rule(work, capsys, monkeypatch):
    rc, out = _main(["version"], capsys)
    assert rc == 0 and f"paddle_tpu_torch {paddle_tpu_torch.__version__}" in out
    assert f"torch: {torch.__version__}" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = os.path.join(work["dir"], "textcls.py")
    assert tcli.main(["train", f"--config={cfg}", "--job=test"]) == 1
    err = capsys.readouterr().err
    assert "CUDA device by default and none is available" in err and "--device=cpu" in err


# ---------------------------------------------------------------------------
# lint over traced train steps: --donation, --numerics, --certify
# ---------------------------------------------------------------------------


def test_lint_donation_audits_the_three_builders(capsys):
    rc, out = _main(["lint", "--donation", "--device=cpu"], capsys)
    assert rc == 0, out
    assert "donation audit: 3 step builders traced, 0 T106 finding(s)" in out
    assert "no diagnostics" in out


def test_lint_numerics_package_and_config_legs(capsys):
    rc, out = _main(["lint", "--numerics", "--device=cpu"], capsys)
    assert rc == 0 and "no diagnostics" in out, out
    cfg = os.path.join(tcli_configs(), "demo_mnist_mlp.py")
    rc, out = _main(["lint", "--numerics", "--device=cpu", "--config", cfg,
                     "--compute-dtype", "bfloat16"], capsys)
    assert rc == 0 and "no diagnostics" in out, out
    # without --device and without CUDA: the device error, exit 1
    assert _main(["lint", "--numerics", "--config", cfg], capsys)[0] == 1


def test_lint_certify_accepts_and_rejects(capsys):
    cfg = os.path.join(tcli_configs(), "demo_text_lstm.py")
    rc, out = _main(["lint", "--numerics", "--certify", "--device=cpu", "--config", cfg,
                     "--compute-dtype", "bfloat16"], capsys)
    assert rc == 0, out
    assert "compute=bfloat16 master=float32 -> ACCEPT" in out and "__lstmemory_0__" in out
    rc, out = _main(["lint", "--numerics", "--certify", "--device=cpu", "--config", cfg,
                     "--compute-dtype", "bfloat16", "--master-dtype", "bfloat16"], capsys)
    assert rc == 1 and "-> REJECT" in out and "error[N402]" in out
    # a certificate is per topology: --certify needs --config
    assert _main(["lint", "--numerics", "--certify", "--device=cpu"], capsys)[0] == 2


def tcli_configs():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
