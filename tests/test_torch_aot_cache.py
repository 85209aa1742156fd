"""The port's persistent build store (paddle_tpu_torch/core/aot_cache.py)
against the JAX package's AOT executable cache on the CPU.

- Parity: an entry framed by either package reads back through the other's
  ``_read_entry`` with an equal header and blob (the files are byte-equal);
  ``_key_hash``, ``topology_fingerprint`` and ``mesh_fingerprint(None)``
  are equal; one sequence of stores, then ``prune``, removes the same
  files in both stores.
- The cases of ``tests/test_aot_cache.py`` on the port's store, with a
  build function the test supplies: miss then hit; distinct identities; a
  truncated blob and a truncation inside the header are corrupt and
  rebuilt; a rewritten torch version is stale and overwritten; a foreign
  entry renamed into place and a meta mismatch are stale and never load;
  ``optimizer_fingerprint`` tells hyperparameters and schedules apart;
  prune drops the oldest until the store fits; prune and clear sweep
  orphaned tmp files and extracted copies; clear empties the store; a
  rebuilt library gets a new path; threads warming one store agree.
- A real build: the recordio library through the store with g++ in a cold
  subprocess (one compile), then a warm subprocess with no g++ on its
  PATH (no compile, one load from the store) writes and reads a recordio
  file byte-equal to this process's.
- SGD with the ``aot_cache_dir`` flag: ``warm_compile`` resolves each rung
  once without stepping; a short trajectory equals the run without the
  flag bit for bit; the rungs' identities are the JAX package's; the flash
  routing predicate of a rung.
- The CLI: ``cache warm/ls/prune/clear`` on a config the test writes, its
  summary keys the JAX package's.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import aot_cache as jac
from paddle_tpu.utils.timers import StatSet as JStatSet
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.core import aot_cache as ac
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.utils.flags import reset_flags, set_flag
from paddle_tpu_torch.utils.timers import StatSet
from test_torch_parity import build_both, demo_mlp, mlp_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_flags():
    yield
    reset_flags()


def _identity(n=None, name="test_lib"):
    return {"kind": "native_library", "name": name, "sources": "s0", "argv": ["cc", "-O2"],
            "n": n}


class _FakeBuild:
    """A build_fn: writes `payload` as the library into the directory it is
    given and counts its runs."""

    def __init__(self, payload=b"\x7fELF-test-library" * 64):
        self.payload = payload
        self.runs = 0

    def __call__(self, out_dir):
        self.runs += 1
        path = os.path.join(out_dir, "lib.so")
        with open(path, "wb") as f:
            f.write(self.payload)
        return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _entry_paths(d):
    return sorted(os.path.join(d, n) for n in os.listdir(d) if n.endswith(ac._SUFFIX))


# ---------------------------------------------------------------------------
# parity with the JAX module
# ---------------------------------------------------------------------------


def test_entry_framing_is_the_jax_package_bytes(tmp_path):
    header = {"key": {"kind": "native_library", "torch": "x", "n": [1, 2]}, "created": 1.5,
              "blob_bytes": 5}
    blob = b"\x00\x01abc"
    jpath, tpath = str(tmp_path / "j.aotx"), str(tmp_path / "t.aotx")
    jac._write_entry(jpath, header, blob)
    ac._write_entry(tpath, header, blob)
    assert _read(jpath) == _read(tpath)
    assert ac._read_entry(jpath) == (header, blob) == jac._read_entry(tpath)
    assert ac._read_header(jpath) == jac._read_header(tpath)
    assert ac._MAGIC == jac._MAGIC and ac._SUFFIX == jac._SUFFIX
    with open(tpath, "r+b") as f:
        f.truncate(len(ac._MAGIC) + 2)
    for mod in (ac, jac):
        with pytest.raises(ValueError, match="truncated header length"):
            mod._read_entry(tpath)


def test_key_hash_and_fingerprints_equal_the_jax_package():
    for ident in (_identity(), _identity(n=3), {"kind": "train_step", "batch": "((x, (4,)),)"}):
        assert ac._key_hash(ident) == jac._key_hash(ident)
    (jcost, _), (tcost, _) = build_both(lambda pkg: demo_mlp(pkg, hidden=(8,), pixels=6))
    jnet = paddle_tpu.CompiledNetwork(paddle_tpu.Topology(jcost))
    tnet = paddle_tpu_torch.CompiledNetwork(paddle_tpu_torch.Topology(tcost))
    assert ac.topology_fingerprint(tnet) == jac.topology_fingerprint(jnet)
    assert ac.mesh_fingerprint(None) == jac.mesh_fingerprint(None) == "none"
    with pytest.raises(NotImplementedError, match="item 6a"):
        ac.mesh_fingerprint(object())
    assert ac.serialization_available()


def test_prune_removes_what_the_jax_package_removes(tmp_path):
    dirs = {}
    for name, mod in (("jax", jac), ("port", ac)):
        d = tmp_path / name
        d.mkdir()
        for i in range(4):
            ident = _identity(n=i)
            path = os.path.join(str(d), mod._key_hash(ident) + mod._SUFFIX)
            blob = bytes([i]) * (100 * (i + 1))
            mod._write_entry(path, {"key": ident, "created": i, "blob_bytes": len(blob)}, blob)
            os.utime(path, (10 + i, 10 + i))
        with open(os.path.join(str(d), "dead.aotx"), "wb") as f:
            f.write(b"not an entry")  # corrupt: goes first
        with open(os.path.join(str(d), "feed.aotx.tmp.4242"), "wb") as f:
            f.write(b"x" * 10)
        dirs[name] = str(d)
    jremoved = jac.AOTCache(dirs["jax"], stats=JStatSet()).prune(700)
    tremoved = ac.AOTCache(dirs["port"], stats=StatSet()).prune(700)
    assert tremoved == jremoved and len(tremoved) == 5  # tmp, corrupt, three oldest
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    assert sorted(ac.AOTCache(dirs["port"]).summary()) == sorted(
        jac.AOTCache(dirs["jax"], stats=JStatSet()).summary())


# ---------------------------------------------------------------------------
# the JAX package's cases on the port's store
# ---------------------------------------------------------------------------


def test_miss_then_hit_roundtrip(tmp_path):
    stats = StatSet()
    cache = ac.AOTCache(str(tmp_path), stats=stats)
    build = _FakeBuild()
    lib = cache.get_or_build(_identity(), None, build)
    assert build.runs == 1 and cache.compiles == 1 and cache.loads == 0
    assert stats.count("aot_cache/miss") == 1 and stats.count("aot_cache/hit") == 0
    assert _read(lib) == build.payload
    assert os.path.dirname(lib) == os.path.join(str(tmp_path), "lib")
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp." in n]  # the build dir is gone

    stats2 = StatSet()
    cache2 = ac.AOTCache(str(tmp_path), stats=stats2)
    again = cache2.get_or_build(_identity(), None, build)
    assert build.runs == 1 and cache2.compiles == 0 and cache2.loads == 1
    assert stats2.count("aot_cache/hit") == 1 and stats2.count("aot_cache/miss") == 0
    assert again == lib and _read(again) == build.payload
    (entry,) = _entry_paths(str(tmp_path))
    header, blob = ac._read_entry(entry)
    assert blob == build.payload and header["build_s"] >= 0 and header["compiler"] is None
    assert header["key"] == cache.full_key(_identity())


def test_distinct_identities_are_distinct_entries(tmp_path):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    a = cache.get_or_build(_identity(n=1), None, _FakeBuild(b"a" * 10))
    b = cache.get_or_build(_identity(n=2), None, _FakeBuild(b"b" * 10))
    assert a != b and _read(a) == b"a" * 10 and _read(b) == b"b" * 10
    assert len(cache.entries()) == 2 and cache.compiles == 2


@pytest.mark.parametrize("cut", ["blob", "header"])
def test_truncated_entry_is_rebuilt(tmp_path, caplog, cut):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    build = _FakeBuild()
    cache.get_or_build(_identity(), None, build)
    (path,) = _entry_paths(str(tmp_path))
    _, offset, _ = ac._read_header(path)
    with open(path, "r+b") as f:
        f.truncate(offset + 7 if cut == "blob" else len(ac._MAGIC) + 4 + 3)
    stats = StatSet()
    cache2 = ac.AOTCache(str(tmp_path), stats=stats)
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.aot_cache"):
        assert cache2.load(_identity()) is None
        lib = cache2.get_or_build(_identity(), None, build)
    assert stats.count("aot_cache/corrupt") == 2 and cache2.compiles == 1
    assert sum("damaged" in r.getMessage() for r in caplog.records) == 1  # warned once
    assert _read(lib) == build.payload
    assert ac.AOTCache(str(tmp_path), stats=StatSet()).load(_identity()) == lib  # overwritten


def test_mismatched_torch_version_key_is_stale(tmp_path, caplog):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    build = _FakeBuild()
    cache.get_or_build(_identity(), None, build)
    (path,) = _entry_paths(str(tmp_path))
    header, blob = ac._read_entry(path)
    header["key"]["torch"] = "0.0.1-foreign"
    ac._write_entry(path, header, blob)
    stats = StatSet()
    cache2 = ac.AOTCache(str(tmp_path), stats=stats)
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.aot_cache"):
        lib = cache2.get_or_build(_identity(), None, build)
    assert cache2.compiles == 1 and cache2.loads == 0 and build.runs == 2
    assert stats.count("aot_cache/stale") == 1
    assert any("torch" in r.getMessage() for r in caplog.records)
    assert ac._read_entry(path)[0]["key"]["torch"] == torch.__version__  # overwritten
    assert ac.AOTCache(str(tmp_path), stats=StatSet()).load(_identity()) == lib


def test_foreign_entry_never_loads(tmp_path):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    foreign = dict(_identity(), name="other_lib")
    cache.get_or_build(foreign, None, _FakeBuild(b"foreign" * 8))
    os.rename(cache.entry_path(foreign), cache.entry_path(_identity()))
    stats = StatSet()
    cache2 = ac.AOTCache(str(tmp_path), stats=stats)
    assert cache2.load(_identity()) is None and cache2.loads == 0
    assert stats.count("aot_cache/stale") == 1
    lib = cache2.get_or_build(_identity(), None, _FakeBuild(b"mine" * 8))
    assert cache2.compiles == 1 and _read(lib) == b"mine" * 8


def test_meta_mismatch_is_stale(tmp_path):
    """One library built for another device (the meta an nvcc library
    carries) is stale here."""
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    cache.get_or_build(_identity(), {"device_name": "H100", "capability": [9, 0]}, _FakeBuild())
    stats = StatSet()
    cache2 = ac.AOTCache(str(tmp_path), stats=stats)
    assert cache2.load(_identity(), {"device_name": "A100", "capability": [8, 0]}) is None
    assert stats.count("aot_cache/stale") == 1
    assert cache2.load(_identity(), {"device_name": "H100", "capability": [9, 0]}) is not None


def test_optimizer_fingerprint_distinguishes_hyperparams():
    O = paddle_tpu_torch.optimizer
    a = ac.optimizer_fingerprint(O.Adam(learning_rate=1e-2))
    b = ac.optimizer_fingerprint(O.Adam(learning_rate=1e-3))
    c = ac.optimizer_fingerprint(O.Momentum(momentum=0.9, learning_rate=1e-2))
    d = ac.optimizer_fingerprint(O.Adam(
        learning_rate=1e-2, learning_rate_schedule="exp",
        learning_rate_decay_a=0.5, learning_rate_decay_b=100.0))
    e = ac.optimizer_fingerprint(O.Adam(
        learning_rate=1e-2, learning_rate_schedule="exp",
        learning_rate_decay_a=0.5, learning_rate_decay_b=200.0))
    f = ac.optimizer_fingerprint(O.Adam(
        learning_rate=1e-2, regularization=O.L2Regularization(1e-4)))
    assert len({a, b, c, d, e, f}) == 6
    assert a == ac.optimizer_fingerprint(O.Adam(learning_rate=1e-2))
    assert d == ac.optimizer_fingerprint(O.Adam(
        learning_rate=1e-2, learning_rate_schedule="exp",
        learning_rate_decay_a=0.5, learning_rate_decay_b=100.0))


def test_prune_drops_oldest_until_fit(tmp_path):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    libs = []
    for i in range(3):
        libs.append(cache.get_or_build(_identity(n=i), None, _FakeBuild(bytes([i]) * 512)))
        os.utime(cache.entry_path(_identity(n=i)), (i + 1, i + 1))  # age order
    sizes = {e["file"]: e["bytes"] for e in cache.entries()}
    newest = cache.entry_path(_identity(n=2))
    removed = cache.prune(max_bytes=sizes[os.path.basename(newest)])
    assert len(removed) == 2 and os.path.exists(newest)
    assert [os.path.exists(p) for p in libs] == [False, False, True]  # extracted copies too
    assert cache.load(_identity(n=2)) == libs[2]


def test_prune_and_clear_sweep_orphaned_tmp_files(tmp_path):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    cache.get_or_build(_identity(), None, _FakeBuild())
    orphans = [os.path.join(str(tmp_path), "deadbeef.aotx.tmp.12345"),
               os.path.join(str(tmp_path), "lib", "deadbeef-00000000.so.tmp.12345.7")]
    os.makedirs(os.path.join(str(tmp_path), "build.tmp.12345.abc"))
    for p in orphans:
        with open(p, "wb") as f:
            f.write(b"x" * 1024)
    assert all("tmp" not in e["file"] for e in cache.entries())
    removed = cache.prune(max_bytes=1 << 30)  # fits: only the leftovers go
    assert sorted(removed) == sorted(["build.tmp.12345.abc", *map(os.path.basename, orphans)])
    assert not any(os.path.exists(p) for p in orphans)
    with open(orphans[0], "wb") as f:
        f.write(b"x")
    assert cache.clear() == 2  # the entry + the orphan
    assert os.listdir(str(tmp_path)) == []


def test_clear_empties_store(tmp_path):
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    lib = cache.get_or_build(_identity(), None, _FakeBuild())
    assert len(cache.entries()) == 1 and os.path.exists(lib)
    assert cache.clear() == 1
    assert cache.entries() == [] and not os.path.exists(lib)


def test_rebuilt_library_gets_a_new_path(tmp_path):
    """dlopen dedups by path: a rebuild with other bytes must never reuse
    (or rewrite) the path an earlier library was extracted to."""
    cache = ac.AOTCache(str(tmp_path), stats=StatSet())
    old = cache.get_or_build(_identity(), None, _FakeBuild(b"v1" * 32))
    (path,) = _entry_paths(str(tmp_path))
    header, blob = ac._read_entry(path)
    header["key"]["torch"] = "other"
    ac._write_entry(path, header, blob)
    new = ac.AOTCache(str(tmp_path), stats=StatSet()).get_or_build(
        _identity(), None, _FakeBuild(b"v2" * 32))
    assert new != old and _read(old) == b"v1" * 32 and _read(new) == b"v2" * 32
    ac.AOTCache(str(tmp_path), stats=StatSet()).prune(1 << 30)
    assert not os.path.exists(old) and os.path.exists(new)  # the overwritten bytes' copy


def test_threads_warming_one_store_agree(tmp_path):
    """Eight writers, each with its own store object, race on one cold
    entry: every one gets a path holding the built bytes, and the store
    ends with one valid entry."""
    payload = os.urandom(1 << 16)
    paths, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            try:
                paths.append(ac.AOTCache(str(tmp_path), stats=StatSet()).get_or_build(
                    _identity(), None, _FakeBuild(payload)))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(paths) == 8
    assert all(_read(p) == payload for p in paths)
    stats = StatSet()
    assert _read(ac.AOTCache(str(tmp_path), stats=stats).load(_identity())) == payload
    assert stats.count("aot_cache/corrupt") == 0


# ---------------------------------------------------------------------------
# a real build: the recordio library through the store
# ---------------------------------------------------------------------------

_RECORDIO_CHILD = """
import json, shutil, sys
from paddle_tpu_torch.core import aot_cache as ac
from paddle_tpu_torch.io import recordio
from paddle_tpu_torch.utils.flags import set_flag

set_flag("aot_cache_dir", sys.argv[1])
assert recordio.native_available()
records = [bytes([i % 251]) * (i * 7 % 300) for i in range(500)]
recordio.write_records(sys.argv[2], records, max_chunk_records=64)
back = list(recordio.Reader(sys.argv[2]))
print(json.dumps({**ac.process_store().summary(), "lib": recordio._lib._name,
                  "gxx": shutil.which("g++"), "read_back": back == records}))
"""


def _recordio_records():
    return [bytes([i % 251]) * (i * 7 % 300) for i in range(500)]


def _child(script, argv, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_TPU_TORCH_AOT_CACHE_DIR", None)
    env.update(env_extra or {})
    proc = subprocess.run([sys.executable, "-c", script, *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def recordio_store(tmp_path_factory):
    """A store the cold subprocess filled with the recordio library (g++
    ran once), and the cold run's report."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the cold build cannot run")
    d = tmp_path_factory.mktemp("rio")
    store = str(d / "store")
    cold = _child(_RECORDIO_CHILD, [store, str(d / "cold.rio")])
    return store, cold, str(d)


def test_recordio_library_boots_warm_without_gxx(recordio_store, tmp_path):
    store, cold, d = recordio_store
    assert (cold["compiles"], cold["miss"], cold["loads"], cold["hit"]) == (1, 1, 0, 0)
    assert cold["entries"] == 1 and cold["read_back"]
    assert cold["lib"].startswith(os.path.join(store, "lib") + os.sep)
    bare = tmp_path / "bin"  # a PATH without g++ (nor anything else)
    bare.mkdir()
    warm = _child(_RECORDIO_CHILD, [store, str(tmp_path / "warm.rio")], {"PATH": str(bare)})
    assert warm["gxx"] is None
    assert (warm["compiles"], warm["loads"], warm["hit"], warm["miss"]) == (0, 1, 1, 0)
    assert warm["stale"] == warm["corrupt"] == 0
    assert warm["lib"] == cold["lib"] and warm["read_back"]
    # the path without the store: this process's recordio, same bytes
    recordio.write_records(str(tmp_path / "plain.rio"), _recordio_records(),
                           max_chunk_records=64)
    assert _read(str(tmp_path / "warm.rio")) == _read(str(tmp_path / "plain.rio")) == _read(
        os.path.join(d, "cold.rio"))
    (entry,) = ac.AOTCache(store).entries()
    assert entry["key"]["name"] == "libpaddle_tpu_torch_io"
    assert entry["key"]["argv"][0] == "g++" and entry["compiler"].startswith("g++")


def test_host_library_keeps_the_jax_behaviour_without_source(tmp_path):
    so = str(tmp_path / "libx.so")
    assert ac.host_library(str(tmp_path / "missing.cc"), so, ("-O2",)) is None
    with open(so, "wb") as f:
        f.write(b"prebuilt")
    assert ac.host_library(str(tmp_path / "missing.cc"), so, ("-O2",)) == so


# ---------------------------------------------------------------------------
# SGD with the flag
# ---------------------------------------------------------------------------

FEEDING = {"pixel": 0, "label": 1}


def _trainer(pkg, seed=0):
    cost, _ = demo_mlp(pkg, hidden=(8,), classes=3, pixels=6)
    kw = {} if pkg is paddle_tpu else {"device": "cpu"}
    return pkg.trainer.SGD(cost, pkg.parameters.create(cost, seed=0, **kw),
                           pkg.optimizer.Adam(learning_rate=1e-2), seed=seed, **kw)


def _port_trainer():
    paddle_tpu_torch.core.topology.reset_auto_names()
    return _trainer(paddle_tpu_torch)


def _fed(trainer, rows):
    return trainer._make_feeder(FEEDING)(mlp_samples(rows, 0, classes=3, pixels=6))


def _params(trainer):
    return {f"{k}.{n}": v.detach().clone() for k, d in trainer.parameters.params.items()
            for n, v in d.items()}


def _opt_leaves(tree, prefix=""):
    """The optimizer state's tensors by dotted path, cloned."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_opt_leaves(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            out[prefix + k] = v.clone()
    return out


def test_warm_compile_resolves_each_rung_once_without_stepping(tmp_path):
    set_flag("aot_cache_dir", str(tmp_path))
    tr = _port_trainer()
    before = _params(tr)
    slots = _opt_leaves(tr._opt_state)
    b4, b6 = _fed(tr, 4), _fed(tr, 6)
    assert tr.warm_compile(b4) is True
    assert tr.warm_compile(b6) is True
    assert tr.warm_compile(b4) is False and tr.warm_compile(_fed(tr, 6)) is False
    assert tr._step_count == 0 and tr._opt_state["step"] == 0
    after = _params(tr)
    assert all(torch.equal(before[k], after[k]) for k in before)
    now = _opt_leaves(tr._opt_state)
    assert slots.keys() == now.keys() and all(torch.equal(slots[k], now[k]) for k in slots)
    assert tr._aot_cache is ac.process_store(str(tmp_path))
    assert tr._aot_cache.compiles == 0  # a CPU step launches no native library
    rung = tr._exec_table[("train_step", paddle_tpu_torch.core.batch.batch_shape_key(b4))]
    assert rung["libraries"] == {} and rung["identity"]["kind"] == "train_step"


def test_warm_compile_needs_the_flag():
    with pytest.raises(ValueError, match="aot_cache_dir"):
        _port_trainer().warm_compile({})


def _trajectory(flag_dir):
    reset_flags()
    if flag_dir:
        set_flag("aot_cache_dir", flag_dir)
    tr = _port_trainer()
    samples = mlp_samples(16, 3, classes=3, pixels=6)
    costs = []
    tr.train(paddle_tpu_torch.batch(lambda: iter(samples), 6), num_passes=2, feeding=FEEDING,
             async_load_data=False,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, paddle_tpu_torch.event.EndIteration) else None)
    res = tr.test(paddle_tpu_torch.batch(lambda: iter(samples), 6), feeding=FEEDING,
                  async_load_data=False)
    return tr, costs, res.cost


def test_trajectory_with_the_flag_equals_the_run_without(tmp_path):
    plain, plain_costs, plain_test = _trajectory(None)
    cached, costs, test_cost = _trajectory(str(tmp_path))
    assert costs == plain_costs and len(costs) == 6 and test_cost == plain_test
    a, b = _params(plain), _params(cached)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert plain._aot_cache is None and plain._exec_table == {}
    kinds = sorted(k[0] for k in cached._exec_table)
    assert kinds == ["eval_step", "eval_step", "train_step", "train_step"]  # 6- and 4-row rungs


def test_rung_identity_is_the_jax_package_identity(tmp_path):
    set_flag("aot_cache_dir", str(tmp_path))
    paddle_tpu.utils.flags.set_flag("aot_cache_dir", str(tmp_path / "jax"))
    try:
        paddle_tpu.core.topology.reset_auto_names()
        jtr = _trainer(paddle_tpu)
    finally:
        paddle_tpu.utils.flags.reset_flags()
    ttr = _port_trainer()
    samples = mlp_samples(4, 0, classes=3, pixels=6)
    jb = jtr._make_feeder(FEEDING)(samples)
    tb = ttr._make_feeder(FEEDING)(samples)
    for kind, n in (("train_step", None), ("epoch_program", 5)):
        want, got = jtr._aot_identity(kind, jb, n), ttr._aot_identity(kind, tb, n)
        assert got.pop("donation") == "in_place"
        want.pop("donation")
        assert got.pop("batch").replace("torch.", "") == want.pop("batch")
        assert got == want
    assert sorted(ttr._aot_meta()) == sorted(jtr._aot_meta())


def test_rung_routes_to_flash_by_the_batch_t_and_dh():
    """The flash library is a rung's library on the card when an attention
    layer routes to flash at the batch's T (supported: T >= 128, a multiple
    of min(128, T)) and dh; never on the CPU or with the flag off."""
    from paddle_tpu_torch.models.transformer import transformer_cost

    paddle_tpu_torch.core.topology.reset_auto_names()
    cost, _ = transformer_cost(30, 30, d_model=16, n_heads=2, n_layers=1, d_ff=16)
    tr = paddle_tpu_torch.trainer.SGD(cost, update_equation=paddle_tpu_torch.optimizer.Adam(),
                                      device="cpu")

    def batch(t):
        return {name: paddle_tpu_torch.core.batch.SeqTensor(
            torch.zeros((2, t), dtype=torch.int32), torch.full((2,), t, dtype=torch.int32))
            for name in ("src_word", "trg_word", "trg_next")}

    assert tr._rung_libraries(batch(128)) == ()  # the CPU
    tr.device = torch.device("cuda")
    set_flag("use_flash_attention", True)
    assert tr._rung_libraries(batch(128)) == ("flash_attention",)
    assert tr._rung_libraries(batch(256)) == ("flash_attention",)
    assert tr._rung_libraries(batch(64)) == ()  # below the kernels' T
    assert tr._rung_libraries(batch(200)) == ()  # not a multiple of 128
    set_flag("use_flash_attention", False)
    assert tr._rung_libraries(batch(128)) == ()


# ---------------------------------------------------------------------------
# the cache subcommand
# ---------------------------------------------------------------------------

_CONF = """
from paddle.trainer_config_helpers import *
define_py_data_sources2(train_list='t', test_list=None, module='prov', obj='process')
settings(batch_size=4, learning_rate=1e-3, learning_method=AdamOptimizer())
img = data_layer(name='pixel', size=12)
lbl = data_layer(name='label', size=3)
fc1 = fc_layer(input=img, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=fc1, label=lbl))
"""
_PROV = """
from paddle.trainer.PyDataProvider2 import *
@provider(input_types=[dense_vector(12), integer_value(3)], should_shuffle=False)
def process(settings, f):
    for i in range(16):
        yield [0.125 * (i % 8)] * 12, i % 3
"""


def _cache_cli(argv, capsys):
    capsys.readouterr()
    rc = tcli.main(["cache", *argv])
    out = capsys.readouterr().out
    return rc, out, json.loads(out.strip().splitlines()[-1]) if rc == 0 else None


def test_cache_cli_warm_ls_prune_clear(recordio_store, tmp_path, capsys):
    (tmp_path / "conf.py").write_text(_CONF)
    (tmp_path / "prov.py").write_text(_PROV)
    (tmp_path / "t").write_text("dummy\n")
    d = str(tmp_path / "store")
    cfg = str(tmp_path / "conf.py")
    rc, _, warm = _cache_cli(["warm", "--dir", d, "--config", cfg, "--batch_size", "6",
                              "--device=cpu"], capsys)
    assert rc == 0
    assert warm["shapes"] == 2  # 6-row batches and the 4-row tail
    assert (warm["compiles"], warm["entries"]) == (0, 0)  # a CPU step launches no library
    want = set(jac.AOTCache(str(tmp_path / "jax"), stats=JStatSet()).summary())
    assert set(warm) == want | {"config", "shapes", "warm_s"}

    shutil.rmtree(d)
    shutil.copytree(recordio_store[0], d)
    rc, out, summary = _cache_cli(["ls", "--dir", d], capsys)
    assert rc == 0 and summary["entries"] == 1 and set(summary) == want
    assert "kind=native_library, name=libpaddle_tpu_torch_io" in out and "compiler=g++" in out
    rc, _, pruned = _cache_cli(["prune", "--dir", d, "--max-mb", "0"], capsys)
    assert rc == 0 and pruned["entries"] == 0 and len(pruned["removed"]) == 1
    assert os.listdir(os.path.join(d, "lib")) == []
    shutil.rmtree(d)
    shutil.copytree(recordio_store[0], d)
    rc, _, cleared = _cache_cli(["clear", "--dir", d], capsys)
    assert rc == 0 and cleared["entries"] == 0 and cleared["removed"] == 1
    assert os.listdir(d) == []
    assert tcli.main(["cache", "prune", "--dir", d]) == 2
    assert tcli.main(["cache", "warm", "--dir", d]) == 2
