"""The port's master wire codec against the JAX package's: the same payload
encodes to equal bytes in both ``master_wire`` modules (fixed cases and a
hypothesis-driven sweep), each decodes the other's frames, both refuse the
same oversize, version-skewed and corrupt frames with the same error class
and rule, and the journals' PTJ2 frames are byte-equal and read by either
package (the PTJ1 legacy read included)."""

import os
import pickle
import struct
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddle_tpu import master_journal as jmj
from paddle_tpu import master_wire as jw
from paddle_tpu_torch import master_journal as tmj
from paddle_tpu_torch import master_wire as tw


def _deep_eq(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))
    if isinstance(a, np.generic):
        return type(a) is type(b) and (a == b or a != a)
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_deep_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_deep_eq(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _assert_same_wire(obj):
    jb, tb = jw.encode_payload(obj), tw.encode_payload(obj)
    assert jb == tb
    assert jw.encode_frame(jb, 1 << 30) == tw.encode_frame(tb, 1 << 30)
    assert _deep_eq(tw.decode_payload(jb), obj)
    assert _deep_eq(jw.decode_payload(tb), obj)
    assert _deep_eq(tw.decode_payload(tw.decode_frame(jw.encode_frame(jb, 1 << 30), 1 << 30)),
                    obj)


def test_constants_match():
    assert (tw.MAGIC, tw.VERSION, tw.FRAME_OVERHEAD, tw.MAX_DEPTH) == (
        jw.MAGIC, jw.VERSION, jw.FRAME_OVERHEAD, jw.MAX_DEPTH)
    assert tw.MAGIC == b"PTW"
    assert (tmj.MAGIC, tmj.MAGIC_V1) == (jmj.MAGIC, jmj.MAGIC_V1) == (b"PTJ2", b"PTJ1")


@pytest.mark.parametrize("obj", [
    None, True, False, 0, -1, 2**62, 2**100, -(2**200), 1.5, float("nan"), "", "日本語 text",
    b"", b"\x00\xff" * 7, [1, [2, [3, None]]], (1, (2,), "x"), {},
    {"a": 1, 2: "b", b"k": None, 1.5: True},
    {"grads": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.float32(-0.25)},
     "cost": 0.125, "rows": 8},
    {"q": np.arange(-5, 5, dtype=np.int8).reshape(2, 5), "u": np.arange(7, dtype=np.uint8)},
    np.zeros((0, 3), np.float64), np.asfortranarray(np.arange(6.0).reshape(2, 3)),
    np.complex64(1 + 2j), np.int16(-7), np.bool_(True),
])
def test_fixed_payloads_encode_to_equal_bytes(obj):
    _assert_same_wire(obj)


_DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32, np.int64, np.float16,
           np.float32, np.float64, np.complex64]


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = draw(st.lists(st.integers(0, 4), min_size=0, max_size=3))
    seed = draw(st.integers(0, 2**31 - 1))
    arr = np.asarray(np.random.RandomState(seed).randn(*shape) * 50)
    return arr.astype(dtype)


_keys = st.one_of(st.none(), st.booleans(), st.integers(-2**70, 2**70),
                  st.floats(allow_nan=False), st.text(max_size=6), st.binary(max_size=6))
_leaves = st.one_of(st.none(), st.booleans(), st.integers(-2**80, 2**80), st.floats(),
                    st.text(max_size=12), st.binary(max_size=12), _arrays())
_payloads = st.recursive(
    _leaves,
    lambda inner: st.one_of(st.lists(inner, max_size=4), st.tuples(inner, inner),
                            st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=12,
)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_payloads)
def test_hypothesis_payloads_encode_to_equal_bytes(obj):
    _assert_same_wire(obj)


@settings(max_examples=60, deadline=None)
@given(_payloads, st.integers(0, 10**6))
def test_hypothesis_corrupt_frames_refused_alike(obj, where):
    """A frame with one flipped byte is refused by both decoders with the
    same error class."""
    frame = bytearray(tw.encode_frame(tw.encode_payload(obj), 1 << 30))
    frame[where % len(frame)] ^= 0x5A
    outcomes = []
    for mod in (jw, tw):
        try:
            mod.decode_payload(mod.decode_frame(bytes(frame), 1 << 30))
            outcomes.append("ok")
        except mod.MasterWireError as exc:
            outcomes.append((type(exc).__name__, exc.rules))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] != "ok"


def test_errors_carry_the_same_class_and_rule():
    payload = tw.encode_payload({"g": np.zeros(1000, np.float32)})
    for mod in (jw, tw):
        with pytest.raises(mod.WireOversizeError, match="rpc_max_message_mb") as e:
            mod.encode_frame(payload, max_bytes=100)
        assert e.value.rules == ["P506"]
    good = tw.encode_frame(payload, 1 << 20)
    skew = good[:3] + bytes([tw.VERSION + 1]) + good[4:]
    for mod in (jw, tw):
        with pytest.raises(mod.WireOversizeError):
            mod.decode_frame(good, max_bytes=100)
        with pytest.raises(mod.WireVersionError) as e:
            mod.decode_frame(skew, 1 << 20)
        assert e.value.rules == ["P507"]
        with pytest.raises(mod.WireCorruptError) as e:
            mod.decode_frame(b"XYZ" + good[3:], 1 << 20)
        assert e.value.rules == ["P508"]
        with pytest.raises(mod.WireTypeError) as e:
            mod.encode_payload({"x": {1, 2}})
        assert e.value.rules == ["P501"]
        with pytest.raises(mod.WireCorruptError):
            mod.decode_payload(b"a\x01O\x00")  # object dtype string


def test_default_bound_is_the_flag(monkeypatch):
    assert tw.default_max_bytes() == jw.default_max_bytes() == 64 * 1024 * 1024
    monkeypatch.setenv("PADDLE_TPU_TORCH_RPC_MAX_MESSAGE_MB", "256")
    assert tw.default_max_bytes() == 256 * 1024 * 1024


def test_journal_frames_equal_and_cross_read(tmp_path):
    recs = [{"t": "join", "worker": f"w{i}", "blob": b"x" * i,
             "g": np.arange(i, dtype=np.float32)} for i in range(6)]
    for i, r in enumerate(recs):
        assert jmj.encode_frame(i + 1, r) == tmj.encode_frame(i + 1, r)
    for writer_mod, reader_mod, tag in ((jmj, tmj, "j"), (tmj, jmj, "t")):
        p = str(tmp_path / f"{tag}.log")
        w = writer_mod.JournalWriter(p, fsync=False)
        for i, r in enumerate(recs):
            w.append(i + 1, r)
        w.close()
        got, info = reader_mod.read_records(p)
        assert not info["torn"] and not info["corrupt"]
        assert [s for s, _ in got] == list(range(1, 7))
        assert all(_deep_eq(a, b) for (_, a), b in zip(got, recs))
        assert reader_mod.verify_journal(p) == []


def test_journal_legacy_ptj1_frames_replay_in_the_port(tmp_path):
    """A PTJ1 generation (pickled payloads, the JAX package's pre-codec
    journals) is read once by the port for the upgrade boot."""
    p = str(tmp_path / "old.log")
    with open(p, "wb") as f:
        for seq in (1, 2):
            blob = pickle.dumps({"t": "join", "worker": f"w{seq}"}, protocol=4)
            header = struct.pack(">QI", seq, len(blob))
            crc = zlib.crc32(header + blob) & 0xFFFFFFFF
            f.write(tmj.MAGIC_V1 + header + struct.pack(">I", crc) + blob)
        f.write(tmj.encode_frame(3, {"t": "leave", "worker": "w1"}))
    jgot, _ = jmj.read_records(p)
    tgot, info = tmj.read_records(p)
    assert tgot == jgot and [r["worker"] for _, r in tgot] == ["w1", "w2", "w1"]
    assert not info["corrupt"] and tmj.verify_journal(p) == []


def test_rpc_oversize_names_the_flag_and_does_not_hang(tmp_path):
    """A port Client whose contribution exceeds the bound fails at once,
    naming rpc_max_message_mb, against a port Server and a JAX Server."""
    import time

    from paddle_tpu import master as jmaster
    from paddle_tpu_torch import master as tmaster

    for smod in (tmaster, jmaster):
        svc = smod.Service(snapshot_path=str(tmp_path / f"{smod.__name__}.json"))
        srv = smod.Server(svc)
        try:
            client = tmaster.Client(srv.address, max_message_bytes=64 * 1024)
            t0 = time.monotonic()
            with pytest.raises(tw.WireOversizeError, match="rpc_max_message_mb"):
                client.task_finished(0, 0, {"grads": np.zeros(1 << 16, np.float32)})
            assert time.monotonic() - t0 < 5.0
            assert os.path.exists(str(tmp_path)) and client.stats()["pass_id"] == 0
            client.close()
        finally:
            srv.close()
