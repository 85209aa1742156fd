"""The port's data plane against the JAX package's, on the CPU:

- protodata files (every slot kind, gzip, sequence grouping) written by one
  package read back equal through the other, and the port's C++ fast-path
  decoder (built with g++ into the port's ``_build/``) agrees with the
  Python decoder;
- recordio files written by either package read equal through the
  other's Reader, Prefetcher, ``scan_chunks`` and ``creator.recordio_local``;
- ``reader.decorator``'s shuffle (seeded), buffered, xmap_readers, compose,
  chain, map_readers, cache and firstn yield the same samples;
  ``creator.cloud_reader`` leases the same samples from a master of either
  package as the JAX package's does;
- ``@provider`` and ``DataProviderConverter`` behave alike;
- the ``dataset/`` parsers read in-test fixture files (MNIST IDX, UCI
  housing) and serve their synthetic fallbacks alike; nothing is fetched.
"""

import gzip
import itertools
import random
import struct

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import data_provider as jdp
from paddle_tpu.io import protodata as jpd
from paddle_tpu.io import recordio as jrio
from paddle_tpu.reader import creator as jcreator
from paddle_tpu.reader import decorator as jdec
from paddle_tpu_torch import data_provider as tdp
from paddle_tpu_torch.io import protodata as tpd
from paddle_tpu_torch.io import recordio as trio
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as tdec


def _same(a, b):
    """Deep equality of samples (tuples, lists, ndarrays, numbers)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _proto_rows(rs, n=6):
    return [(rs.randn(4).astype(np.float32), sorted(rs.choice(100, 3, replace=False).tolist()),
             [(int(i), float(np.float32(rs.randn()))) for i in sorted(rs.choice(50, 2, False))],
             int(rs.randint(0, 3))) for _ in range(n)]


@pytest.mark.parametrize("writer,reader", [(jpd, tpd), (tpd, jpd)])
@pytest.mark.parametrize("name", ["t.bin", "t.bin.gz"])
def test_protodata_crosses_packages(writer, reader, name, tmp_path):
    defs = [writer.SlotDef(writer.VECTOR_DENSE, 4), writer.SlotDef(writer.VECTOR_SPARSE_NON_VALUE, 100),
            writer.SlotDef(writer.VECTOR_SPARSE_VALUE, 50), writer.SlotDef(writer.INDEX, 3)]
    rows = _proto_rows(np.random.RandomState(0))
    path = str(tmp_path / name)
    writer.write_proto_data(path, defs, rows)
    got = list(reader.make_reader([path])())
    want = list(writer.make_reader([path])())
    assert len(got) == len(rows) and _same(got, want)
    assert [repr(t) for t in reader.slot_input_types(reader.read_proto_header(path))] == \
        [repr(t) for t in writer.slot_input_types(writer.read_proto_header(path))]
    # sequence grouping
    seq_path = str(tmp_path / ("s" + name))
    writer.write_proto_data(seq_path, defs, rows, is_beginning=[True, False, False, True, False,
                                                                 False])
    assert _same(list(reader.make_reader([seq_path], sequence=True)()),
                 list(writer.make_reader([seq_path], sequence=True)()))


def test_native_protodata_decoder_matches_python(tmp_path):
    defs = [tpd.SlotDef(tpd.VECTOR_DENSE, 12), tpd.SlotDef(tpd.INDEX, 10)]
    rs = np.random.RandomState(1)
    rows = [(rs.randn(12).astype(np.float32), int(rs.randint(0, 10))) for _ in range(50)]
    path = str(tmp_path / "dense.bin")
    jpd.write_proto_data(path, defs, rows)
    nat = tpd.native_decode_dense_index(path)
    if nat is None:
        pytest.skip("no C++ toolchain to build the native decoder")
    assert tpd._NATIVE_SO.startswith(paddle_tpu_torch.__path__[0])
    got_defs, arrs = nat
    assert [(d.type, d.dim) for d in got_defs] == \
        [(d.type, d.dim) for d in jpd.read_proto_data(path)[0]]
    np.testing.assert_array_equal(arrs[0], np.stack([r[0] for r in rows]))
    np.testing.assert_array_equal(arrs[1], [r[1] for r in rows])
    assert _same(list(tpd.make_reader([path])()), list(jpd.make_reader([path])()))


@pytest.mark.parametrize("writer,reader", [(jrio, trio), (trio, jrio)])
def test_recordio_crosses_packages(writer, reader, tmp_path):
    recs = [bytes(np.random.RandomState(i).bytes(1 + 7 * i)) for i in range(40)]
    path = str(tmp_path / "data.rio")
    with writer.Writer(path, max_chunk_records=7) as w:
        for r in recs:
            w.write(r)
    got = []
    with reader.Reader(path) as r:
        while True:
            rec = r.next()
            if rec is None:
                break
            got.append(rec)
    assert got == recs
    assert [(c.offset, c.n_records) for c in reader.scan_chunks(path)] == \
        [(c.offset, c.n_records) for c in writer.scan_chunks(path)]
    with reader.Prefetcher([path]) as p:
        assert sorted(p) == sorted(recs)


def test_recordio_creator_and_dataset_convert(tmp_path):
    from paddle_tpu.dataset import common as jcommon
    from paddle_tpu_torch.dataset import common as tcommon

    samples = [(np.arange(i, i + 3, dtype=np.float32), i) for i in range(25)]
    tcommon.convert(str(tmp_path / "t"), lambda: iter(samples), 10, "shard")
    jcommon.convert(str(tmp_path / "j"), lambda: iter(samples), 10, "shard")
    for d in ("t", "j"):
        pattern = str(tmp_path / d / "shard-*")
        got = list(tcreator.recordio_local(pattern)())
        assert _same(got, list(jcreator.recordio_local(pattern)()))
        assert len(got) == 25
    # cloud_reader leases the shards from a master of either package
    from paddle_tpu import master as jmaster
    from paddle_tpu_torch import master as tmaster

    for smod in (tmaster, jmaster):
        for creator in (tcreator, jcreator):
            srv = smod.Server(smod.Service(chunks_per_task=1))
            try:
                leased = list(creator.cloud_reader(pattern, srv.address)())
            finally:
                srv.close()
            assert _same(sorted(leased, key=lambda s: int(s[1])), samples)
    assert list(tcreator.np_array(np.arange(3))()) == [0, 1, 2]
    txt = tmp_path / "lines.txt"
    txt.write_text("a\nb\n")
    assert list(tcreator.text_file(str(txt))()) == list(jcreator.text_file(str(txt))())


def _base():
    return lambda: iter(range(23))


def _pairs():
    return lambda: iter([(i, -i) for i in range(23)])


DECORATORS = {
    "shuffle": lambda d: d.shuffle(_base(), 8, rng=random.Random(3)),
    "buffered": lambda d: d.buffered(_base(), 4),
    "xmap_ordered": lambda d: d.xmap_readers(lambda x: x * x, _base(), 3, 4, order=True),
    "compose": lambda d: d.compose(_base(), _pairs()),
    "chain": lambda d: d.chain(_base(), _pairs()),
    "map_readers": lambda d: d.map_readers(lambda a, b: a + b[0], _base(), _pairs()),
    "cache": lambda d: d.cache(_base()),
    "firstn": lambda d: d.firstn(_base(), 5),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorators_yield_alike(name):
    got = list(DECORATORS[name](tdec)())
    want = list(DECORATORS[name](jdec)())
    assert got == want and len(got) > 0


def test_xmap_unordered_yields_the_same_set():
    got = list(tdec.xmap_readers(lambda x: x + 1, _base(), 4, 8)())
    assert sorted(got) == sorted(jdec.xmap_readers(lambda x: x + 1, _base(), 4, 8)())


def _provider(dp):
    @dp.provider(input_types=[dp.dense_vector(4), dp.integer_value(3)], should_shuffle=False,
                 cache=dp.CacheType.CACHE_PASS_IN_MEM, check=True)
    def process(settings, filename):
        rng = np.random.RandomState(0)
        for _ in range(20):
            yield rng.randn(4).astype(np.float32), int(rng.randint(3))

    return process


def test_provider_decorator_alike():
    treader, jreader = _provider(tdp)(), _provider(jdp)()
    got = list(treader())
    assert _same(got, list(jreader())) and len(got) == 20
    assert _same(list(treader()), got)  # the pass cache serves the second pass

    @tdp.provider(input_types=[tdp.dense_vector(4)], should_shuffle=False, check=True)
    def bad(settings, filename):
        yield (np.zeros(3, np.float32),)

    with pytest.raises(ValueError):
        list(bad()())
    conv = tdp.DataProviderConverter([tdp.dense_vector(4), tdp.integer_value(3)], device="cpu")
    batch = conv(got[:6])
    assert batch["slot_0"].data.shape == (6, 4) and batch["slot_1"].data.device.type == "cpu"


def _write_idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic) + struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture()
def data_home(tmp_path, monkeypatch):
    """Both packages' dataset cache pointed at a fresh directory."""
    from paddle_tpu.dataset import common as jcommon
    from paddle_tpu_torch.dataset import common as tcommon

    for mod in (jcommon, tcommon):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))
    return tmp_path


def test_dataset_parsers_read_fixture_files(data_home):
    from paddle_tpu.dataset import mnist as jmnist, uci_housing as juci
    from paddle_tpu_torch.dataset import mnist as tmnist, uci_housing as tuci

    rs = np.random.RandomState(0)
    (data_home / "mnist").mkdir()
    _write_idx(str(data_home / "mnist" / "train-images-idx3-ubyte.gz"),
               rs.randint(0, 256, size=(6, 28, 28)), 2051)
    _write_idx(str(data_home / "mnist" / "train-labels-idx1-ubyte.gz"),
               rs.randint(0, 10, size=(6,)), 2049)
    (data_home / "uci_housing").mkdir()
    np.savetxt(str(data_home / "uci_housing" / "housing.data"), rs.rand(20, 14))
    got, want = list(tmnist.train()()), list(jmnist.train()())
    assert len(got) == 6 and _same(got, want)
    assert _same(list(tuci.train()()), list(juci.train()())) and len(list(tuci.train()())) == 16
    assert _same(list(tuci.test()()), list(juci.test()()))


DATASETS = {
    "cifar": lambda m: m.cifar.train10(),
    "imdb": lambda m: m.imdb.train(m.imdb.word_dict()),
    "imikolov": lambda m: m.imikolov.train(m.imikolov.build_dict(), 5),
    "wmt14": lambda m: m.wmt14.train(100),
    "conll05": lambda m: m.conll05.test(),
    "movielens": lambda m: m.movielens.train(),
    "mq2007": lambda m: m.mq2007.train("pairwise"),
    "sentiment": lambda m: m.sentiment.train(),
    "flowers": lambda m: m.flowers.train(),
    "voc2012": lambda m: m.voc2012.train(),
    "mnist": lambda m: m.mnist.test(),
    "uci_housing": lambda m: m.uci_housing.test(),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_fallbacks_alike(name, data_home):
    import paddle_tpu.dataset as jds
    import paddle_tpu_torch.dataset as tds

    got = list(itertools.islice(DATASETS[name](tds)(), 4))
    want = list(itertools.islice(DATASETS[name](jds)(), 4))
    assert len(got) == 4 and _same(got, want)
