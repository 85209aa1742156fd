"""v1 config-file compatibility of the port — a copy of the JAX package's
``v1_compat``: reference-era trainer configs run unmodified.

``parse_config(path, config_arg_str)`` mirrors the reference entry
(python/paddle/trainer/config_parser.py:3669 parse_config): it installs
``paddle.trainer_config_helpers`` / ``paddle.trainer.PyDataProvider2`` import
shims, executes the config file, and returns a :class:`ParsedConfig` holding
the built Topology, trainer settings, and data-source declarations — instead
of the reference's protobuf TrainerConfig.

Data-layer input types: v1 ``data_layer`` declares only a size; the real slot
types belong to the data provider (reference DataProvider2 ownership).  After
executing the config we import the declared provider module and resolve each
data layer's InputType from the @provider declaration, so feeding/training
work end to end.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import os
import sys
import threading
import types
import warnings
from typing import Dict, List, Optional

from paddle_tpu_torch.core.topology import LayerConf, Topology

from paddle_tpu_torch.v1_compat import config_helpers as _helpers
from paddle_tpu_torch.v1_compat.config_helpers import (  # noqa: F401
    DataSources,
    TrainerSettings,
)

__all__ = [
    "parse_config",
    "ParsedConfig",
    "make_optimizer",
    "make_data_reader",
    "make_provider_reader",
    "make_config_reader",
    "make_batched_reader",
]


def _install_import_shims() -> None:
    """Make ``paddle.trainer_config_helpers`` / ``paddle.trainer.
    PyDataProvider2`` importable (configs and providers import them by these
    reference names), bound to the port's helpers and provider module on
    every call.  The shim ``paddle`` module carries the same marker
    attribute as the JAX package's, so each package accepts (and rebinds)
    the other's; a real paddle package is never shadowed."""
    if "paddle" in sys.modules and not getattr(
        sys.modules["paddle"], "__paddle_tpu_shim__", False
    ):
        raise RuntimeError("a real `paddle` package is importable; refusing to shim")
    import paddle_tpu_torch.data_provider as pdp2

    paddle_mod = sys.modules.get("paddle")
    if paddle_mod is None:
        paddle_mod = types.ModuleType("paddle")
        paddle_mod.__paddle_tpu_shim__ = True
        sys.modules["paddle"] = paddle_mod
    trainer_mod = types.ModuleType("paddle.trainer")
    trainer_mod.PyDataProvider2 = pdp2
    sys.modules["paddle.trainer"] = trainer_mod
    sys.modules["paddle.trainer.PyDataProvider2"] = pdp2
    sys.modules["paddle.trainer_config_helpers"] = _helpers
    paddle_mod.trainer = trainer_mod
    paddle_mod.trainer_config_helpers = _helpers


@dataclasses.dataclass
class ParsedConfig:
    topology: Topology
    settings: TrainerSettings
    data_sources: Optional[DataSources]
    input_layers: List[str]
    output_layers: List[str]
    evaluators: List = dataclasses.field(default_factory=list)
    provider_input_types: Optional[dict] = None  # name -> InputType (if resolved)
    # Default feeding map {layer_name: index_in_sample_tuple}.  Non-None only
    # when slot binding had to PERMUTE provider slots onto data layers (the
    # unique-assignment path in _bind_slots): provider tuples stay in slot
    # order, so the trainer must pair them through this map — pass it as
    # DataFeeder's ``feeding``.  None ⇒ identity (positional) feeding.
    feeding: Optional[dict] = None
    # old-face TrainData/TestData declarations (config_parser.py:1115)
    train_data: Optional[object] = None
    test_data: Optional[object] = None
    # provenance + parse-level context (the JAX package's graph linter reads
    # them): the config file that built this
    # topology, and EVERY layer name the config created — including ones
    # that never reached an output (dead-layer rule G005)
    source_file: Optional[str] = None
    all_layer_names: List[str] = dataclasses.field(default_factory=list)

    def serialize(self) -> str:
        return self.topology.serialize()


def _parse_config_args(config_arg_str: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for piece in (config_arg_str or "").split(","):
        piece = piece.strip()
        if piece:
            k, _, v = piece.partition("=")
            out[k.strip()] = v.strip()
    return out


def _read_file_list(list_path: Optional[str], config_dir: str) -> list:
    """Entries of a train/test .list file (one data path per line), resolved
    like the reference trainer does — relative to the run directory."""
    if not list_path:
        return []
    p = list_path if os.path.isabs(list_path) else os.path.join(config_dir, list_path)
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _infer_slot_type(value, size: int):
    """Infer a slot's InputType from one sample value + the data layer's
    declared size (the first-batch introspection fallback; the reference
    always gets types from the provider object — PyDataProvider2.cpp:54-69 —
    so this only covers providers whose hook ran but declared nothing).
    Returns None when the value shape is ambiguous."""
    import numpy as _np

    from paddle_tpu_torch.core import data_types as _dt

    if isinstance(value, (int, _np.integer)):
        return _dt.integer_value(size)
    if isinstance(value, (float, _np.floating)):
        return _dt.dense_vector(1) if size == 1 else None
    if isinstance(value, _np.ndarray):
        if value.ndim == 1 and value.size == size:
            return _dt.dense_vector(size)
        if value.ndim == 2 and value.shape[1] == size:
            return _dt.dense_vector_sequence(size)
        return None
    if isinstance(value, (list, tuple)):
        if not value:
            return None
        first = value[0]
        if isinstance(first, (int, _np.integer)):
            # A list of ints is ALWAYS an id sequence in v1 providers —
            # dense values come as floats/ndarrays (PyDataProvider2.cpp
            # slot types).  Never fall back to dense on len==size; that
            # coincidence mis-fed small-size configs and is first-sample-
            # dependent.
            if all(isinstance(v, (int, _np.integer)) for v in value):
                return _dt.integer_value_sequence(size)
            return None
        if isinstance(first, (float, _np.floating)):
            return _dt.dense_vector(size) if len(value) == size else None
        if isinstance(first, (list, tuple, _np.ndarray)):
            if (
                first
                and isinstance(first, (list, tuple))
                and len(first) == 2
                and isinstance(first[0], (int, _np.integer))
                and isinstance(first[1], (float, _np.floating))
            ):
                return _dt.sparse_float_vector(size)
            inner = [len(v) for v in value]
            if all(n == size for n in inner):
                return _dt.dense_vector_sequence(size)
            return None
    return None


def _resolve_data_path(p: str, config_dir: str) -> Optional[str]:
    """Reference data paths are relative to the RUN directory (the trainer
    is launched from the source root: ``trainer/tests/mnist.list``), not the
    config file — try the config dir, then each ancestor, then the bare
    basename next to the config."""
    if os.path.isabs(p):
        return p if os.path.exists(p) else None
    cands = [p, os.path.join(config_dir, p)]
    d = config_dir
    for _ in range(4):
        d = os.path.dirname(d) or "/"
        cands.append(os.path.join(d, p))
    cands.append(os.path.join(config_dir, os.path.basename(p)))
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _proto_data_files(dc, config_dir: str) -> list:
    """Expand a ProtoData files= declaration (a .list file of data paths, or
    a direct data path) into existing absolute paths."""
    if not dc or not dc.files:
        return []
    lst = _resolve_data_path(dc.files, config_dir)
    if lst is None:
        return []
    if lst.endswith(".list") or lst.endswith(".txt"):
        with open(lst) as f:
            entries = [ln.strip() for ln in f if ln.strip()]
        out = []
        for e in entries:
            r = _resolve_data_path(e, config_dir) or _resolve_data_path(
                e, os.path.dirname(lst)
            )
            if r:
                out.append(r)
        return out
    return [lst]


def _bind_and_assign_slot_types(
    parsed: ParsedConfig, itypes, label: str
) -> bool:
    """Shared tail of every old-face type resolver: positional/unique-bind
    the slot types to the data layers (recording a feeding permutation when
    one fires), assign them onto the frozen confs, and populate
    provider_input_types.  A bind failure marks the slots unresolved (the
    topology must stay buildable; the error surfaces at feed time) and
    still returns True — the declaration WAS handled."""
    data_confs = list(parsed.topology.data_layers().values())
    try:
        aligned, feeding = _bind_slots(itypes, data_confs, label)
        if feeding is not None:
            parsed.feeding = feeding
    except ValueError as e:
        _mark_unresolved_msg(parsed, str(e))
        return True
    resolved = {}
    for conf, t in zip(data_confs, aligned):
        if t is not None and conf.attrs.get("_v1_size_only"):
            object.__setattr__(conf, "input_type", t)
            conf.attrs.pop("_v1_size_only", None)
            resolved[conf.name] = t
    parsed.provider_input_types = resolved
    return True


def _simple_sample_dim(dc) -> int:
    """SimpleData's per-sample feature width: feat_dim * (2*context_len + 1)
    (SimpleDataProviderBase ctor, DataProvider.cpp:223)."""
    return int(dc.feat_dim) * (2 * int(dc.context_len or 0) + 1)


def _resolve_simple_data_types(parsed: ParsedConfig, config_dir: str) -> bool:
    """Old-face ``TrainData(SimpleData(files=...))`` (the reference's
    text-format provider, DataProvider.cpp SimpleDataProvider::loadDataFile:
    each line is ``label feat_1 .. feat_sampleDim``): one dense slot of
    sample_dim plus an integer label slot."""
    td = parsed.train_data
    if td is None or getattr(td, "kind", None) != "simple":
        return False
    if td.feat_dim is None:
        _mark_unresolved_msg(parsed, "SimpleData declares no feat_dim")
        return True
    from paddle_tpu_torch.core.data_types import dense_vector, integer_value

    dim = _simple_sample_dim(td)
    return _bind_and_assign_slot_types(
        parsed, [dense_vector(dim), integer_value(1)],
        f"SimpleData({td.files})",
    )


def make_simple_data_reader(
    parsed: ParsedConfig, config_dir: str, train: bool = True
):
    """Reader over a SimpleData text declaration: yields
    ``(feats float32[sample_dim], int label)`` rows exactly as
    SimpleDataProvider::loadDataFile parses them."""
    import numpy as _np

    dc = parsed.train_data if train else (parsed.test_data or parsed.train_data)
    files = _proto_data_files(dc, config_dir)  # same .list/.txt expansion
    if not files:
        raise FileNotFoundError(
            f"SimpleData files {dc.files!r} not found under {config_dir}"
        )
    dim = _simple_sample_dim(dc)

    def reader():
        for path in files:
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts) != dim + 1:
                        raise ValueError(
                            f"{path}: expected label + {dim} feats per "
                            f"line, got {len(parts)} fields"
                        )
                    yield (
                        _np.asarray(parts[1:], _np.float32),
                        int(parts[0]),
                    )

    if train:
        # SimpleDataProviderBase::reset shuffles every pass
        # (DataProvider.cpp fillBuffer -> shuffle); a label-sorted text
        # file must not train in single-class batches
        from paddle_tpu_torch.reader.decorator import shuffle as _shuffle

        return _shuffle(reader, 65536)
    return reader


def _resolve_proto_data_types(parsed: ParsedConfig, config_dir: str) -> bool:
    """Old-face ``TrainData(ProtoData(files=...))``: the binary data's OWN
    DataHeader is the authoritative slot-type source
    (ProtoDataProvider.cpp:84 checkDataHeader) — read it and bind the slots
    to the data layers in feeding order.  Returns True when handled."""
    td = parsed.train_data
    if td is None or getattr(td, "kind", None) != "proto":
        return False
    files = _proto_data_files(td, config_dir)
    if not files:
        _mark_unresolved_msg(
            parsed, f"proto data files {td.files!r} not found under {config_dir}"
        )
        return True
    from paddle_tpu_torch.io.protodata import read_proto_header, slot_input_types

    defs = read_proto_header(files[0])
    sequence = (getattr(td, "type", None) or "").endswith("sequence")
    try:
        itypes = slot_input_types(defs, sequence=sequence)
    except ValueError as e:
        _mark_unresolved_msg(parsed, str(e))
        return True
    return _bind_and_assign_slot_types(
        parsed, itypes, f"ProtoData({td.files})"
    )


def make_data_reader(
    parsed: ParsedConfig,
    config_dir: str,
    train: bool = True,
    shuffle: bool = True,
):
    """Reader over a parsed config's old-face data declaration (currently
    the ProtoData binary format; py/simple providers feed through
    define_py_data_sources2 instead).  Returns a v2-style reader callable
    yielding sample tuples in the config's feeding order.

    shuffle=True matches ProtoDataProvider::reset, which shuffles every
    pass unless skip_shuffle (ProtoDataProvider.cpp:372-379) — the
    checked-in mnist_bin_part is label-SORTED, so unshuffled training
    oscillates exactly as single-class batches would."""
    dc = parsed.train_data if train else parsed.test_data
    if dc is None or getattr(dc, "kind", None) != "proto":
        raise ValueError(
            "make_data_reader supports TrainData(ProtoData(...)) configs; "
            f"got {dc!r}"
        )
    files = _proto_data_files(dc, config_dir)
    if not files:
        raise FileNotFoundError(
            f"proto data files {dc.files!r} not found under {config_dir}"
        )
    from paddle_tpu_torch.io.protodata import make_reader

    sequence = (getattr(dc, "type", None) or "").endswith("sequence")
    rd = make_reader(files, sequence=sequence)
    if shuffle and not train:
        shuffle = False  # test data is read in order (reference skipShuffle)
    if shuffle:
        from paddle_tpu_torch.reader.decorator import shuffle as _shuffle

        # whole-dataset buffer: the reference loads all records into memory
        # and permutes sequence ids (loadDataAll + shuffledSequenceIds_)
        rd = _shuffle(rd, 65536)
    return rd


def _load_provider_module(module_name: str, config_dir: str):
    """Import a data-provider module for a config.  Loads by file path under
    a config-dir-unique module name: different demo dirs reuse the same
    provider module name (e.g. "dataprovider"), and importlib.import_module
    would hand the second config the first one's cached module — wrong input
    types, silently."""
    mod_path = os.path.join(config_dir, module_name + ".py")
    sys.path.insert(0, config_dir)  # provider's own sibling imports
    try:
        with _py2_shims():
            if os.path.exists(mod_path):
                # cache key: path + mtime, under a prefix of the port's own
                # (a provider module the JAX package loaded holds the JAX
                # package's @provider) — one CLI run touches the module
                # three times (type resolution + train reader + test reader)
                # and real providers do heavy module-level work (dict loads);
                # an edited file gets a new mtime, so staleness is bounded
                # to one exec per file version, and a FAILED exec is never
                # cached (the entry is dropped on the way out)
                mtime = int(os.stat(mod_path).st_mtime_ns)
                uniq = (
                    f"_v1_torch_provider_{abs(hash(os.path.abspath(mod_path)))}"
                    f"_{mtime}_{module_name}"
                )
                if uniq in sys.modules:
                    return sys.modules[uniq]
                spec = importlib.util.spec_from_file_location(uniq, mod_path)
                mod = importlib.util.module_from_spec(spec)
                # py2-era provider files (reference demos predate python 3)
                mod.xrange = range
                mod.unicode = str
                sys.modules[uniq] = mod
                try:
                    spec.loader.exec_module(mod)
                except BaseException:
                    sys.modules.pop(uniq, None)
                    raise
                _py2_patch_siblings(config_dir)
                return mod
            mod = importlib.import_module(module_name)
            _py2_patch_siblings(config_dir)
            return mod
    finally:
        sys.path.pop(0)


def _py2_patch_siblings(config_dir: str) -> None:
    """Give py2-era helper modules the provider pulled in from the config
    dir (e.g. v1_api_demo/mnist/mnist_util.py: `for i in xrange(n)`) the
    same xrange/unicode aliases the provider module itself gets — their
    generator bodies run at ITERATION time, long after the _py2_shims
    context has exited."""
    prefix = os.path.abspath(config_dir) + os.sep
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and os.path.abspath(f).startswith(prefix):
            if not hasattr(mod, "xrange"):
                mod.xrange = range
            if not hasattr(mod, "unicode"):
                mod.unicode = str


def make_provider_reader(
    parsed: ParsedConfig, config_dir: str, train: bool = True
):
    """Reader over a config's ``define_py_data_sources2`` declaration: import
    the provider module and call its @provider factory with the train/test
    file list + declared args — what the reference trainer does through
    PyDataProvider2.cpp:665 (embed CPython, call the decorated object).
    Returns a v2-style reader callable yielding sample tuples."""
    ds = parsed.data_sources
    if ds is None or not ds.module:
        raise ValueError(
            "config declares no define_py_data_sources2 provider"
        )
    module = ds.module if train else (ds.test_module or ds.module)
    obj_name = ds.obj if train else (ds.test_obj or ds.obj)
    mod = _load_provider_module(module, config_dir)
    obj = getattr(mod, obj_name, None)
    if obj is None:
        raise ValueError(
            f"provider module {module!r} has no object {obj_name!r}"
        )
    list_path = ds.train_list if train else ds.test_list
    files = _read_file_list(list_path, config_dir)
    # list entries are run-dir-relative in the reference; resolve against the
    # config dir when the cwd doesn't have them so configs run from anywhere
    files = [
        f
        if os.path.isabs(f) or os.path.exists(f)
        else os.path.join(config_dir, f)
        for f in files
    ]
    with _in_dir(config_dir), _py2_shims():
        rd = obj(*files, is_train=train, **(ds.args or {}))
    return rd


def make_config_reader(
    parsed: ParsedConfig, config_dir: str, train: bool = True
):
    """One entry point over both data planes: old-face
    ``TrainData(ProtoData(...))`` binary files and
    ``define_py_data_sources2`` python providers.  The CLI trainer feeds
    from this."""
    dc = parsed.train_data if train else parsed.test_data
    if dc is not None and getattr(dc, "kind", None) == "proto":
        return make_data_reader(parsed, config_dir, train=train)
    if dc is not None and getattr(dc, "kind", None) == "simple":
        return make_simple_data_reader(parsed, config_dir, train=train)
    return make_provider_reader(parsed, config_dir, train=train)


def make_batched_reader(
    parsed: ParsedConfig, config_dir: str, batch_size: int, train: bool = True
):
    """Sample reader → minibatch reader for a parsed v1 config, honoring the
    bucketing flags: with ``use_bucketing`` on, variable-length samples route
    through :func:`reader.bucketing.token_budget_batch` (token budget =
    ``bucketing_token_budget`` flag, else derived from ``batch_size`` × the
    first window's tallest ladder rung) so reference configs opt into
    length-bucketed feeding WITHOUT any config edits — the trainer's
    DataFeeder pads the emitted batches to the same shape ladder (SGD reads
    the flag too).  Flag off: plain ``paddle.batch`` semantics."""
    rd = make_config_reader(parsed, config_dir, train=train)
    from paddle_tpu_torch.utils.flags import get_flag

    if not get_flag("use_bucketing"):
        from paddle_tpu_torch import minibatch

        return minibatch.batch(rd, batch_size)
    from paddle_tpu_torch.reader.bucketing import token_budget_batch

    budget = get_flag("bucketing_token_budget") or None
    return token_budget_batch(
        rd, token_budget=budget, batch_size=batch_size
    )


def _mark_unresolved_msg(parsed: ParsedConfig, reason: str) -> None:
    for c in parsed.topology.data_layers().values():
        if c.attrs.get("_v1_size_only"):
            c.attrs["_v1_unresolved"] = f"slot types unknown: {reason}"


def _slot_compatible(t, conf) -> bool:
    """Does slot type ``t`` dim-check against data layer ``conf``?  Dense and
    sparse slots must match the declared layer size exactly; index slots are
    compatible with any size — reference providers routinely declare
    ``integer_value(1)`` for a 1000-class label (benchmark provider.py
    initHook), so the value range carries no binding signal."""
    from paddle_tpu_torch.core.data_types import SlotKind

    if t is None:
        return False
    if t.kind == SlotKind.INDEX:
        return True
    return t.dim == conf.size


def _bind_slots(itypes, data_confs, label: str):
    """Bind positional provider slot types to data layers, validating dims.

    Positional order is the contract (reference config_parser.py:205-222),
    but providers written against the DFS input order break silently if the
    orders ever diverge — so every binding is dim-checked, and when the
    positional binding fails the check we search for the assignment that
    does dim-check.  A unique consistent assignment is used (with a
    warning); none or several → hard error, never a silent mis-feed.
    Returns ``(aligned, feeding)``: a list of types aligned with
    ``data_confs`` plus a ``{layer_name: sample_index}`` feeding map —
    ``None`` for the identity (positional) binding.  The feeding map is NOT
    optional information when present: sample tuples stay in provider slot
    order, so a permuted binding that is not also fed through this map would
    deliver every value to the wrong layer (the types were re-aligned, the
    data wasn't)."""
    n = len(data_confs)
    if len(itypes) != n:
        raise ValueError(
            f"{label}: provider declares {len(itypes)} slots but the config "
            f"has {n} data layers "
            f"({[c.name for c in data_confs]})"
        )
    if all(_slot_compatible(t, c) for t, c in zip(itypes, data_confs)):
        return list(itypes), None
    # positional binding fails the dim check: search assignments over the
    # slot×layer candidate matrix
    cand = [
        [t if _slot_compatible(t, c) else None for c in data_confs]
        for t in itypes
    ]
    res = _unique_assignment(cand, n)
    if res is not None:
        out, assign = res
        # assign[slot_i] = layer_j  ⇒  layer_j reads sample index slot_i
        feeding = {
            data_confs[j].name: i for i, j in enumerate(assign)
        }
        if all(i == j for i, j in enumerate(assign)):
            feeding = None  # distinct mapping happens to be positional
        warnings.warn(
            f"{label}: provider slot types do not dim-check against the "
            f"data layers in feeding order "
            f"({[c.name for c in data_confs]}); using the unique "
            "dim-consistent assignment instead"
            + (f" with feeding map {feeding}" if feeding else ""),
            stacklevel=2,
        )
        return out, feeding
    raise ValueError(
        f"{label}: cannot bind provider slot types {itypes} to data layers "
        f"{[(c.name, c.size) for c in data_confs]}: no unique dim-consistent "
        "assignment exists.  Declare input_types in feeding order "
        "(Inputs(...) order if set, else DFS order from the outputs) or fix "
        "the slot dims."
    )


def _unique_assignment(cand, n: int):
    """Perfect matching over ``cand[slot][layer]`` (None = incompatible).
    Returns the layer-aligned type list when exactly one DISTINCT
    layer→type mapping exists (identical types swapping slots count as the
    same mapping), else None.  The search dedups into distinct mappings as
    it goes and stops only once TWO exist — capping raw solution count
    instead would declare ambiguous bindings unique whenever the first
    branch alone yields many permutations of equal types."""
    distinct: set = set()
    first_sol: list = []
    budget = [200_000]  # node guard: factorial worst case bails to "no
    # unique assignment" (the hard-error path), never to a wrong binding

    def search(i: int, used: int, assign: list) -> None:
        if len(distinct) > 1 or budget[0] <= 0:
            return
        budget[0] -= 1
        if i == n:
            key = tuple(
                sorted((j, repr(cand[i2][j])) for i2, j in enumerate(assign))
            )
            if key not in distinct:
                distinct.add(key)
                if len(distinct) == 1:
                    first_sol[:] = assign
            return
        for j in range(n):
            if cand[i][j] is not None and not used & (1 << j):
                assign.append(j)
                search(i + 1, used | (1 << j), assign)
                assign.pop()

    search(0, 0, [])
    if len(distinct) != 1 or budget[0] <= 0:  # exhausted => possibly ambiguous
        return None
    out = [None] * n
    for i, j in enumerate(first_sol):
        out[j] = cand[i][j]
    return out, list(first_sol)


def _first_sample(obj, ds, config_dir: str):
    """One sample from the provider, shuffle disabled (is_train=False keeps
    the pool from buffering 1024 samples before the first yield)."""
    files = _read_file_list(ds.train_list, config_dir)
    rd = obj(*files, is_train=False, **(ds.args or {}))
    return next(iter(rd()))


def _resolve_provider_types(parsed: ParsedConfig, config_dir: str) -> None:
    """Import the declared provider module and patch data-layer InputTypes
    from the provider object itself: its @provider(input_types=...)
    declaration, else its init_hook run with the config's real args + file
    list (reference PyDataProvider2.cpp:665 embeds CPython and reads
    input_types after init_hook), else first-batch introspection.  Slots
    still unresolved are marked so feeding raises instead of silently using
    a dense placeholder."""
    if _resolve_proto_data_types(parsed, config_dir):
        return
    if _resolve_simple_data_types(parsed, config_dir):
        return
    ds = parsed.data_sources
    if ds is None or not ds.module:
        return
    try:
        mod = _load_provider_module(ds.module, config_dir)
    except ImportError as e:
        _mark_unresolved(parsed, ds, f"provider module import failed: {e!r}")
        return
    obj = getattr(mod, ds.obj, None)
    itypes = getattr(obj, "input_types", None)
    names = getattr(obj, "slot_names", None)
    hook_error: Optional[BaseException] = None
    if itypes is None and hasattr(obj, "resolve_input_types"):
        # hook-declared types (reference initializer pattern); hooks open
        # data files relative to the config/run dir, so resolve from there
        try:
            with _in_dir(config_dir), _py2_shims():
                itypes, names = obj.resolve_input_types(
                    file_list=_read_file_list(ds.train_list, config_dir),
                    **(ds.args or {}),
                )
        except Exception as e:
            hook_error = e
            itypes = None
    data_confs = list(parsed.topology.data_layers().values())
    if itypes is None and obj is not None:
        # last resort: pull one real sample and infer each slot's type from
        # its value + the data layer's declared size
        try:
            with _in_dir(config_dir), _py2_shims():
                sample = _first_sample(obj, ds, config_dir)
        except Exception as e:
            hook_error = hook_error or e
            sample = None
        if sample is not None and not isinstance(sample, (list, tuple)):
            sample = (sample,)
        if sample is not None and len(sample) == len(data_confs):
            # infer each value against each layer's size and take the
            # unique dim-consistent assignment (positional when it checks;
            # robust to provider-yield vs feeding-order divergence)
            cand = [
                [_infer_slot_type(v, c.size) for c in data_confs]
                for v in sample
            ]
            n = len(data_confs)
            positional = [cand[i][i] for i in range(n)]
            if all(t is not None for t in positional):
                aligned = positional
            else:
                res = _unique_assignment(cand, n)
                if res is None:
                    aligned = None
                else:
                    aligned, assign = res
                    if any(i != j for i, j in enumerate(assign)):
                        # permuted binding: feed tuples through the map
                        parsed.feeding = {
                            data_confs[j].name: i
                            for i, j in enumerate(assign)
                        }
            if aligned is not None:
                itypes, names = aligned, [c.name for c in data_confs]
    if itypes is None:
        _mark_unresolved(
            parsed,
            ds,
            f"init_hook/introspection failed: {hook_error!r}"
            if hook_error
            else "provider declares no input_types",
        )
        return
    label = f"{ds.module}.{ds.obj}"
    if names:
        by_name = dict(zip(names, itypes))
        aligned = [by_name.get(c.name) for c in data_confs]
        bad = [
            (c.name, c.size, t)
            for c, t in zip(data_confs, aligned)
            if t is not None and not _slot_compatible(t, c)
        ]
        if bad:
            raise ValueError(
                f"{label}: named slot types do not dim-check against their "
                f"data layers: {bad}"
            )
        # Sample tuples arrive in the provider's slot-NAME order; when that
        # differs from feeding order the tuples must be re-paired by name.
        name_pos = {nm: i for i, nm in enumerate(names)}
        if any(
            name_pos.get(c.name, j) != j for j, c in enumerate(data_confs)
        ):
            parsed.feeding = {
                c.name: name_pos[c.name]
                for c in data_confs
                if c.name in name_pos
            }
    else:
        # Positional provider types pair with data layers in FEEDING order
        # (Inputs()/DFS — see Topology.data_layers), validated against each
        # layer's declared size; mismatch → unique re-assignment or error.
        aligned, feeding = _bind_slots(list(itypes), data_confs, label)
        if feeding is not None:
            parsed.feeding = feeding
    resolved = {}
    for conf, t in zip(data_confs, aligned):
        if t is not None and conf.attrs.get("_v1_size_only"):
            # LayerConf is frozen; parse-time resolution happens before any
            # compilation, so this is the one sanctioned mutation point.
            object.__setattr__(conf, "input_type", t)
            conf.attrs.pop("_v1_size_only", None)
            resolved[conf.name] = t
    parsed.provider_input_types = resolved


def _mark_unresolved(parsed: ParsedConfig, ds, reason: str) -> None:
    """Provider types could not be resolved: leave the parse-time dense
    placeholders in place (building/inspecting the topology stays fine) but
    tag the slots so data_types()/feeding raises a hard error instead of
    silently feeding index/sequence slots as dense vectors."""
    for c in parsed.topology.data_layers().values():
        if c.attrs.get("_v1_size_only"):
            c.attrs["_v1_unresolved"] = (
                f"slot types unknown: provider {ds.module}.{ds.obj} — {reason}"
            )


import contextlib

# os.chdir is process-global.  This lock serializes the PARSE-TIME chdirs
# in this module against each other (concurrent parse_config calls); it
# cannot protect arbitrary other threads that read the cwd (e.g. a
# background feeder resolving relative paths mid-parse) — those windows are
# only narrowed by keeping each chdir scope as short as possible.  Provider
# code that must be robust should open paths relative to its own __file__.
# a plain re-entrant lock: the JAX package's instrumented lock factory
# belongs to its lock-sanitizer tooling, which the port has not taken over yet
_chdir_lock = threading.RLock()


@contextlib.contextmanager
def _in_dir(d: str):
    with _chdir_lock:
        cwd = os.getcwd()
        os.chdir(d)
        try:
            yield
        finally:
            os.chdir(cwd)


@contextlib.contextmanager
def _py2_shims():
    """Module-level py2 attributes the reference-era configs/providers touch
    (sys.maxint in init hooks, string.letters in tokenizers), installed only
    for the duration of a config exec / provider import."""
    import string

    added = []
    if not hasattr(sys, "maxint"):
        sys.maxint = sys.maxsize
        added.append((sys, "maxint"))
    if not hasattr(string, "letters"):
        string.letters = string.ascii_letters
        added.append((string, "letters"))
    try:
        yield
    finally:
        for mod, attr in added:
            delattr(mod, attr)


def parse_config(config, config_arg_str: str = "") -> ParsedConfig:
    """Execute a v1 trainer-config python file — or CALL a config function
    (the reference parse_config accepts both, config_parser.py:3669) — and
    return the build result (reference returns the proto; here the typed
    Topology + settings)."""
    _install_import_shims()
    from paddle_tpu_torch.core.topology import reset_auto_names

    reset_auto_names()
    is_callable = callable(config)
    config_file = None if is_callable else config
    config_dir = (
        os.getcwd()
        if is_callable
        else os.path.dirname(os.path.abspath(config_file)) or "."
    )
    from paddle_tpu_torch.core.topology import set_layer_sink

    state = _helpers._ParseState(_parse_config_args(config_arg_str))
    prev_state = _helpers._state
    _helpers._state = state
    prev_sink = set_layer_sink(
        lambda lo: state.all_layers.__setitem__(lo.conf.name, lo)
    )
    sys.path.insert(0, config_dir)
    try:
        with _py2_shims():
            if is_callable:
                config()
            else:
                with open(config_file) as f:
                    src = f.read()
                # Pre-populate the namespace with the full helper surface —
                # the reference execs configs inside config_parser's own
                # namespace, so old-face .conf files use Layer/TrainData/
                # Settings/default_* WITHOUT any import.
                ns = {
                    k: v
                    for k, v in vars(_helpers).items()
                    if not k.startswith("_")
                }
                ns.update({
                    "__file__": os.path.abspath(config_file),
                    "__name__": "__paddle_config__",
                    # py2-era configs: reference v1 configs predate python 3
                    "xrange": range,
                    "unicode": str,
                })
                exec(compile(src, config_file, "exec"), ns)
    finally:
        sys.path.pop(0)
        _helpers._state = prev_state
        # a config that died inside RecurrentLayerGroupBegin/End must not
        # leave the raw-group trace open for the next parse.  Unwind it
        # BEFORE restoring the sink: the trace context's own exit restores
        # the sink that was active when the group opened (this parse's),
        # which would clobber the restoration below if ordered after it.
        from paddle_tpu_torch.v1_compat.raw_face import reset_raw_state

        reset_raw_state()
        set_layer_sink(prev_sink)

    label = config_file or getattr(config, "__name__", "<callable config>")
    if state.submodel_stack:
        raise ValueError(f"{label}: SubModelBegin without matching SubModelEnd")
    if state.model_type_name == "multi_nn" and state.submodels:
        _assemble_multi_nn(state, label)
    if state.pending_output_names:  # capital-O Outputs(name, ...) form
        # reference alias: the beam-search generator registers its predict
        # layer as __beam_search_predict__ (config_parser) — map it to the
        # beam_search layer built during the exec, or to the OUTER
        # recurrent_group wrapping it (nested generation: the reference
        # concatenates per-subsequence beam results through the group,
        # sample_trainer_nest_rnn_gen.conf)
        if "__beam_search_predict__" in state.pending_output_names:
            gen_groups = [
                lo for lo in state.all_layers.values()
                if lo.conf.type == "recurrent_group"
                and any(
                    c.type == "beam_search"
                    for c in lo.conf.attrs["_sub_topology"].layers.values()
                )
            ]
            beams = [
                lo for lo in state.all_layers.values()
                if lo.conf.type == "beam_search"
            ]
            if len(gen_groups) == 1:
                state.all_layers["__beam_search_predict__"] = gen_groups[0]
            elif len(beams) == 1:
                state.all_layers["__beam_search_predict__"] = beams[0]
        missing = [n for n in state.pending_output_names if n not in state.all_layers]
        if missing:
            raise KeyError(
                f"{label}: Outputs() names {missing} were never built"
            )
        state.outputs.extend(
            state.all_layers[n] for n in state.pending_output_names
        )
    assert state.outputs, f"{label}: config declared no outputs()"
    topo = Topology(list(state.outputs))
    # Explicit Inputs(...) / inputs(...) pins the feeding order (reference
    # config_parser.py:205-222: "The data streams from DataProvider must
    # have the same order").  Without it data_layers() uses DFS order, the
    # same order the reference's outputs() computes via __dfs_travel__.
    explicit_inputs = (
        [l.name for l in state.inputs] if state.inputs else list(state.input_names)
    )
    if explicit_inputs and all(
        n in topo.layers and topo.layers[n].type == "data" for n in explicit_inputs
    ):
        # pin only a COMPLETE ordering: a partial Inputs() list must not
        # shrink the feed contract (data_layers() returns input_order
        # verbatim — a missing slot would silently vanish from feeding)
        all_data = {
            n for n, c in topo.layers.items() if c.type == "data"
        }
        if set(explicit_inputs) == all_data:
            topo.input_order = tuple(explicit_inputs)
        else:
            warnings.warn(
                f"{label}: Inputs({explicit_inputs}) does not cover every "
                f"data layer ({sorted(all_data)}); falling back to DFS "
                "feeding order",
                stacklevel=2,
            )
    parsed = ParsedConfig(
        topology=topo,
        settings=state.settings,
        data_sources=state.data_sources,
        train_data=state.train_data,
        test_data=state.test_data,
        input_layers=(
            [l.name for l in state.inputs]
            if state.inputs
            else list(state.input_names)  # capital-I Inputs(name, ...) form
        ),
        output_layers=[l.name for l in state.outputs],
        evaluators=list(state.evaluators),
        source_file=config_file,
        all_layer_names=list(state.all_layers),
    )
    _resolve_provider_types(parsed, config_dir)
    return parsed


def _assemble_multi_nn(state, label: str) -> None:
    """model_type('multi_nn') ensembles (reference MultiNetwork.cpp,
    ModelConfig.proto:579): each SubModelBegin/End block declared its own
    Inputs/Outputs; the whole ensemble compiles into one network whose
    training objective is the summed sub-network cost (multi_nn_cost
    layer — the reference sums all of MultiNetwork::forward's concatenated
    outArgs).  Feeding order = the sub-models' Inputs() concatenated in
    declaration order (the reference splits inArgs by dataId per
    sub-network, MultiNetwork.cpp:70)."""
    from paddle_tpu_torch.core.topology import LayerConf as _LC, LayerOutput as _LO

    sub_outs: List[LayerOutput] = []
    for sm in state.submodels:
        if not sm["outputs"]:
            raise ValueError(
                f"{label}: multi_nn submodel {sm['name']!r} declares no Outputs"
            )
        for n in sm["outputs"]:
            if n not in state.all_layers:
                raise KeyError(
                    f"{label}: submodel {sm['name']!r} output {n!r} was "
                    "never built"
                )
            sub_outs.append(state.all_layers[n])
    joint = _LO(
        _LC(
            name="__multi_nn_cost__",
            type="multi_nn_cost",
            size=1,
            inputs=tuple(o.name for o in sub_outs),
            bias=False,
        ),
        sub_outs,
    )
    state.outputs = [joint] + sub_outs
    state.pending_output_names = []
    if not state.input_names:
        state.input_names = [n for sm in state.submodels for n in sm["inputs"]]


def make_optimizer(settings: TrainerSettings):
    """Map settings() onto a paddle_tpu optimizer instance (the v2
    update_equation)."""
    import paddle_tpu_torch.optimizer as O

    method = settings.learning_method
    kind = getattr(method, "kind", "sgd") if method is not None else "sgd"
    reg = settings.regularization
    if reg is not None:
        reg = (
            O.L1Regularization(reg.rate)
            if isinstance(reg, _helpers.L1Regularization)
            else O.L2Regularization(reg.rate)
        )
    avg = settings.model_average
    if avg is not None:
        avg = O.ModelAverage(average_window=avg.average_window)
    common = dict(
        learning_rate=settings.learning_rate,
        learning_rate_schedule=settings.learning_rate_schedule,
        learning_rate_decay_a=settings.learning_rate_decay_a,
        learning_rate_decay_b=settings.learning_rate_decay_b,
        learning_rate_args=getattr(settings, "learning_rate_args", ""),
        regularization=reg,
        gradient_clipping_threshold=settings.gradient_clipping_threshold or 0.0,
        model_average=avg,
        # 'manual' boundaries are numSamplesProcessed in the reference;
        # the step counter converts through the config's batch size
        samples_per_step=float(settings.batch_size or 1),
    )
    extra = dict(getattr(method, "extra", {}))
    cls = {
        "sgd": O.Momentum,
        "momentum": O.Momentum,
        "adam": O.Adam,
        "adamax": O.AdaMax,
        "adagrad": O.AdaGrad,
        "decayed_adagrad": O.DecayedAdaGrad,
        "adadelta": O.AdaDelta,
        "rmsprop": O.RMSProp,
    }[kind]
    if cls is O.Momentum and "momentum" not in extra and kind == "sgd":
        extra["momentum"] = 0.0
    if cls is O.Adam:
        extra = {
            "beta1": extra.get("beta1", 0.9),
            "beta2": extra.get("beta2", 0.999),
            "epsilon": extra.get("epsilon", 1e-8),
        }
    return cls(**extra, **common)
