"""Parameters — the counterpart of ``paddle_tpu/parameters.py``: the parameter
tree and the non-trainable layer state (batch norm's moving statistics),
:func:`create` from a network and a seed, dotted-name access with the
network's global table of shared names, the reference's v1 tar, and
:func:`from_numpy`, which carries the JAX package's parameters and state
(``{layer: {key: ndarray}}`` trees) into the port so both compute the same
function (its network-less trees are adopted by ``trainer.SGD``).

The tar layout is the reference's, so a tar written by either package (or
the reference) loads in the other: one member per parameter whose payload
is the v1 binary header (int32 version 0, uint32 value size 4, uint64
element count) followed by the raw float32 values, and beside it a
``<name>.protobuf`` ParameterConfig member with its name, size and dims
(reference Parameter.cpp save/load, python/paddle/v2/parameters.py
to_tar/from_tar).  The tar holds the parameters, not the layer state.
"""

from __future__ import annotations

import io
import struct
import tarfile
import warnings
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.compiler import CompiledNetwork, NetState, Params
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.utils.tree import dotted, get_path, leaf_paths, map_leaves


class Parameters:
    """The parameter tree ``{layer: {key: tensor}}`` of a network (a
    recurrent group's entry nests one level deeper: ``{group: {inner layer:
    {key: tensor}}}``) and its layer state, a tree of the same form."""

    def __init__(self, network: Optional[CompiledNetwork], params: Params,
                 state: Optional[NetState] = None):
        self.network = network
        self.params = params
        self.state = state if state is not None else {}

    def names(self):
        """Dotted parameter names, "<layer>.<key>", and
        "<group>.<inner layer>.<key>" inside a recurrent group (the JAX
        package's form)."""
        return [dotted(path) for path, _ in leaf_paths(self.params)]

    def keys(self):
        return self.names()

    def _resolve(self, key: str):
        """(dict, leaf key) holding the parameter `key`: a dotted path, or a
        declared name of the network's global parameter table."""
        parts = key.split(".")
        node = self.params
        for part in parts[:-1]:
            node = node.get(part) if isinstance(node, dict) else None
        if isinstance(node, dict) and not isinstance(node.get(parts[-1], {}), dict):
            return node, parts[-1]
        table = self.network.named_parameters() if self.network is not None else {}
        if key not in table:
            raise KeyError(key)
        *up, leaf = table[key].split(".")
        node = get_path(self.params, up)
        # a whole-layer name addresses the layer's dict: descend to its one leaf
        while isinstance(node[leaf], dict):
            inner = node[leaf]
            if len(inner) != 1:
                raise KeyError(
                    f"named parameter {key!r} maps to a multi-key param dict "
                    f"({sorted(inner)}); address a leaf as {table[key]}.<key>")
            node, leaf = inner, next(iter(inner))
        return node, leaf

    def get(self, key: str) -> np.ndarray:
        """A float32 copy of the parameter (not a view of a CPU tensor, which
        the in-place optimizer would change under the caller)."""
        node, leaf = self._resolve(key)
        t = node[leaf].detach().float()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    __getitem__ = get

    def set(self, key: str, value) -> None:
        """Replace the parameter's tensor with `value`, in its dtype, shape
        and device."""
        node, leaf = self._resolve(key)
        old = node[leaf]
        node[leaf] = torch.from_numpy(np.array(value)).to(
            device=old.device, dtype=old.dtype).reshape(old.shape)

    __setitem__ = set

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self.names())

    # -- tar checkpoints ------------------------------------------------
    def to_tar(self, f) -> None:
        """The reference v2 tar: per parameter a data member (v1 binary
        header + raw float32) and a ``<name>.protobuf`` ParameterConfig
        member."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self.names():
                _write_tar_member(tar, name, self.get(name))

    def init_from_tar(self, f) -> None:
        """Merge a parameter tar into this instance, ignoring names its
        topology lacks (reference Parameters.init_from_tar)."""
        known = set(self.names())
        for name, arr in _read_tar_members(f):
            if name in known:
                self.set(name, arr)

    class _FromTar:
        """``Parameters.from_tar(f)`` on the class is the reference's static
        constructor and returns a topology-free :class:`DetachedParameters`;
        on an instance it merges into the existing parameters
        (:meth:`init_from_tar`)."""

        def __get__(self, obj, objtype=None):
            if obj is None:
                return DetachedParameters.from_tar
            return obj.init_from_tar

    from_tar = _FromTar()

    @staticmethod
    def from_tar_new(network: CompiledNetwork, f, device=None) -> "Parameters":
        p = create_from_network(network, seed=0, device=device)
        p.init_from_tar(f)
        return p


def _write_tar_member(tar, name: str, arr: np.ndarray) -> None:
    """One parameter as the reference's pair of members: v1 binary data and
    its ParameterConfig shape record."""
    arr = np.asarray(arr, np.float32)
    payload = struct.pack("<iIQ", 0, 4, arr.size) + arr.tobytes()
    info = tarfile.TarInfo(name=name)
    info.size = len(payload)
    tar.addfile(info, io.BytesIO(payload))
    conf = _encode_param_conf(name, arr.shape)
    cinfo = tarfile.TarInfo(name=f"{name}.protobuf")
    cinfo.size = len(conf)
    tar.addfile(cinfo, io.BytesIO(conf))


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _encode_param_conf(name: str, shape) -> bytes:
    """Minimal proto2 ParameterConfig wire bytes: name (field 1, string),
    size (field 2, uint64), dims (field 9, repeated uint64)."""
    nb = name.encode("utf-8")
    out = b"\x0a" + _varint(len(nb)) + nb  # field 1, wire type 2
    size = 1
    for d in shape:
        size *= int(d)
    out += b"\x10" + _varint(size)  # field 2, wire type 0
    for d in shape:
        out += b"\x48" + _varint(int(d))  # field 9, wire type 0
    return out


def _parse_param_conf(buf: bytes, member: str = "?"):
    """(name, dims) of a ParameterConfig record, skipping the fields a
    reference-written tar may add."""
    name, dims = None, []
    i, n = 0, len(buf)

    def read_varint(i):
        v, shift = 0, 0
        while True:
            if i >= n:
                raise ValueError(
                    f"corrupt ParameterConfig member {member!r}: varint "
                    f"runs past the end of the {n}-byte record"
                )
            b = buf[i]
            v |= (b & 0x7F) << shift
            i += 1
            if not b & 0x80:
                return v, i
            shift += 7

    while i < n:
        tag, i = read_varint(i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = read_varint(i)
            if field == 9:
                dims.append(v)
        elif wire == 1:
            i += 8
        elif wire == 2:
            ln, i = read_varint(i)
            if field == 1:
                name = buf[i : i + ln].decode("utf-8")
            i += ln
        elif wire == 5:
            i += 4
        else:
            # groups (3/4) and 6/7 appear in no ParameterConfig; a partial
            # parse would load the array flat, so fail loudly
            raise ValueError(
                f"corrupt ParameterConfig member {member!r}: unknown proto "
                f"wire type {wire} (field {field}) at byte {i}"
            )
    return name, dims


def _read_tar_members(f):
    """(name, float32 array) for each data member of a reference-format
    parameter tar, shaped by its ``<name>.protobuf`` member where present."""
    with tarfile.open(fileobj=f, mode="r") as tar:
        members = tar.getmembers()
        dims = {}
        for member in members:
            if member.name.endswith(".protobuf"):
                nm, dd = _parse_param_conf(tar.extractfile(member).read(), member.name)
                dims[nm if nm else member.name[: -len(".protobuf")]] = dd
        for member in members:
            if member.name.endswith(".protobuf"):
                continue
            buf = tar.extractfile(member).read()
            version, value_size, size = struct.unpack("<iIQ", buf[:16])
            if value_size != 4:
                raise ValueError(
                    f"tar member {member.name!r}: value size {value_size}; only "
                    "float32 parameters are supported")
            arr = np.frombuffer(buf[16 : 16 + 4 * size], dtype=np.float32)
            dd = dims.get(member.name)
            if dd and int(np.prod(dd)) == arr.size:
                arr = arr.reshape([int(d) for d in dd])
            yield member.name, arr


class DetachedParameters:
    """Topology-free parameter bag — what the reference's static
    ``Parameters.from_tar(f)`` returns: names and float32 values with no
    network.  SGD, Inference and infer accept it: they build parameters for
    their own topology and merge these values in by name."""

    def __init__(self, values: Dict[str, np.ndarray]):
        self._values = dict(values)

    @staticmethod
    def from_tar(f) -> "DetachedParameters":
        if isinstance(f, Parameters) or not hasattr(f, "read"):
            raise TypeError(
                "Parameters.from_tar on the class is the static constructor "
                "taking a single binary file object (got "
                f"{type(f).__name__}); to merge a tar into an existing "
                "Parameters call params.from_tar(f) / params.init_from_tar(f)"
            )
        return DetachedParameters(dict(_read_tar_members(f)))

    def names(self):
        return list(self._values)

    keys = names

    def get(self, key: str) -> np.ndarray:
        return self._values[key]

    __getitem__ = get

    def set(self, key: str, value) -> None:
        self._values[key] = np.asarray(value)

    __setitem__ = set

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def to_tar(self, f) -> None:
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name, arr in self._values.items():
                _write_tar_member(tar, name, arr)

    def merge_into(self, parameters: Parameters) -> Parameters:
        """Copy every name the target topology knows into `parameters`;
        warns when nothing, or not everything, matches (the model would run
        on its random initialization there)."""
        known = set(parameters.names())
        hit = [n for n in self._values if n in known]
        if self._values and not hit:
            warnings.warn(
                "parameter tar matched no parameter names of the target "
                f"topology (tar has {sorted(self._values)[:5]}..., topology "
                f"has {sorted(known)[:5]}...); the model keeps its random "
                "initialization",
                stacklevel=2,
            )
        elif (uncovered := sorted(known - set(self._values))):
            warnings.warn(
                f"parameter tar covers {len(hit)} of {len(known)} topology "
                f"parameters; {uncovered[:8]} keep their random "
                "initialization (use init_from_tar directly for intentional "
                "partial loads)",
                stacklevel=2,
            )
        for name in hit:
            parameters.set(name, self._values[name])
        return parameters


def create(cost_or_topology, seed: int = 0, dtype=None, device=None) -> Parameters:
    """paddle.parameters.create(cost) equivalent, on `device` (the card
    unless the caller asks for the CPU)."""
    topo = (
        cost_or_topology
        if isinstance(cost_or_topology, Topology)
        else Topology(cost_or_topology)
    )
    network = CompiledNetwork(topo, dtype=dtype) if dtype else CompiledNetwork(topo)
    return create_from_network(network, seed, device)


def create_from_network(network: CompiledNetwork, seed: int = 0, device=None) -> Parameters:
    return Parameters(network, *network.init(seed, resolve_device(device)))


def _tensor_tree(tree: Mapping[str, Any], dev) -> Dict[str, Any]:
    for path, v in leaf_paths(dict(tree)):
        if len(path) < 2:
            raise TypeError(f"{path[0]!r}: expected a {{key: array}} dict, got {type(v).__name__}")
    return map_leaves(lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev), dict(tree))


def from_numpy(tree: Mapping[str, Any], state_tree: Optional[Mapping[str, Any]] = None,
               device=None) -> Parameters:
    """Parameters from trees of numpy arrays (the JAX package's
    ``Parameters.params`` and ``Parameters.state`` passed through
    ``np.asarray``: ``{layer: {key: array}}``, and one level deeper inside a
    recurrent group), as float32 tensors on `device`.  Layouts are the JAX
    package's, which the port keeps (conv kernels HWIO)."""
    dev = resolve_device(device)
    return Parameters(None, _tensor_tree(tree, dev), _tensor_tree(state_tree or {}, dev))
