"""Model tooling — the ``python/paddle/utils`` surface; a copy of
``paddle_tpu/utils/model_tools.py`` over the port's Topology and v1 parser:

* :func:`make_diagram` — graphviz dot rendering of a Topology (reference
  make_model_diagram.py:40 walks the proto; here the typed LayerConf graph).
* :func:`merge_model` / :func:`load_merged_model` — bundle a topology +
  trained parameters into ONE deployable file (reference merge_model.py
  gzips proto + param blobs for the C inference API; here a tar of the
  serialized topology text, a JSON manifest, and the reference-format
  parameter tar so the file also interoperates with Parameters.from_tar).
* :func:`dump_config` — print the resolved topology of a v1 config file
  (reference dump_config.py, protobuf text dump).
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Optional

from paddle_tpu_torch.core.topology import Topology

__all__ = ["make_diagram", "merge_model", "load_merged_model", "dump_config"]


def _dot_escape(s: str) -> str:
    return s.replace('"', '\\"')


def make_diagram(topology: Topology, dot_file: Optional[str] = None) -> str:
    """Graphviz dot text for the layer graph; writes `dot_file` when given.
    Data layers are boxes, costs are double octagons, everything else an
    ellipse — the reference's visual convention."""
    lines = ["digraph model {", "  rankdir=TB;"]
    for name in topology.order:
        c = topology.layers[name]
        if c.type == "data":
            shape = "box"
        elif "cost" in c.type or c.type in ("cross_entropy", "crf", "multibox_loss"):
            shape = "doubleoctagon"
        else:
            shape = "ellipse"
        label = f"{name}\\n{c.type} [{c.size}]"
        lines.append(
            f'  "{_dot_escape(name)}" [shape={shape}, label="{_dot_escape(label)}"];'
        )
    for name in topology.order:
        for parent in topology.layers[name].inputs:
            lines.append(f'  "{_dot_escape(parent)}" -> "{_dot_escape(name)}";')
    lines.append("}")
    dot = "\n".join(lines)
    if dot_file:
        with open(dot_file, "w") as f:
            f.write(dot)
    return dot


def merge_model(parameters, path: str) -> None:
    """One-file deployment bundle: topology text + manifest + the
    reference-format parameter tar (reference merge_model.py gzips
    proto+params for paddle_capi)."""
    topo_text = parameters.network.topology.serialize()
    manifest = {
        "format": "paddle-tpu-merged-model",
        "version": 1,
        "outputs": list(parameters.network.topology.output_names),
        "params": sorted(parameters.names()),
    }
    buf = io.BytesIO()
    parameters.to_tar(buf)

    def add(tar, name, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    with tarfile.open(path, "w:gz") as tar:
        add(tar, "manifest.json", json.dumps(manifest, indent=1).encode())
        add(tar, "topology.txt", topo_text.encode())
        add(tar, "parameters.tar", buf.getvalue())


def load_merged_model(path: str, parameters) -> dict:
    """Load a merged bundle's parameters into `parameters` (whose topology
    must serialize identically) and return the manifest."""
    with tarfile.open(path, "r:gz") as tar:
        manifest = json.load(tar.extractfile("manifest.json"))
        topo_text = tar.extractfile("topology.txt").read().decode()
        want = parameters.network.topology.serialize()
        if topo_text != want:
            raise ValueError(
                "merged model topology does not match the target parameters' "
                "network (build the same model before loading)"
            )
        parameters.from_tar(io.BytesIO(tar.extractfile("parameters.tar").read()))
    return manifest


def dump_config(config_file: str, config_arg_str: str = "") -> str:
    """Resolved-topology text of a v1 config file (reference
    dump_config.py prints the TrainerConfig proto)."""
    from paddle_tpu_torch.v1_compat import parse_config

    return parse_config(config_file, config_arg_str).serialize()
