"""Checkpoints — the counterpart of ``paddle_tpu/checkpoint.py``, in two of its
three planes (the v2 tar is ``Parameters.to_tar``/``from_tar``):

1. **v1 parameter dirs** — one binary file per parameter (int32 version 0,
   uint32 value size 4, uint64 element count, then the raw float32
   values), the reference trainer's per-pass dumps (Parameter.cpp
   save/load, trainer/ParamUtil.cpp).
3. **Full training-state checkpoints** — params, layer state, optimizer
   state and counters in one step directory, ``ckpt-%08d/state.npz`` with
   a ``meta.json`` that holds its CRC32, committed by an atomic rename,
   optionally written by a background thread, with retention.

A step's leaves carry the names ``jax.tree_util.keystr`` gives the JAX
package's nested dicts (``['params']['fc0']['w0']``), 0-d counters are
0-d arrays (``opt_state['step']`` int32), so a step written by either
package restores in the other.

Not ported yet: the sharded multi-writer plane (``save_shard``/``commit``,
the elastic workers' checkpoints).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "save_parameter_dir",
    "load_parameter_dir",
    "CheckpointManager",
]

_V1_VERSION = 0
_V1_VALUE_SIZE = 4  # float32

_log = logging.getLogger("paddle_tpu_torch.checkpoint")


# ---------------------------------------------------------------------------
# Plane 1: v1 per-parameter binary files
# ---------------------------------------------------------------------------


def save_parameter_dir(parameters, dirname: str) -> None:
    """One file per parameter, named by its dotted name, v1 header layout."""
    os.makedirs(dirname, exist_ok=True)
    for name in parameters.names():
        arr = np.asarray(parameters.get(name), dtype=np.float32)
        with open(os.path.join(dirname, name.replace("/", "__")), "wb") as f:
            f.write(struct.pack("<iIQ", _V1_VERSION, _V1_VALUE_SIZE, arr.size))
            f.write(arr.tobytes())


def load_parameter_dir(parameters, dirname: str) -> None:
    for name in parameters.names():
        path = os.path.join(dirname, name.replace("/", "__"))
        with open(path, "rb") as f:
            version, value_size, count = struct.unpack("<iIQ", f.read(16))
            if version != _V1_VERSION or value_size != _V1_VALUE_SIZE:
                raise ValueError(
                    f"{path}: unsupported header version={version} "
                    f"value_size={value_size}"
                )
            data = np.frombuffer(f.read(count * value_size), dtype=np.float32)
        cur = parameters.get(name)
        if data.size != cur.size:
            raise ValueError(
                f"{path}: size {data.size} != parameter {name} size {cur.size}"
            )
        parameters.set(name, data.reshape(cur.shape))


# ---------------------------------------------------------------------------
# Plane 3: full-state checkpoints
# ---------------------------------------------------------------------------


def _crc_file(path: str, block: int = 1 << 20) -> int:
    """Streaming CRC32 (constant memory for multi-GB checkpoints)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(block)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host array that owns its memory: a tensor is copied (the
    in-place optimizer must not change an array an async write still
    reads), a Python int is a 0-d int32 and a float a 0-d float32, as the
    JAX package's counters are."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float)):
        return np.array(leaf)
    return np.asarray(leaf, np.int32 if isinstance(leaf, int) else np.float32)


def _leaves(tree, path=""):
    """(keystr path, leaf) over nested dicts, in sorted key order (the JAX
    package's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _host_array(leaf) for path, leaf in _leaves(tree)}


def _unflatten_into(template, arrays: Dict[str, np.ndarray], path=""):
    """`template`'s structure with each leaf read from `arrays`: a tensor
    leaf becomes a tensor of its dtype on its device, an int or a float leaf
    a Python number.  Keys the template lacks are ignored."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, arrays, f"{path}[{k!r}]") for k, v in template.items()}
    if path not in arrays:
        raise KeyError(f"checkpoint missing leaf {path}")
    arr = arrays[path]
    want = tuple(template.shape) if torch.is_tensor(template) else np.shape(template)
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"leaf {path}: checkpoint shape {arr.shape} != template {want}")
    if torch.is_tensor(template):
        return torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
    if isinstance(template, (int, float)) and not isinstance(template, bool):
        return type(template)(arr)
    return arr.astype(np.asarray(template).dtype)


class CheckpointManager:
    """Step-indexed checkpoints under ``directory/ckpt-%08d/`` with atomic
    rename, CRC verification, retention of the newest ``max_to_keep`` and
    optional asynchronous writes (single writer)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None

    # -- write ----------------------------------------------------------
    def save(
        self,
        step: int,
        tree: Any,
        extra: Optional[Dict[str, Any]] = None,
        async_: bool = False,
    ) -> None:
        # copied to the host before the hand-off, so training may update the
        # tensors in place at once
        arrays = _flatten(tree)
        self.wait()  # one write at a time
        if async_:

            def run():
                try:
                    self._write(step, arrays, extra)
                except BaseException as exc:  # re-raised by the next wait()
                    self._pending_error = exc

            # not a daemon: interpreter exit joins it, so a checkpoint
            # started at the end of a script is never cut short
            t = threading.Thread(target=run, name="paddle-ckpt-write", daemon=False)
            t.start()
            self._pending = t
        else:
            self._write(step, arrays, extra)

    def _write(self, step: int, arrays: Dict[str, np.ndarray], extra) -> None:
        final = os.path.join(self.directory, f"ckpt-{step:08d}")
        tmp = tempfile.mkdtemp(prefix=".tmp-ckpt-", dir=self.directory)
        try:
            data_path = os.path.join(tmp, "state.npz")
            np.savez(data_path, **arrays)
            meta = {
                "step": step,
                "crc32": _crc_file(data_path),
                "timestamp": time.time(),
                "n_leaves": len(arrays),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()

    def _retain(self) -> None:
        """Keep the newest ``max_to_keep`` committed steps; delete only steps
        older than the oldest kept one (a torn newest step never pushes the
        last restorable one out)."""
        committed = [s for s in self.all_steps() if self._is_committed(s)]
        if len(committed) <= self.max_to_keep:
            return
        keep_from = committed[-self.max_to_keep]
        for s in self.all_steps():
            if s < keep_from:
                shutil.rmtree(os.path.join(self.directory, f"ckpt-{s:08d}"), ignore_errors=True)

    def _is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.directory, f"ckpt-{step:08d}", "meta.json"))

    def wait(self) -> None:
        """Join an in-flight asynchronous write; re-raises its failure."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            exc, self._pending_error = self._pending_error, None
            raise exc

    # -- read -----------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.directory, f"ckpt-{step:08d}", "meta.json")
        if not os.path.exists(path):
            raise IOError(f"checkpoint {os.path.dirname(path)}: no meta.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, template: Any):
        """Verify the CRC, then rebuild `template`'s structure from the step.
        Returns (tree, extra)."""
        d = os.path.join(self.directory, f"ckpt-{step:08d}")
        meta = self.meta(step)
        data_path = os.path.join(d, "state.npz")
        if _crc_file(data_path) != meta["crc32"]:
            raise IOError(f"checkpoint {d} corrupt: crc mismatch vs meta {meta['crc32']:#x}")
        with np.load(data_path) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten_into(template, arrays), meta.get("extra", {})

    def restore_latest(self, template: Any):
        """The newest restorable step as ``(step, tree, extra)``, or None.
        Walks from the newest back past a torn or corrupt step (a truncated
        ``state.npz``, a CRC mismatch, a missing ``meta.json``)."""
        for step in reversed(self.all_steps()):
            try:
                tree, extra = self.restore(step, template)
            except Exception as exc:  # noqa: BLE001 — any torn artifact
                _log.warning(
                    "checkpoint ckpt-%08d unusable (%s: %s); falling back to the "
                    "previous retained checkpoint", step, type(exc).__name__, exc)
                continue
            return step, tree, extra
        return None
