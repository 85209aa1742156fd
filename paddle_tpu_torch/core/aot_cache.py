"""Persistent build cache: a warm boot loads the port's native libraries
from a store and runs no compiler.

The counterpart of ``paddle_tpu/core/aot_cache.py``.  The JAX package
serializes every jitted step variant (``jit(...).lower(...).compile()`` +
``jax.experimental.serialize_executable``) so that a later boot
deserializes instead of retracing.  The port runs eagerly and compiles
nothing per shape (``core/compiler.py`` ``CompileShapeCache``); what a port
process does compile at boot are its native libraries: the flash-attention
kernels (``nvcc`` for ``sm_90a``, ``ops/flash_attention.py``), the recordio
reader and the protodata decoder (``g++``, ``io/recordio.py``,
``io/protodata.py``).  This store holds those, under the JAX cache's key and
safety model:

* **Identity key** (hashed into the filename): ``kind: "native_library"``,
  the library's name, the sha256 of every source and header with its
  basename, and the compiler's flags (:func:`library_identity`).
* **Environment key** (stored in the entry header, compared in full on
  every load): torch's version and CUDA runtime, the machine and its libc,
  the package version and, for an nvcc library, the device's name and
  compute capability (:func:`device_key`).  It needs no compiler, because a
  warm machine may have none.  A mismatch is a **stale** entry: counted,
  warned once, rebuilt and overwritten.  An entry whose header names
  another identity (a foreign file renamed into place) is stale the same
  way: the full key is compared, never trusted from the filename.
* **Provenance** (header only, never compared): the compiler's version
  line, the build's seconds and when the entry was written.
* **Integrity**: the library's bytes carry a CRC32 and their length in the
  header; a damaged entry is **corrupt**: counted, warned once, rebuilt,
  overwritten.  Loads never raise.

A framed entry cannot be ``dlopen``\\ ed: a hit extracts the checked bytes
to ``lib/<entry hash>-<crc32>.so`` under the store (tmp + rename) and the
caller ``ctypes.CDLL``\\ s that.  ``dlopen`` dedups by path, so a rebuilt
library (other bytes, so another CRC) never reuses a path a process has
loaded, and an extracted file is never rewritten in place.  Every write
goes through tmp + rename, so processes can warm one store at once.

Counters ride the StatSet plane (``aot_cache/{hit,miss,stale,corrupt}``);
``compiles`` counts compiler runs and ``loads`` libraries loaded from the
store.  The JAX ``get_or_compile(jitted, args, ...)`` is
:meth:`AOTCache.get_or_build` here.  ``topology_fingerprint`` also seeds
the serving engine's prefix-cache keys.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import platform
import shutil
import struct
import subprocess
import tempfile
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# torch is imported where a key is computed, not here: the readers import
# this module, and the master process imports them without torch

_log = logging.getLogger("paddle_tpu_torch.aot_cache")

__all__ = [
    "AOTCache",
    "serialization_available",
    "optimizer_fingerprint",
    "topology_fingerprint",
    "mesh_fingerprint",
]

_MAGIC = b"PTAOT1\n"
_SUFFIX = ".aotx"
_LIB_DIR = "lib"  # extracted libraries, the paths that are dlopen'ed


def serialization_available() -> bool:
    """True where a built library can be stored and loaded back: every
    Linux host (the builds are ELF shared objects loaded with ctypes)."""
    return platform.system() == "Linux"


def topology_fingerprint(network) -> str:
    """Identity of a compiled network's graph: the serialized topology
    (types, sizes, attributes) plus the compute dtype it runs at, named as
    numpy names it ("float32"), so one topology gives the JAX package's
    fingerprint."""
    dtype = str(network.compute_dtype).replace("torch.", "")
    text = network.topology.serialize() + f"|compute={dtype}"
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def mesh_fingerprint(mesh) -> str:
    """"none" for no mesh, as in the JAX package; device meshes are not
    ported yet (ROADMAP Queue 1 item 6a)."""
    if mesh is None:
        return "none"
    raise NotImplementedError(
        "device meshes are not ported yet (ROADMAP Queue 1 item 6a); mesh_fingerprint "
        "takes None only")


def optimizer_fingerprint(opt) -> str:
    """Stable identity of an optimizer's constants: its primitive
    attributes (learning rate, slot hyperparameters, the schedule's counter
    unit), its regularization and model average, and its learning-rate
    schedule.  The port's optimizers keep the schedule as a closure
    (``optimizer.make_schedule``), so its function name and the values it
    closes over stand for the JAX package's ``_schedule_args``.  No library
    entry is keyed by it, since no entry holds a step program; the trainer
    keeps it in each rung's record (``SGD._aot_meta``)."""
    parts: Dict[str, Any] = {"class": type(opt).__name__}
    for k, v in sorted(vars(opt).items()):
        if isinstance(v, (int, float, str, bool, tuple, type(None))):
            parts[k] = v
        elif k in ("regularization", "model_average"):
            parts[k] = repr(v)
    schedule = getattr(opt, "schedule", None)
    if schedule is not None:
        parts["schedule"] = (
            schedule.__qualname__,
            tuple(repr(c.cell_contents) for c in schedule.__closure__ or ()),
        )
    return repr(sorted(parts.items()))


@functools.lru_cache(maxsize=1)
def _env_key() -> Dict[str, Any]:
    import torch

    import paddle_tpu_torch

    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "libc": "-".join(platform.libc_ver()),
        "paddle_tpu_torch": paddle_tpu_torch.__version__,
    }


def device_key() -> Dict[str, Any]:
    """The environment fields of a library built for the current CUDA
    device: its name and compute capability (read through the CUDA runtime, no
    compiler)."""
    import torch

    i = torch.cuda.current_device()
    return {
        "device_name": torch.cuda.get_device_name(i),
        "capability": list(torch.cuda.get_device_capability(i)),
    }


def library_identity(name: str, files: Sequence[str], argv: Sequence[str]) -> Dict[str, Any]:
    """Identity of a native library: its name, the sha256 of every source
    and header (basename, NUL, bytes, in the order given) and the compiler's
    flags.  Paths stay out, so copies of one tree share entries."""
    h = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return {"kind": "native_library", "name": name, "sources": h.hexdigest(),
            "argv": list(argv)}


def compiler_version(compiler: str) -> str:
    """The compiler's version line (provenance only): nvcc's "release"
    line, else the first line ``--version`` prints."""
    try:
        out = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    return next((line for line in lines if "release" in line), lines[0] if lines else "unknown")


def _tmp_suffix() -> str:
    return f".tmp.{os.getpid()}.{threading.get_ident()}"


def _key_hash(identity: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(identity, sort_keys=True).encode()
    ).hexdigest()[:24]


def _write_entry(path: str, header: Dict[str, Any], blob: bytes) -> None:
    """MAGIC | header_len:u32 | header json | crc32:u32 | blob, written
    tmp+rename so a concurrent reader never sees a torn entry (the JAX
    package's framing, byte for byte; the tmp name also carries the thread,
    so two writers of one process never share it)."""
    hdr = json.dumps(header, sort_keys=True).encode()
    tmp = path + _tmp_suffix()
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">I", len(hdr)))
        f.write(hdr)
        f.write(struct.pack(">I", zlib.crc32(blob) & 0xFFFFFFFF))
        f.write(blob)
    os.replace(tmp, path)


def _read_header(path: str) -> Tuple[Dict[str, Any], int, int]:
    """(header, blob offset, blob crc), framing-checked without reading the
    blob.  Raises ValueError on any damage, including truncation inside the
    fixed-size fields."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("bad magic")
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError("truncated header length")
        (hlen,) = struct.unpack(">I", raw)
        hraw = f.read(hlen)
        if len(hraw) != hlen:
            raise ValueError(f"truncated header: {len(hraw)} != {hlen} bytes")
        try:
            header = json.loads(hraw.decode())
        except Exception as e:
            raise ValueError(f"bad header: {e}")
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError("truncated CRC")
        (crc,) = struct.unpack(">I", raw)
    return header, len(_MAGIC) + 4 + hlen + 4, crc


def _read_entry(path: str) -> Tuple[Dict[str, Any], bytes]:
    """(header, blob); raises ValueError on any framing or CRC damage."""
    header, offset, crc = _read_header(path)
    with open(path, "rb") as f:
        f.seek(offset)
        blob = f.read()
    want = int(header.get("blob_bytes", -1))
    if want >= 0 and len(blob) != want:
        raise ValueError(f"truncated blob: {len(blob)} != {want} bytes")
    if zlib.crc32(blob) & 0xFFFFFFFF != crc:
        raise ValueError("blob CRC mismatch")
    return header, blob


def _remove(path: str) -> bool:
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
        return True
    except OSError:
        return False


class AOTCache:
    """On-disk store of built native libraries, keyed as above.

    ``get_or_build(identity, meta, build_fn)`` is the whole surface a
    loader needs: a valid entry is extracted and its path returned
    (**hit**); anything else runs ``build_fn(out_dir)``, which writes the
    library into the fresh directory ``out_dir`` and returns its path
    (**miss**; stale and corrupt entries also bump their own counter), and
    the bytes are stored for the next boot.

    ``identity`` names the library (hashed into the filename); ``meta``
    names what must also match (the device fields of an nvcc library); the
    host environment is merged in.  ``compiles`` and ``loads`` count what
    happened in this process: the warm-boot check (``compiles == 0`` on a
    filled store) reads them."""

    def __init__(self, cache_dir: str, stats=None):
        from paddle_tpu_torch.utils.timers import global_stats

        self.dir = os.path.abspath(cache_dir)
        os.makedirs(self.dir, exist_ok=True)
        self._stats = stats if stats is not None else global_stats
        self.compiles = 0  # compiler runs this process performed
        self.loads = 0  # libraries loaded from the store
        self._warned: set = set()

    # -- key plumbing ----------------------------------------------------
    def entry_path(self, identity: Dict[str, Any]) -> str:
        return os.path.join(self.dir, _key_hash(identity) + _SUFFIX)

    def full_key(self, identity: Dict[str, Any], meta: Optional[Dict] = None
                 ) -> Dict[str, Any]:
        return {**identity, **(meta or {}), **_env_key()}

    def _warn_once(self, category: str, msg: str, *args) -> None:
        if category not in self._warned:
            self._warned.add(category)
            _log.warning(msg + " (warning once; counters keep counting)", *args)

    def _extract(self, identity: Dict[str, Any], blob: bytes) -> str:
        """The library's loadable path, ``lib/<entry hash>-<crc32>.so``:
        reused when it already holds these bytes, else written tmp+rename
        (a new inode, so a process that mapped an older file keeps it)."""
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        libdir = os.path.join(self.dir, _LIB_DIR)
        os.makedirs(libdir, exist_ok=True)
        out = os.path.join(libdir, f"{_key_hash(identity)}-{crc:08x}.so")
        try:
            with open(out, "rb") as f:
                if zlib.crc32(f.read()) & 0xFFFFFFFF == crc:
                    return out
        except FileNotFoundError:
            pass
        tmp = out + _tmp_suffix()
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, out)
        return out

    # -- load / store ----------------------------------------------------
    def load(self, identity: Dict[str, Any], meta: Optional[Dict] = None) -> Optional[str]:
        """The extracted path of the stored library for this full key, or
        None (miss, stale or corrupt: counted; never raises, never returns
        a mismatched entry)."""
        path = self.entry_path(identity)
        if not os.path.exists(path):
            return None
        try:
            header, blob = _read_entry(path)
        except (OSError, ValueError) as e:
            self._stats.incr("aot_cache/corrupt")
            self._warn_once("corrupt", "aot cache entry %s is damaged (%s); rebuilding",
                            path, e)
            return None
        want = self.full_key(identity, meta)
        have = header.get("key", {})
        if have != want:
            diff = sorted(k for k in set(want) | set(have) if want.get(k) != have.get(k))
            self._stats.incr("aot_cache/stale")
            self._warn_once("stale", "aot cache entry %s is stale (mismatched fields: %s); "
                            "rebuilding", path, diff)
            return None
        try:
            lib = self._extract(identity, blob)
        except OSError as e:
            self._stats.incr("aot_cache/corrupt")
            self._warn_once("corrupt", "aot cache entry %s could not be extracted (%s); "
                            "rebuilding", path, e)
            return None
        self._stats.incr("aot_cache/hit")
        self.loads += 1
        return lib

    def store(self, identity: Dict[str, Any], blob: bytes, meta: Optional[Dict] = None,
              provenance: Optional[Dict] = None) -> Optional[str]:
        """Write one library's bytes as an entry and return its extracted
        path; None (warned once) when the store cannot be written."""
        header = {
            **(provenance or {}),
            "key": self.full_key(identity, meta),
            "created": time.time(),
            "blob_bytes": len(blob),
        }
        try:
            _write_entry(self.entry_path(identity), header, blob)
            return self._extract(identity, blob)
        except OSError as e:
            self._warn_once("unwritable", "aot cache dir %s unwritable (%s)", self.dir, e)
            return None

    def get_or_build(self, identity: Dict[str, Any], meta: Optional[Dict],
                     build_fn: Callable[[str], str],
                     compiler: Optional[Callable[[], str]] = None) -> str:
        """The path of a loadable library: the stored one when the full key
        matches, else ``build_fn(out_dir)`` (counted as a miss and a
        compile), stored for the next boot.  ``compiler`` names the
        compiler that ran, for the header's provenance.  A failed build
        raises."""
        lib = self.load(identity, meta)
        if lib is not None:
            return lib
        self._stats.incr("aot_cache/miss")
        work = tempfile.mkdtemp(prefix=f"build.tmp.{os.getpid()}.", dir=self.dir)
        t0 = time.perf_counter()
        try:
            built = build_fn(work)
        except BaseException:
            shutil.rmtree(work, ignore_errors=True)
            raise
        build_s = time.perf_counter() - t0
        self.compiles += 1
        with open(built, "rb") as f:
            blob = f.read()
        lib = self.store(identity, blob, meta, {
            "compiler": compiler_version(compiler()) if compiler else None,
            "build_s": build_s,
        })
        if lib is None:
            return built  # the store is unwritable: load the fresh build in place
        shutil.rmtree(work, ignore_errors=True)
        return lib

    # -- maintenance (the `cache` subcommand) ----------------------------
    def entries(self) -> List[Dict[str, Any]]:
        """Per-entry metadata for ``cache ls``: size, age, the full key and
        provenance from the header (damaged headers list as corrupt).
        Header-only reads."""
        out: List[Dict[str, Any]] = []
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.dir, name)
            ent: Dict[str, Any] = {
                "file": name,
                "bytes": os.path.getsize(path),
                "mtime": os.path.getmtime(path),
            }
            try:
                header, _, crc = _read_header(path)
                ent["key"] = header.get("key", {})
                ent["created"] = header.get("created")
                ent["compiler"] = header.get("compiler")
                ent["build_s"] = header.get("build_s")
                ent["crc"] = crc
            except (OSError, ValueError) as e:
                ent["corrupt"] = str(e)
            out.append(ent)
        return out

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries())

    def _sweep_tmp(self) -> List[str]:
        """Remove what a killed writer left: ``*.tmp.<pid>`` files, build
        directories, and half-written extractions under ``lib/``.  Only the
        maintenance commands run it: a live concurrent writer's tmp file
        swept at boot would fail its rename."""
        removed = []
        libdir = os.path.join(self.dir, _LIB_DIR)
        for d in (self.dir, libdir):
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if ".tmp." in name and _remove(os.path.join(d, name)):
                    removed.append(name)
        return removed

    def _sweep_libs(self) -> None:
        """Remove extracted libraries whose entry is gone or holds other
        bytes now (a process that mapped one keeps its mapping)."""
        libdir = os.path.join(self.dir, _LIB_DIR)
        if not os.path.isdir(libdir):
            return
        live = {e["file"][: -len(_SUFFIX)] + f"-{e['crc']:08x}.so"
                for e in self.entries() if "crc" in e}
        for name in os.listdir(libdir):
            if name not in live:
                _remove(os.path.join(libdir, name))

    def prune(self, max_bytes: int) -> List[str]:
        """Drop oldest-first (mtime) until the store fits; orphaned tmp
        files and corrupt entries go first, and the extracted copies of
        what went.  Returns the removed entry and tmp filenames."""
        removed = self._sweep_tmp()
        ents = self.entries()
        ents.sort(key=lambda e: (0 if "corrupt" in e else 1, e["mtime"]))
        total = sum(e["bytes"] for e in ents)
        for e in ents:
            if total <= max_bytes and "corrupt" not in e:
                break
            if not _remove(os.path.join(self.dir, e["file"])):
                continue
            total -= e["bytes"]
            removed.append(e["file"])
        self._sweep_libs()
        return removed

    def clear(self) -> int:
        """Remove every entry, tmp file and extracted library; returns the
        count of entries and tmp files removed."""
        n = len(self._sweep_tmp())
        for name in os.listdir(self.dir):
            if name.endswith(_SUFFIX) and _remove(os.path.join(self.dir, name)):
                n += 1
        _remove(os.path.join(self.dir, _LIB_DIR))
        return n

    def summary(self) -> Dict[str, Any]:
        ents = self.entries()  # one directory scan, header-only reads
        return {
            "dir": self.dir,
            "entries": len(ents),
            "mb": round(sum(e["bytes"] for e in ents) / 1e6, 2),
            "compiles": self.compiles,
            "loads": self.loads,
            "hit": self._stats.count("aot_cache/hit"),
            "miss": self._stats.count("aot_cache/miss"),
            "stale": self._stats.count("aot_cache/stale"),
            "corrupt": self._stats.count("aot_cache/corrupt"),
            "serialization": serialization_available(),
        }


# one store object per directory per process: the libraries a process loads
# are process-wide (ctypes handles), so are the counters of the store they
# came from; the trainer and the lazy loaders share it
_stores: Dict[str, AOTCache] = {}
_stores_lock = threading.Lock()


def process_store(cache_dir: Optional[str] = None) -> Optional[AOTCache]:
    """This process's store for `cache_dir` (default: the ``aot_cache_dir``
    flag), or None when that is empty."""
    if cache_dir is None:
        from paddle_tpu_torch.utils.flags import get_flag

        cache_dir = get_flag("aot_cache_dir")
    if not cache_dir:
        return None
    key = os.path.abspath(cache_dir)
    with _stores_lock:
        if key not in _stores:
            _stores[key] = AOTCache(key)
        return _stores[key]


def native_library(name: str, files: Sequence[str], argv: Sequence[str],
                   build: Callable[[Optional[str]], str], *, device: bool = False,
                   compiler: Optional[Callable[[], str]] = None,
                   cache: Optional[AOTCache] = None) -> str:
    """The path of a native library to ``ctypes.CDLL``, the one helper of
    the port's three loaders.  With a store (`cache`, else the
    ``aot_cache_dir`` flag's) the library comes from it, or is built by
    ``build(out_dir)`` into a fresh directory and stored; without one,
    ``build(None)`` builds (or finds) it in the package's ``_build/``.
    `device` adds the current CUDA device to the key (an nvcc library)."""
    store = cache if cache is not None else process_store()
    if store is None:
        return build(None)
    return store.get_or_build(library_identity(name, files, argv),
                              device_key() if device else None, build, compiler)


def host_library(src: str, so: str, flags: Sequence[str]) -> Optional[str]:
    """The path of a g++-built host library (the recordio reader, the
    protodata decoder) compiled from `src` with `flags`: through the store
    when the ``aot_cache_dir`` flag is set, else ``so`` in ``_build/``,
    rebuilt when missing or older than `src`.  Without `src`, a prebuilt
    ``so`` or None, as in the JAX package.  A failed build raises
    (``OSError``, ``CalledProcessError``): the callers fall back to Python."""
    if not os.path.exists(src):
        return so if os.path.exists(so) else None
    argv = ("g++", *flags)

    def build(out_dir: Optional[str]) -> str:
        out = so if out_dir is None else os.path.join(out_dir, os.path.basename(so))
        if out_dir is None and os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
            return so
        os.makedirs(os.path.dirname(out), exist_ok=True)
        # per-pid temp + rename: concurrent processes never load a
        # half-written library
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([*argv, src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
        return out

    name = os.path.splitext(os.path.basename(so))[0]
    return native_library(name, (src,), argv, build, compiler=lambda: "g++")
