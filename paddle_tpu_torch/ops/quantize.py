"""Block-scaled quantization, the numpy wire half — the counterpart of
``paddle_tpu/ops/quantize.py:48-155``.

An elastic worker's per-task gradient contribution rides the master wire
as (int8 blocks, f32 scales) typed arrays (:func:`quantize_tree`) and is
dequantized before the sorted-order reduction (:func:`dequantize_tree`),
so every reducer reduces the same bytes and the trajectory stays
bit-identical fleet-wide.  The bytes equal the JAX package's, so a mixed
fleet reduces alike.  This module imports neither torch nor the port's
device modules.

Format: an array is flattened C-order, zero-padded to a multiple of
``block`` (the ``quantize_block_size`` flag), and reshaped to
``[n_blocks, block]``; each block stores an int8 payload in ``[-127, 127]``
plus one f32 scale (max-abs over the block / 127).  Dequantize is
``payload * scale`` truncated back to the original shape; a zero block
quantizes against scale 1.0.

The in-graph halves wait: ``quantize_block_scaled``,
``dequantize_block_scaled`` and ``quantized_psum`` (the quantized gradient
reduction over a device mesh, ROADMAP Queue 1 item 6) and the serving
weight bundles (item 4.5) raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "DEFAULT_BLOCK",
    "INT8_MAX",
    "QUANT_KEY",
    "quantize_array",
    "dequantize_array",
    "is_quantized_array",
    "quantize_tree",
    "dequantize_tree",
    "tree_wire_bytes",
    "quantize_block_scaled",
    "dequantize_block_scaled",
    "quantized_psum",
    "quantize_weight_bundle",
    "dequantize_weight_bundle",
    "weight_bundle_bytes",
]

DEFAULT_BLOCK = 256
INT8_MAX = 127.0

# the wire marker key of a quantized-leaf dict (a plain string key so the
# restricted master_wire codec carries it without any new type)
QUANT_KEY = "__bsq__"


def _resolve_block(block: Optional[int]) -> int:
    if block is not None:
        return int(block)
    try:
        from paddle_tpu_torch.utils.flags import get_flag

        return int(get_flag("quantize_block_size"))
    except Exception:  # noqa: BLE001 — flag plane not loaded (stripped use)
        return DEFAULT_BLOCK


def quantize_array(a: np.ndarray, block: Optional[int] = None
                   ) -> Dict[str, Any]:
    """One float ndarray -> the wire-ready quantized-leaf dict
    ``{QUANT_KEY: 1, "q": int8 [nb, block], "s": f32 [nb], "shape": [...],
    "dtype": "<name>"}`` (every value inside the restricted master_wire
    type set).  Deterministic round-half-even — the producing worker's
    bytes are the contribution; every reducer dequantizes the SAME bytes,
    so the sorted-order reduction stays bit-identical fleet-wide."""
    block = _resolve_block(block)
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        raise TypeError(f"quantize_array wants a float array, got {a.dtype}")
    n = a.size
    nb = max((n + block - 1) // block, 1)
    flat = np.zeros((nb * block,), np.float32)
    flat[:n] = a.astype(np.float32, copy=False).reshape(-1)
    blocks = flat.reshape(nb, block)
    amax = np.max(np.abs(blocks), axis=1)
    scale = amax / np.float32(INT8_MAX)
    safe = np.where(amax == 0.0, np.float32(1.0), scale)
    q = np.clip(np.rint(blocks / safe[:, None]), -INT8_MAX, INT8_MAX)
    return {
        QUANT_KEY: 1,
        "q": q.astype(np.int8),
        "s": scale.astype(np.float32),
        "shape": [int(d) for d in a.shape],
        "dtype": str(a.dtype),
    }


def is_quantized_array(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get(QUANT_KEY) == 1


def dequantize_array(d: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`quantize_array` (up to the one rounding)."""
    q = np.asarray(d["q"], np.float32)
    s = np.asarray(d["s"], np.float32)
    flat = (q * s[:, None]).reshape(-1)
    shape = tuple(int(x) for x in d["shape"])
    n = int(np.prod(shape)) if shape else 1
    out = flat[:n].reshape(shape)
    return out.astype(np.dtype(str(d["dtype"])), copy=False)


def quantize_tree(tree: Any, block: Optional[int] = None) -> Any:
    """Recursively quantize every float ndarray leaf of a nested-dict
    gradient tree (the elastic contribution payload); non-float leaves
    and scalars pass through untouched."""
    if isinstance(tree, dict):
        return {k: quantize_tree(v, block) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.ndim >= 1 and np.issubdtype(arr.dtype, np.floating):
        return quantize_array(arr, block)
    return tree


def dequantize_tree(tree: Any) -> Any:
    """Recursively undo :func:`quantize_tree`; a mixed tree (some tasks
    quantized, some not — a fleet mid-flag-flip) dequantizes only the
    marked leaves."""
    if is_quantized_array(tree):
        return dequantize_array(tree)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    return tree


def tree_wire_bytes(tree: Any) -> int:
    """Approximate payload bytes of a contribution tree (array bytes only
    — framing/tag overhead excluded), for the wire-reduction arithmetic
    the bench records check against the measured counters."""
    if isinstance(tree, dict):
        return sum(tree_wire_bytes(v) for v in tree.values())
    arr = np.asarray(tree)
    return int(arr.nbytes)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def quantize_block_scaled(*args, **kwargs):
    """The in-graph block-scaled quantize (device mesh, item 6)."""
    _not_ported("quantize_block_scaled (the in-graph quantizer)", "6")


def dequantize_block_scaled(*args, **kwargs):
    """The in-graph block-scaled dequantize (device mesh, item 6)."""
    _not_ported("dequantize_block_scaled (the in-graph quantizer)", "6")


def quantized_psum(*args, **kwargs):
    """The quantized gradient reduction over a device mesh (item 6)."""
    _not_ported("quantized_psum (the quantized gradient reduction over a mesh)", "6")


def quantize_weight_bundle(*args, **kwargs):
    """Serving's weight-only int8 bundle (item 4.5)."""
    _not_ported("quantize_weight_bundle (int8 serving weights)", "4.5")


def dequantize_weight_bundle(*args, **kwargs):
    """Serving's weight-only int8 bundle (item 4.5)."""
    _not_ported("dequantize_weight_bundle (int8 serving weights)", "4.5")


def weight_bundle_bytes(*args, **kwargs):
    """Serving's weight-only int8 bundle (item 4.5)."""
    _not_ported("weight_bundle_bytes (int8 serving weights)", "4.5")
