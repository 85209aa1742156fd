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

The tensor halves (:func:`quantize_block_scaled`,
:func:`dequantize_block_scaled`) and the serving engine's int8 weight
bundles (:func:`quantize_weight_bundle`, :func:`dequantize_weight_bundle`,
:func:`weight_bundle_bytes`) import torch inside each call; their ``q`` and
``s`` equal the JAX package's bit for bit on the CPU (both round half to
even).  ``quantized_psum`` (the quantized gradient reduction over a device
mesh, ROADMAP Queue 1 item 6) raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# tensor halves (torch imported inside each function, so the master plane
# that imports this module stays torch-free)
# ---------------------------------------------------------------------------

def quantize_block_scaled(x, block: Optional[int] = None, payload_dtype=None,
                          stochastic: bool = False, generator=None, scale_dtype=None):
    """Block-scaled quantize of a tensor: ``x`` (any shape, float) ->
    ``(payload [nb, block], scales [nb])`` on ``x``'s device.

    ``payload_dtype``: ``torch.int8`` (default) or ``torch.bfloat16``.  int8
    payloads round half to even into ``[-127, 127]`` with per-block scale
    ``amax / 127``; bf16 payloads store ``block / amax`` with scale
    ``amax``.  ``stochastic`` (int8 only) rounds ``floor(v + u)``, ``u ~
    U[0, 1)`` drawn from the explicit ``torch.Generator`` ``generator``.
    ``scale_dtype`` narrows the stored scale (default f32); the zero guard
    applies only at exact amax 0."""
    import torch

    block = _resolve_block(block)
    payload_dtype = torch.int8 if payload_dtype is None else payload_dtype
    scale_dtype = torch.float32 if scale_dtype is None else scale_dtype
    n = x.numel()
    nb = max((n + block - 1) // block, 1)
    flat = torch.zeros((nb * block,), dtype=torch.float32, device=x.device)
    flat[:n] = x.detach().to(torch.float32).reshape(-1)
    blocks = flat.reshape(nb, block)
    amax = blocks.abs().amax(dim=1)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if payload_dtype == torch.int8:
        scale = (amax / INT8_MAX).to(scale_dtype)
        safe = torch.where(amax == 0.0, one, scale.to(torch.float32))
        v = blocks / safe[:, None]
        if stochastic:
            if generator is None:
                raise ValueError("stochastic rounding needs a torch.Generator")
            u = torch.rand(v.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
            v = torch.floor(v + u.to(v.device))
        else:
            v = torch.round(v)
        payload = torch.clamp(v, -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        scale = amax.to(scale_dtype)
        safe = torch.where(amax == 0.0, one, scale.to(torch.float32))
        payload = (blocks / safe[:, None]).to(payload_dtype)
    return payload, scale


def dequantize_block_scaled(payload, scales, shape, dtype=None):
    """Inverse of :func:`quantize_block_scaled`: ``payload * scale``,
    truncated back to ``shape`` and ``dtype``."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    flat = payload.to(torch.float32) * scales.to(torch.float32)[:, None]
    n = 1
    for d in shape:
        n *= int(d)
    return flat.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantized_psum(*args, **kwargs):
    """The quantized gradient reduction over a device mesh (item 6)."""
    _not_ported("quantized_psum (the quantized gradient reduction over a mesh)", "6")


# ---------------------------------------------------------------------------
# serving weight bundles: int8 weight-only decode
# ---------------------------------------------------------------------------

def quantize_weight_bundle(w: Dict[str, Any], block: Optional[int] = None, min_size: int = 512
                           ) -> Tuple[Dict[str, Any], Dict[str, Tuple[Tuple[int, ...], Any]]]:
    """Quantize the dense matrices of a fused decode-weight bundle (the
    serving engine's): every float tensor with ndim >= 2 and >= ``min_size``
    elements becomes ``{"q": int8 blocks, "s": f32 scales}``; biases,
    vectors and None ride through at full precision (weight-only
    quantization).  Returns ``(bundle, meta)``, ``meta`` mapping each
    quantized key to ``(shape, dtype)``."""
    block = _resolve_block(block)
    out: Dict[str, Any] = {}
    meta: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
    for k, v in w.items():
        if (v is not None and hasattr(v, "is_floating_point") and v.is_floating_point()
                and v.dim() >= 2 and v.numel() >= min_size):
            q, s = quantize_block_scaled(v, block=block)
            out[k] = {"q": q, "s": s}
            meta[k] = (tuple(int(d) for d in v.shape), v.dtype)
        else:
            out[k] = v
    return out, meta


def dequantize_weight_bundle(w: Dict[str, Any], meta: Dict[str, Tuple[Tuple[int, ...], Any]]
                             ) -> Dict[str, Any]:
    """Inverse of :func:`quantize_weight_bundle`; the serving engine runs it
    at the top of every dispatch, so the resident bundle holds the int8
    blocks and only the dispatch's working set holds f32 copies."""
    return {k: (dequantize_block_scaled(v["q"], v["s"], *meta[k]) if k in meta else v)
            for k, v in w.items()}


def weight_bundle_bytes(w: Dict[str, Any]) -> int:
    """Resident bytes of a (possibly quantized) weight bundle."""
    total = 0
    for v in w.values():
        if v is None:
            continue
        parts = v.values() if isinstance(v, dict) else (v,)
        total += sum(int(x.numel() * x.element_size()) for x in parts)
    return total
