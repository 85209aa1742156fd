"""Flash attention: hand-written CUDA kernels for Hopper (the forward and the
two backward kernels, dq and dk/dv) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas_attention.py`` (``flash_attention``,
``flash_attention_diff``, ``_flash_fwd``, ``_flash_bwd`` and the TPU kernels
``_fa_fwd_kernel``, ``_fa_bwd_dq_kernel``, ``_fa_bwd_dkv_kernel``).  The
kernels live in ``paddle_tpu_torch/csrc/*.cu`` (with the tensor-core building
blocks in ``csrc/flash_mma.cuh``); they are compiled with ``nvcc`` at first
use into one shared library under ``paddle_tpu_torch/_build/`` and bound
through plain C functions loaded with ``ctypes``.

bf16 inputs run all three kernels on the tensor cores (``mma.sync``,
``ldmatrix``, ``cp.async``), which copy 16 bytes at a time: each bf16
operand must be 16-byte aligned with batch and token strides that are
multiples of 8 elements, or the wrapper raises.  f32 inputs run the scalar
kernels (TF32 products would break the f32 bars).  A bf16 kernel and its
plain version both round p and ds to bf16 but sum in other orders, so they
may differ by rounding flips: :func:`flash_attention_bwd_bar` bounds how far
a correct backward kernel may lie from the plain one.

Routing is by the tensor's device: a CUDA tensor launches a kernel (or
raises), a CPU tensor runs the plain version (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`), the blocked loops that play the part
``interpret=True`` plays in the JAX package.  There is no fallback from one
to the other.

The kernels are also bound as two custom operators,
``paddle_tpu_torch::flash_attention_fwd`` and ``::flash_attention_bwd``
(``torch.library.custom_op``: the CUDA kernel launches the kernels, the CPU
kernel is the plain version, a fake kernel gives shapes, and the forward's
autograd formula calls the backward op).  The entry points go through them
only inside :func:`as_graph_ops`, which ``analysis.trace_lint.trace_step``
enters: a dispatcher-level trace of a step then holds one opaque node per
launch, and re-running that node launches the kernel.  Outside it they call
the same launches straight, which keeps the dispatcher's Python round trip
(measured in ``chip_smoke.py`` phase 5) off every training step.

:func:`flash_attention` refuses inputs that require grad while grad mode
is on; :func:`flash_attention_diff` is the differentiable entry point,
whose backward is the two backward kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
BLOCK = 64  # keys per tile: BN of the kernels in csrc/

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()


def supported(t: int, dh: int) -> bool:
    """The JAX package's routing predicate (pallas_attention.supported),
    kept as is so the port routes exactly as the reference does."""
    return t % min(128, t) == 0 and dh % 8 == 0 and t >= 128


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash-attention kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Compile every ``csrc/*.cu`` into one shared library in ``_build/``
    (keyed by the hash of every source and header plus the flags, so an
    edited source or header rebuilds) and return its path.  One ``nvcc`` per
    source, all started together, then one link; ``verbose`` prints ptxas's
    per-kernel registers, shared memory and spills."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"flash_attention-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c", "-o", obj, src]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(f"{os.path.basename(src)}:\n{err.strip()}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{out}.{tag}"
    proc = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)],
        capture_output=True, text=True,
    )
    for _, obj, _ in jobs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # dtype, q k v lengths o lse, b t h dh, 6 strides, causal, stream
    "flash_attention_fwd": [_I] + [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I, _P],
    # dtype, q k v dO lse delta lengths dq, b t h dh, 8 strides, causal, stream
    "flash_attention_bwd_dq": [_I] + [_P] * 8 + [_I] * 4 + [_L] * 8 + [_I, _P],
    # dtype, q k v dO lse delta lengths dk dv, b t h dh, 8 strides, causal, stream
    "flash_attention_bwd_dkv": [_I] + [_P] * 9 + [_I] * 4 + [_L] * 8 + [_I, _P],
}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation type: f32, or f64 for f64 inputs (so
    that ``torch.autograd.gradcheck`` can hold the Function to finite
    differences on the CPU)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H, dh] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    b, t, h, dh = q.shape
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B]={b}; got {tuple(lengths.shape)}")
    return b, t, h, dh


def check_aligned(name: str, x: torch.Tensor) -> None:
    """The bf16 tensor-core kernels copy 16-byte chunks (8 elements) with
    cp.async: `x` must start on 16 bytes, with batch and token strides that
    are multiples of 8 elements.  The main path always meets this (the fused
    QKV splits at H * dh, a multiple of 8; cross-attention is dense)."""
    if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
        raise ValueError(
            f"{name}: the bf16 kernels need a 16-byte aligned operand with batch "
            f"and token strides that are multiples of 8; got address "
            f"{x.data_ptr():#x}, strides {x.stride()}"
        )


def _kernel_operands(dev, dtype, dh, lengths, b, t, **operands):
    """Check what the CUDA kernels take (dtype, dh, dense [H, dh] axes of
    each operand, bf16 alignment) and return lengths as a contiguous int32
    tensor on `dev`."""
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")
    if dh % 8 or dh > 128:
        raise ValueError(f"the kernels take dh a multiple of 8 up to 128; got {dh}")
    for name, x in operands.items():
        if x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(
                f"{name} must have dense [H, dh] axes (strides {dh}, 1); got "
                f"strides {x.stride()}"
            )
        if dtype == torch.bfloat16:
            check_aligned(name, x)
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=dev)
    if lengths.dtype != torch.int32 or lengths.device != dev or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 tensor on q's device")
    return lengths


def flash_attention(
    q: torch.Tensor,  # [B, T, H, dh]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] valid key counts
    causal: bool = False,
    *,
    return_lse: bool = False,
):
    """[B, T, H, dh] -> [B, T, H, dh] exact softmax attention (and the f32
    row log-sum-exp [B, H, T] with ``return_lse``).  No autograd history:
    inputs that require grad in grad mode raise (use
    :func:`flash_attention_diff`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention records no gradient; inputs that require grad "
            "go through flash_attention_diff"
        )
    _check(q, k, v, lengths)
    out, lse = (_fwd_op if _graph_ops.depth else _fwd)(q, k, v, lengths, bool(causal))
    return (out, lse) if return_lse else out


class _GraphOps(threading.local):
    depth = 0


_graph_ops = _GraphOps()


@contextlib.contextmanager
def as_graph_ops():
    """Within this block (on this thread) the entry points call the custom
    operators, so that a dispatcher-level trace records each launch as one
    node; outside it they launch the kernels directly."""
    _graph_ops.depth += 1
    try:
        yield
    finally:
        _graph_ops.depth -= 1


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: Optional[torch.Tensor], causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (O, f32 lse) of checked [B, T, H, dh] operands."""
    b, t, h, dh = q.shape
    lengths = _kernel_operands(q.device, q.dtype, dh, lengths, b, t, q=q, k=k, v=v)
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch_fwd((q, k, v, lengths), (out, lse), causal)
    return out, lse


def _launch_fwd(operands, outs, causal: bool) -> None:
    """Launch the forward kernel on the current stream: `operands` =
    (q, k, v, lengths) as :func:`_kernel_operands` checked them, `outs` =
    (O, lse), dense."""
    q, k, v, lengths = operands
    out, lse = outs
    b, t, h, dh = q.shape
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = _load().flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, h, dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1


def _fwd_plain(q, k, v, lengths, causal):
    return flash_attention_reference(q, k, v, lengths, causal, return_lse=True)


def _fwd(q, k, v, lengths, causal):
    """The forward by device, outside the dispatcher."""
    return (_fwd_plain if q.device.type == "cpu" else _fwd_kernel)(q, k, v, lengths, causal)


_fwd_op = torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd", _fwd_kernel,
                                  mutates_args=(), device_types="cuda")
_fwd_op.register_kernel("cpu")(_fwd_plain)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, lengths, causal):
    b, t, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=_acc_dtype(q.dtype))


def _fwd_setup(ctx, inputs, output):
    q, k, v, lengths, causal = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], lengths)
    ctx.causal = causal


def _grads(bwd, ctx, do):
    """delta = rowsum(dO * O) in plain torch (outside the kernels, as in the
    JAX package), then the backward kernels through `bwd` (the op or the
    straight route, as the forward went: autograd may run this on another
    thread than the forward's)."""
    q, k, v, o, lse, lengths = ctx.saved_tensors
    acc = _acc_dtype(o.dtype)
    delta = (do.to(acc) * o.to(acc)).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = _backward(bwd, q, k, v, o, lse, delta, do, lengths, ctx.causal)
    return dq, dk, dv, None, None


def _fwd_backward(ctx, do, _dlse):
    return _grads(_bwd_op, ctx, do)


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


class _FlashAttention(torch.autograd.Function):
    """The differentiable forward outside :func:`as_graph_ops`: the forward
    kernel (or its plain version) with the row lse kept, the backward
    kernels in its backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        o, lse = _fwd(q, k, v, lengths, causal)
        _fwd_setup(ctx, (q, k, v, lengths, causal), (o, lse))
        return o

    @staticmethod
    def backward(ctx, do):
        return _grads(_bwd, ctx, do)


# launches of the CUDA kernel; the plain version never counts
flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, delta, do, lengths=None, causal=False):
    """(dq, dk, dv) of attention, in q's, k's and v's dtypes, from the
    forward's residuals: ``o`` [B, T, H, dh] (checked for shape; the kernels
    read it only through ``delta``), ``lse`` [B, H, T] from the forward,
    ``delta = rowsum(dO * O)`` [B, H, T] and the output gradient ``do``.  The
    two CUDA kernels on a CUDA tensor, their plain version on a CPU tensor."""
    bwd = _bwd_op if _graph_ops.depth else _bwd
    return _backward(bwd, q, k, v, o, lse, delta, do, lengths, causal)


def _backward(bwd, q, k, v, o, lse, delta, do, lengths, causal):
    """Check the backward's operands, then run `bwd` on them."""
    b, t, h, dh = _check(q, k, v, lengths)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o and do must be {tuple(q.shape)}; got {tuple(o.shape)}, {tuple(do.shape)}"
        )
    if tuple(lse.shape) != (b, h, t) or tuple(delta.shape) != (b, h, t):
        raise ValueError(
            f"lse and delta must be [B, H, T]={(b, h, t)}; got "
            f"{tuple(lse.shape)}, {tuple(delta.shape)}"
        )
    if any(x.device != q.device for x in (o, lse, delta, do)):
        raise ValueError("o, lse, delta and do must lie on q's device")
    if do.dtype != q.dtype:
        raise TypeError(f"do must be {q.dtype}, not {do.dtype}")
    return bwd(q, k, v, lse, delta, do, lengths, bool(causal))


def _bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
                delta: torch.Tensor, do: torch.Tensor, lengths: Optional[torch.Tensor],
                causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq and dk/dv kernels on checked operands."""
    b, t, h, dh = q.shape
    do = do.contiguous()  # a copy only if autograd handed a strided gradient
    lengths = _kernel_operands(q.device, q.dtype, dh, lengths, b, t, q=q, k=k, v=v, do=do)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be float32")
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, h, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, h, dh), dtype=v.dtype, device=q.device)
    operands = (q, k, v, do, lse, delta, lengths)
    _launch_bwd("dq", operands, (dq,), causal)
    _launch_bwd("dkv", operands, (dk, dv), causal)
    return dq, dk, dv


def _bwd_plain(q, k, v, lse, delta, do, lengths, causal):
    return flash_attention_bwd_reference(q, k, v, lse, delta, do.contiguous(), lengths, causal)


def _bwd(q, k, v, lse, delta, do, lengths, causal):
    """The backward by device, outside the dispatcher."""
    kernel = _bwd_plain if q.device.type == "cpu" else _bwd_kernel
    return kernel(q, k, v, lse, delta, do, lengths, causal)


_bwd_op = torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd", _bwd_kernel,
                                  mutates_args=(), device_types="cuda")
_bwd_op.register_kernel("cpu")(_bwd_plain)


@_bwd_op.register_fake
def _bwd_fake(q, k, v, lse, delta, do, lengths, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _launch_bwd(kernel: str, operands, outs, causal: bool) -> None:
    """Launch one backward kernel, ``"dq"`` or ``"dkv"``, on the current
    stream: `operands` = (q, k, v, do, lse, delta, lengths) as
    :func:`flash_attention_bwd` checked them, `outs` its dense outputs."""
    q, k, v, do, lse, delta, lengths = operands
    b, t, h, dh = q.shape
    fn = getattr(_load(), f"flash_attention_bwd_{kernel}")
    with torch.cuda.device(q.device):
        err = fn(
            _DTYPE_CODE[q.dtype], *(x.data_ptr() for x in (*operands, *outs)), b, t, h, dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_{kernel} launch failed: cudaError {err}")
    name = f"{kernel}_launches"
    setattr(flash_attention_bwd, name, getattr(flash_attention_bwd, name) + 1)


# launches of each backward CUDA kernel; the plain version never counts
flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


def flash_attention_diff(q, k, v, lengths=None, causal=False):
    """Differentiable flash attention (the counterpart of the JAX package's
    ``flash_attention_diff`` custom VJP): gradients flow to q, k and v
    through the backward kernels."""
    _check(q, k, v, lengths)
    if _graph_ops.depth:
        return _fwd_op(q, k, v, lengths, bool(causal))[0]
    return _FlashAttention.apply(q, k, v, lengths, bool(causal))


def _operand(x, dtype):
    """x rounded to the input dtype and kept in its own: a product operand
    of the kernels (pallas_attention.py:114, 162, 199, 208 round p and ds to
    the input dtype before the MXU; the tensor-core kernels do the same).
    A no-op for f32 and f64 inputs."""
    return x.to(dtype).to(x.dtype)


def _valid_lengths(lengths, b, t, dev):
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int64, device=dev)
    return lengths.to(device=dev, dtype=torch.int64).clamp(0, t)


def _key_mask(k0, k1, lens, q_pos, causal):
    """[B, 1, T or 1, bk] validity of keys [k0, k1) for every query row."""
    k_pos = torch.arange(k0, k1, device=lens.device)
    mask = (k_pos[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return mask


def flash_attention_reference(q, k, v, lengths=None, causal=False, *, return_lse=False):
    """The kernel's arithmetic in plain torch: key tiles of ``BLOCK`` walked
    with an online softmax in f32 (f64 for f64 inputs; scores, the max and
    the normaliser stay in that type, as in the kernel), p rounded to the
    input dtype before P@V (the TPU kernel's MXU operand, a no-op for f32),
    key tiles past every length skipped (a masked key adds nothing to m, l
    or the sum), fully masked rows giving O = 0 and lse = -1e30 + log(1e-20)."""
    b, t, h, dh = _check(q, k, v, lengths)
    dev = q.device
    acc_t = _acc_dtype(q.dtype)
    lens = _valid_lengths(lengths, b, t, dev)
    scale = 1.0 / math.sqrt(dh)
    qh, kh, vh = (x.permute(0, 2, 1, 3).to(acc_t) for x in (q, k, v))  # [B,H,T,dh]
    m = torch.full((b, h, t), -math.inf, dtype=acc_t, device=dev)
    l = torch.zeros((b, h, t), dtype=acc_t, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=acc_t, device=dev)
    q_pos = torch.arange(t, device=dev)
    n_tiles = (int(lens.max()) + BLOCK - 1) // BLOCK if b else 0
    for k0 in range(0, n_tiles * BLOCK, BLOCK):
        k1 = min(k0 + BLOCK, t)
        s = torch.matmul(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
        mask = _key_mask(k0, k1, lens, q_pos, causal)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.matmul(_operand(p, q.dtype), vh[:, :, k0:k1])
        l = l * corr + p.sum(dim=-1)
        m = m_new
    m = torch.where(torch.isinf(m), torch.full_like(m, NEG_INF), m)
    l_safe = torch.clamp(l, min=1e-20)
    out = (acc / l_safe[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = m + torch.log(l_safe)
    return (out, lse) if return_lse else out


def _bwd_tiles(q, k, v, lse, delta, do, lengths, causal, acc_t):
    """The backward kernels' walk in plain torch, in `acc_t`: yields
    ``(k0, k1, mask, s, p, dpd, ds)`` for each key tile [k0, k1) of ``BLOCK``
    up to the last that holds a valid key, with the tile's [B, H, T, k1-k0]
    mask, scaled scores s = q k^T scale, probabilities p = where(mask,
    exp(s - lse), 0), dpd = dO v^T - delta and the unrounded
    ds = p dpd scale."""
    b, t, h, dh = q.shape
    dev = q.device
    lens = _valid_lengths(lengths, b, t, dev)
    scale = 1.0 / math.sqrt(dh)
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).to(acc_t) for x in (q, k, v, do))
    lse_c, delta_c = lse.to(acc_t)[..., None], delta.to(acc_t)[..., None]  # [B,H,T,1]
    q_pos = torch.arange(t, device=dev)
    n_tiles = (int(lens.max()) + BLOCK - 1) // BLOCK if b else 0
    for k0 in range(0, n_tiles * BLOCK, BLOCK):
        k1 = min(k0 + BLOCK, t)
        s = torch.matmul(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
        mask = _key_mask(k0, k1, lens, q_pos, causal)
        p = torch.where(mask, torch.exp(s - lse_c), torch.zeros_like(s))
        dpd = torch.matmul(doh, vh[:, :, k0:k1].transpose(-1, -2)) - delta_c
        yield k0, k1, mask, s, p, dpd, p * dpd * scale


def flash_attention_bwd_reference(q, k, v, lse, delta, do, lengths=None, causal=False,
                                  *, round_ds=True):
    """The backward kernels' arithmetic in plain torch: key tiles of
    ``BLOCK`` walked with f32 (f64 for f64 inputs) scores, probabilities
    p = exp(s - lse) under the forward's masks, ds = p (dp - delta) scale,
    and f32 accumulators dq += ds k, dk = ds^T q, dv = p^T dO, with p and ds
    rounded to the input dtype before those products (the TPU kernels' MXU
    operands; a no-op for f32).  Masked keys get dk = dv = 0 and a row with
    no valid key gives dq = 0.  ``round_ds=False`` leaves ds unrounded: a
    planted fault that the bf16 bar (:func:`flash_attention_bwd_bar`) must
    reject, never a mode of the kernels."""
    b, t, h, dh = _check(q, k, v, lengths)
    acc_t = _acc_dtype(q.dtype)
    qh, kh, doh = (x.permute(0, 2, 1, 3).to(acc_t) for x in (q, k, do))
    dq = torch.zeros((b, h, t, dh), dtype=acc_t, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0, k1, _, _, p, _, ds in _bwd_tiles(q, k, v, lse, delta, do, lengths, causal, acc_t):
        if round_ds:
            ds = _operand(ds, q.dtype)
        dq += torch.matmul(ds, kh[:, :, k0:k1])
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qh)
        dv[:, :, k0:k1] = torch.matmul(_operand(p, q.dtype).transpose(-1, -2), doh)
    return tuple(
        g.permute(0, 2, 1, 3).to(x.dtype) for g, x in ((dq, q), (dk, k), (dv, v))
    )


# unit roundoff of f32 sums: 2^-24 rounding to nearest (the plain version's
# cuBLAS or CPU GEMMs); 2^-23 for the tensor cores' f32 accumulation, which
# is not specified to round to nearest (one ulp per addition covers
# truncation)
_U_PLAIN, _U_KERNEL = 2.0 ** -24, 2.0 ** -23
# absolute slack of any f32 operation on subnormal values
_TINY = 2.0 ** -140


def _gamma(n):
    """Bound on |kernel sum - plain sum| / sum |terms| for n terms whose
    products are exact in f32 (bf16 x bf16), summed in any order on each
    side: gamma_n = n u / (1 - n u) for each side's unit roundoff."""
    return sum(n * u / (1 - n * u) for u in (_U_PLAIN, _U_KERNEL))


def _flips(x, d):
    """How far the bf16 rounding of any f32 value within d of x can lie from
    the rounding of x: round(x + d) - round(x - d) (rounding is monotone).
    0 where no bf16 rounding midpoint lies within d of x, one bf16 step of x
    at a near-tie.  x, d f64; the ends move outward by one f32 step so that
    their own rounding to f32 cannot narrow the interval."""
    hi = torch.nextafter((x + d).float(), torch.tensor(math.inf, device=x.device))
    lo = torch.nextafter((x - d).float(), torch.tensor(-math.inf, device=x.device))
    return hi.to(torch.bfloat16).double() - lo.to(torch.bfloat16).double()


def flash_attention_bwd_bar(q, k, v, lse, delta, do, lengths=None, causal=False):
    """Per-element bars (f64, [B, T, H, dh] each) on |g_kernel - g_plain| for
    the bf16 dq, dk and dv: what a correct kernel may differ from
    :func:`flash_attention_bwd_reference` by, with no flat floor.

    Each gradient is g = sum_r a_r b_r with a_r rounded to bf16 before the
    product (a = ds, b = k for dq; a = ds, b = q for dk; a = p, b = dO for
    dv).  Kernel and plain version compute the same f32 a_r in another
    order, so their a_r differ by at most delta_r (below); the bar is

    * flipped operands: sum_r |b_r| (round(a_r + delta_r) - round(a_r -
      delta_r)), one bf16 step of a_r where a_r lies within delta_r of a
      bf16 rounding midpoint, 0 elsewhere;
    * summation order: gamma_n sum_r (|a_r| + flip_r) |b_r|, n the count of
      unmasked terms (adding a masked 0 is exact);
    * the store: 2^-7 (|g| + flip + 2 order) bounds the two roundings of g
      to bf16 (each within half a step, 2^-8 of its value).

    delta_r, carried from two dot products of length dh whose bf16 products
    are exact in f32 (so each differs by at most gamma_dh sum |terms|):
      x  = s scale - lse:    dx  = scale gamma_dh sum_d |q_d k_d|
                                   + u (5 |s scale| + 2 |x|)
           (scale itself rounded on each side, a multiply and a subtract on
           each side, possibly fused);
      p  = exp(x):           dp  = p (expm1(dx) (1 + 2^-21) + 2^-21)
           (exp within 2 ulp on each side);
      dpd = dO v - delta:    dd  = gamma_dh sum_d |dO_d v_d| + 2 u |dpd|;
      ds = p dpd scale:      dds = scale (dp (|dpd| + dd) + p dd) + 7 u |ds|
           (the scale and the two multiplies rounded on each side);
    u = 2^-24, plus 2^-140 absolute for subnormals."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the bar is for bf16 inputs; {q.dtype} has its own bars")
    b, t, h, dh = _check(q, k, v, lengths)
    f64 = torch.float64
    scale = 1.0 / math.sqrt(dh)
    u, g_dh = _U_PLAIN, _gamma(dh)
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).to(f64) for x in (q, k, v, do))
    aq, ak, av, ado = (x.abs() for x in (qh, kh, vh, doh))
    lse_c = lse.to(f64)[..., None]
    # per gradient: the plain f64 sum, the flip term, sum (|a| + flip) |b|, n
    sums = {g: [torch.zeros((b, h, t, dh), dtype=f64, device=q.device) for _ in range(3)]
            + [torch.zeros((b, h, t, 1), dtype=f64, device=q.device)]
            for g in ("dq", "dk", "dv")}
    for k0, k1, mask, s, p, dpd, ds in _bwd_tiles(
            q, k, v, lse, delta, do, lengths, causal, torch.float32):
        s, p, dpd, ds = (x.to(f64) for x in (s, p, dpd, ds))
        kt = slice(k0, k1)
        mask = mask.expand(p.shape)
        # masked keys give p = 0 on both sides (and x is unbounded on a row
        # with no valid key, whose lse is -1e30)
        dx = torch.where(mask, scale * g_dh * torch.matmul(aq, ak[:, :, kt].transpose(-1, -2))
                         + u * (5 * s.abs() + 2 * (s - lse_c).abs()), 0.0)
        d_p = p * (torch.expm1(dx) * (1 + 2.0 ** -21) + 2.0 ** -21) + _TINY
        d_dpd = g_dh * torch.matmul(ado, av[:, :, kt].transpose(-1, -2)) + 2 * u * dpd.abs()
        d_ds = scale * (d_p * (dpd.abs() + d_dpd) + p * d_dpd) + 7 * u * ds.abs() + _TINY
        n = mask.to(f64)
        f_ds, f_p = _flips(ds, d_ds), _flips(p, d_p)
        r_ds, r_p = (_operand(x.float(), torch.bfloat16).to(f64) for x in (ds, p))
        # dq sums over this tile's keys; dk and dv over every query, into
        # this tile's key rows
        for name, a_r, flip, n_r, rows, b_, b_abs in (
                ("dq", r_ds, f_ds, n, slice(None), kh[:, :, kt], ak[:, :, kt]),
                ("dk", r_ds.mT, f_ds.mT, n.mT, kt, qh, aq),
                ("dv", r_p.mT, f_p.mT, n.mT, kt, doh, ado)):
            g, fl, ab, cnt = sums[name]
            g[:, :, rows] += torch.matmul(a_r, b_)
            fl[:, :, rows] += torch.matmul(flip, b_abs)
            ab[:, :, rows] += torch.matmul(a_r.abs() + flip, b_abs)
            cnt[:, :, rows] += n_r.sum(-1, keepdim=True)
    bars = []
    for name in ("dq", "dk", "dv"):
        g, fl, ab, cnt = sums[name]
        order = _gamma(cnt) * ab
        bars.append((fl + order + 2.0 ** -7 * (g.abs() + fl + 2 * order)).permute(0, 2, 1, 3))
    return tuple(bars)
