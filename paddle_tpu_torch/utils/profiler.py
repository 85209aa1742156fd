"""Device profiling and the NaN trap — the counterpart of
``paddle_tpu/utils/profiler.py``.

* :func:`profile` (and :func:`start` / :func:`stop`) wraps
  ``torch.profiler.profile``: CPU activity, plus the card's kernels when the
  default device is the card, written as a Chrome/TensorBoard trace
  (``*.pt.trace.json``) under the log directory.  While it is active every
  obs host span (obs/tracer.py) also opens a ``record_function`` range of
  the same name, so the host spans and the device kernels share names in
  one timeline.

* :func:`enable_nan_checks` is the FP trap (the JAX package sets
  ``jax_debug_nans``): a ``TorchDispatchMode`` checks the floating-point
  outputs of every op that computes values and raises ``FloatingPointError``
  naming the aten op and, inside ``CompiledNetwork.apply``, the layer (its
  forward, or its backward).  Like JAX's, it checks NaN only, not inf.  Ops
  that allocate uninitialised memory (``empty``) or only move or view data
  (copies, casts, ``cat``, views) are not checked: a NaN fed in is reported
  where the first layer computes with it, as JAX reports it in the first
  computation and not in the transfer.  Armed, the mode sits on the arming
  thread's dispatch stack, and autograd carries it to the thread that runs
  the backward; each check reads the device (a host sync per op), which is
  debug cost.  Disarmed, no mode is on the stack.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["profile", "start", "stop", "enable_nan_checks", "active_trap"]

_active_profile = None  # the torch profiler that start() opened


def _logdir(logdir: Optional[str]) -> str:
    if logdir:
        return logdir
    from paddle_tpu_torch.utils.flags import get_flag

    logdir = get_flag("profile_dir")
    if not logdir:
        raise ValueError("no logdir given and the profile_dir flag is unset")
    return logdir


def _make_profile(logdir: str):
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    from paddle_tpu_torch.core import device as _device

    activities = [ProfilerActivity.CPU]
    if torch.device(_device._default_device).type == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities,
                                  on_trace_ready=tensorboard_trace_handler(logdir))


@contextlib.contextmanager
def profile(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """::

        with paddle.profiler.profile("/tmp/trace"):
            trainer.train(...)

    then open the ``*.pt.trace.json`` under the directory in Perfetto (or
    ``tensorboard --logdir /tmp/trace``).  With no argument the
    ``profile_dir`` flag (``PADDLE_TPU_TORCH_PROFILE_DIR``) names the
    directory; with neither it raises ``ValueError``.  Yields the torch
    profiler (``key_averages()`` and the rest)."""
    from paddle_tpu_torch import obs as _obs

    prof = _make_profile(_logdir(logdir))
    with prof:
        _obs.tracer.set_annotation_factory(torch.profiler.record_function)
        try:
            yield prof
        finally:
            _obs.tracer.set_annotation_factory(None)


def start(logdir: Optional[str] = None) -> None:
    """Open a profile that :func:`stop` closes and writes."""
    global _active_profile
    from paddle_tpu_torch import obs as _obs

    if _active_profile is not None:
        raise RuntimeError("a profile is already running; stop() it first")
    prof = _make_profile(_logdir(logdir))
    prof.start()
    _active_profile = prof
    _obs.tracer.set_annotation_factory(torch.profiler.record_function)


def stop() -> None:
    global _active_profile
    from paddle_tpu_torch import obs as _obs

    _obs.tracer.set_annotation_factory(None)
    prof, _active_profile = _active_profile, None
    if prof is None:
        raise RuntimeError("no profile is running")
    prof.stop()


# ---------------------------------------------------------------------------
# the NaN trap
# ---------------------------------------------------------------------------

# allocation of uninitialised memory, and ops that only copy, cast or pin
# values (views are recognised by OpOverload.is_view)
_UNCHECKED = frozenset(
    getattr(torch.ops.aten, name) for name in (
        "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
        "empty_permuted", "resize_", "set_", "_to_copy", "copy_", "clone", "detach",
        "lift_fresh", "lift_fresh_copy", "_pin_memory", "cat", "stack")
    if hasattr(torch.ops.aten, name))


def _has_nan(t) -> bool:
    return (torch.is_tensor(t) and t.is_floating_point() and t.layout == torch.strided
            and t.device.type != "meta" and t.numel() > 0 and bool(torch.isnan(t).any()))


class _NanTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an op's floating-point output holds
    a NaN.  ``CompiledNetwork.apply`` tells it the layer it is running
    (``forward_layer``) and hooks each layer's output so that the backward
    sets ``backward_layer`` before that layer's backward runs."""

    def __init__(self):
        super().__init__()
        self.forward_layer: Optional[str] = None
        self.backward_layer: Optional[str] = None

    def backward_hook(self, name: str):
        def hook(grad):
            self.backward_layer = name

        return hook

    def _where(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:
            layer = (f" of layer {self.backward_layer!r}" if self.backward_layer is not None
                     else "")
            return f"in the backward ({node.name()}){layer}"
        if self.forward_layer is not None:
            return f"in the forward of layer {self.forward_layer!r}"
        return "outside any layer"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNCHECKED or func.is_view:
            return out
        if any(_has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(
                f"check_nans: {func} produced NaN {self._where()}")
        return out


_trap: Optional[_NanTrap] = None


def active_trap() -> Optional[_NanTrap]:
    """The armed trap, or None."""
    return _trap


def enable_nan_checks(enable: bool = True) -> None:
    """Arm (or disarm) the NaN trap on the calling thread: from here on
    every op of the forward, the backward and the optimizer's update that
    makes a NaN raises ``FloatingPointError`` (debug cost: a host sync per
    op).  ``init(check_nans=True)`` arms it too."""
    global _trap
    if enable and _trap is None:
        trap = _NanTrap()
        trap.__enter__()
        _trap = trap
    elif not enable and _trap is not None:
        trap, _trap = _trap, None
        trap.__exit__(None, None, None)
