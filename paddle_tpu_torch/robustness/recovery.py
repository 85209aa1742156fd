"""Auto-rollback: last-good checkpoints and the reference master's
``failure_max`` discipline applied to data windows — the counterpart of
``paddle_tpu/robustness/recovery.py``.

The reference master retries a failing task and discards one that fails
more than ``failure_max`` times (go/master/service.go:308-336
processFailedTask).  Here the unit of failure is the data window, every
batch applied since the last good checkpoint, and the loop is

    diverged  ->  restore the last-good full state (parameters, optimizer
                  state, generator and counters, checkpoint.CheckpointManager)
              ->  retry the window (its staged batches were retained)
              ->  after ``failure_max`` failures of the same window,
                  quarantine it: drop its batches and go on with the stream
                  (``robustness.quarantined_batches``).

The coordinator owns the window buffer, the failure counts per window and
the checkpoint bookkeeping; ``trainer/sgd.py`` owns the loop and calls in.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.utils.timers import global_stats

__all__ = ["RecoveryCoordinator"]

_log = logging.getLogger("paddle_tpu_torch.robustness")


class RecoveryCoordinator:
    """Glue between the training loop and a checkpoint.CheckpointManager.

    save_fn(step, extra)  — write a full-state checkpoint (SGD.save_checkpoint
                            bound with the position dict as ``extra``).
    restore_fn()          — restore the latest good checkpoint into the
                            trainer; returns its ``extra`` dict or None when
                            the directory holds no usable checkpoint.
    """

    def __init__(
        self,
        save_fn: Callable[[int, Dict[str, Any]], None],
        restore_fn: Callable[[], Optional[Dict[str, Any]]],
        failure_max: int = 3,
        max_window_batches: int = 256,
        stats=None,
    ):
        self._save = save_fn
        self._restore = restore_fn
        self.failure_max = max(int(failure_max), 1)
        self.max_window_batches = max(int(max_window_batches), 1)
        self._stats = stats if stats is not None else global_stats
        # the current window: batches applied since the last checkpoint
        self._window: List[Tuple[int, int, Any]] = []  # (pass, batch, staged)
        self._window_start: Optional[Tuple[int, int]] = None
        self._window_replayable = True
        self._window_count = 0  # recorded batches incl. past the cap
        # step of the checkpoint that OPENED the current window: a restore
        # landing anywhere else means the anchor was lost (torn newest
        # checkpoint fell back further) and the window is not contiguous
        # with the restored state
        self._anchor_step: Optional[int] = None
        # failure counts per window identity (its start position) — the
        # reference's Task.Epoch, keyed by data range instead of task id
        self._failures: Dict[Tuple[int, int], int] = {}
        self.rollbacks = 0
        self.quarantined = 0
        self.replaying = False

    # -- window bookkeeping ---------------------------------------------
    def record(self, pass_id: int, batch_id: int, staged_batch: Any) -> None:
        """A LIVE batch is about to be applied: retain it for replay.
        Replayed batches are already in the window — don't re-record them."""
        if self._window_start is None:
            self._window_start = (pass_id, batch_id)
        self._window_count += 1
        if not self._window_replayable:
            return
        if len(self._window) >= self.max_window_batches:
            # unbounded retention would pin the whole pass in device memory;
            # past the cap the window can still be *quarantined* (restore +
            # skip forward) but no longer retried batch-for-batch
            _log.warning(
                "recovery: window exceeds %d batches; dropping replay "
                "buffer (divergence now quarantines without retry — "
                "lower checkpoint_period_batches to keep retries)",
                self.max_window_batches,
            )
            self._window.clear()
            self._window_replayable = False
            return
        self._window.append((pass_id, batch_id, staged_batch))

    def checkpoint(self, step: int, extra: Dict[str, Any]) -> None:
        """State at ``extra``'s position is good: persist it and open a new
        window.  Suppressed while a replay is in flight — the window buffer
        must keep meaning 'everything applied since the last checkpoint'."""
        if self.replaying:
            return
        self._save(step, extra)
        self._anchor_step = step
        self._open_new_window()

    def _open_new_window(self) -> None:
        self._window = []
        self._window_start = None
        self._window_replayable = True
        self._window_count = 0

    @property
    def window_len(self) -> int:
        return len(self._window)

    # -- the failure path ------------------------------------------------
    def on_divergence(self) -> Tuple[str, List[Tuple[int, int, Any]]]:
        """Roll back to last-good and rule on the offending window.

        Returns ``("retry", batches)`` — state was restored, re-apply these
        (pass_id, batch_id, staged) tuples before touching the live stream;
        ``("quarantine", [])`` — state was restored, the window is dropped,
        continue with the live stream; ``("none", [])`` — no checkpoint to
        restore (recovery disabled mid-air), continue as-is."""
        extra = self._restore()
        if extra is None:
            _log.error(
                "recovery: divergence with no restorable checkpoint — "
                "continuing without rollback"
            )
            return "none", []
        self.rollbacks += 1
        self._stats.incr("robustness.rollbacks")
        key = self._window_start or (-1, -1)
        self._failures[key] = self._failures.get(key, 0) + 1
        failures = self._failures[key]
        restored_step = int(extra.get("step_count", -1))
        anchor_lost = (
            self._anchor_step is not None
            and restored_step != self._anchor_step
        )
        if anchor_lost:
            # restore_latest fell back PAST the checkpoint that opened this
            # window (torn/corrupt newest): the retained batches are not
            # contiguous with the restored state, so replaying them would
            # silently skip the gap — quarantine instead and continue with
            # the live stream from an older-but-consistent state
            _log.error(
                "recovery: window %s's anchor checkpoint (step %s) is "
                "unrestorable; rolled back to step %d — the window is not "
                "contiguous with the restored state and is QUARANTINED "
                "(%d batches between the checkpoints are also skipped)",
                key, self._anchor_step, restored_step, self._window_count,
            )
            self._anchor_step = restored_step
        if anchor_lost or failures >= self.failure_max or not self._window_replayable:
            n = self._window_count
            self.quarantined += n
            self._stats.incr("robustness.quarantined_batches", n)
            if not anchor_lost:
                _log.error(
                    "recovery: window %s failed %d time(s) — QUARANTINED "
                    "(%d batch(es) dropped%s), training continues past it",
                    key, failures, n,
                    "" if self._window_replayable else ", unreplayable",
                )
            self._open_new_window()
            self.replaying = False
            return "quarantine", []
        _log.warning(
            "recovery: rolled back to last-good (failure %d/%d of window "
            "%s) — retrying %d retained batch(es)",
            failures, self.failure_max, key, len(self._window),
        )
        self.replaying = True
        return "retry", list(self._window)

    def replay_done(self) -> None:
        self.replaying = False

    # -- resume -----------------------------------------------------------
    def resume(self) -> Optional[Dict[str, Any]]:
        """Restore the latest good checkpoint (torn/corrupt ones are walked
        past by the manager); returns its position extra, or None."""
        extra = self._restore()
        if extra is not None:
            self._anchor_step = int(extra.get("step_count", 0))
            self._open_new_window()
        return extra

    @classmethod
    def from_flags(cls, save_fn, restore_fn, stats=None) -> "RecoveryCoordinator":
        from paddle_tpu_torch.utils import flags as _flags

        return cls(
            save_fn,
            restore_fn,
            failure_max=_flags.get_flag("failure_max"),
            stats=stats,
        )
