"""Divergence sentinel: the host half of the fused health check — the
counterpart of ``paddle_tpu/robustness/sentinel.py``.

The device half is in the train step (``trainer/step.py``): ``health`` is
1 when the cost and the gradients' global norm are both finite, and an
unhealthy step leaves parameters, layer state and optimizer state as they
were, so a non-finite batch is skipped, never applied.  This class judges
the observations:

* skip accounting: each skipped step adds to ``robustness.skipped_steps``,
  and ``skip_limit`` consecutive skips declare divergence;
* EMA loss spikes: a finite but exploding cost never lowers the health
  flag, so ``patience`` consecutive costs above ``spike_factor`` times the
  EMA of the healthy costs declare divergence.

Verdicts: ``"ok"``, ``"skip"`` (the step was dropped on the device) and
``"diverged"`` (roll back: robustness/recovery.py).
"""

from __future__ import annotations

import logging
import math
from typing import Optional

from paddle_tpu_torch.utils.timers import global_stats

__all__ = ["DivergenceSentinel"]

_log = logging.getLogger("paddle_tpu_torch.robustness")


class DivergenceSentinel:
    def __init__(
        self,
        skip_limit: int = 3,
        ema_decay: float = 0.98,
        spike_factor: float = 4.0,
        spike_patience: int = 3,
        warmup_steps: int = 20,
        min_spike_cost: float = 1e-3,
        stats=None,
    ):
        """warmup_steps: observations before the EMA is trusted.
        min_spike_cost: a floor under which no cost counts as a spike (noise
        near convergence is not divergence)."""
        self.skip_limit = max(int(skip_limit), 1)
        self.ema_decay = float(ema_decay)
        self.spike_factor = float(spike_factor)
        self.spike_patience = max(int(spike_patience), 1)
        self.warmup_steps = int(warmup_steps)
        self.min_spike_cost = float(min_spike_cost)
        self._stats = stats if stats is not None else global_stats
        self.reset()
        # lifetime counters survive reset(), which clears the judgement
        # after a rollback, not the run's history
        self.total_skipped = 0
        self.total_spikes = 0

    def reset(self) -> None:
        """Forget the judgement state (EMA, streaks): a restored trajectory
        is judged afresh."""
        self.ema: Optional[float] = None
        self._n_obs = 0
        self._skip_streak = 0
        self._spike_streak = 0

    @property
    def steady(self) -> bool:
        """No skip or spike streak in flight: the state may be anchored as
        last-good."""
        return self._skip_streak == 0 and self._spike_streak == 0

    def observe(self, cost: float, healthy: bool) -> str:
        """Fold one step's (cost, health) pair; returns this step's
        verdict."""
        self._n_obs += 1
        if not healthy:
            self._skip_streak += 1
            self.total_skipped += 1
            self._stats.incr("robustness.skipped_steps")
            _log.warning("sentinel: non-finite step skipped on device (streak %d/%d)",
                         self._skip_streak, self.skip_limit)
            if self._skip_streak >= self.skip_limit:
                return self._diverged(f"skip streak {self._skip_streak}")
            return "skip"
        self._skip_streak = 0
        if not math.isfinite(cost):
            # healthy but a non-finite cost: only with the device half off,
            # so nothing protected the parameters
            self.total_skipped += 1
            self._stats.incr("robustness.skipped_steps")
            return self._diverged("non-finite cost with device half off")
        if (self.ema is not None and self._n_obs > self.warmup_steps
                and cost > self.min_spike_cost and cost > self.spike_factor * self.ema):
            self._spike_streak += 1
            self.total_spikes += 1
            self._stats.incr("robustness.loss_spikes")
            _log.warning("sentinel: loss spike %.6g vs EMA %.6g (streak %d/%d)", cost,
                         self.ema, self._spike_streak, self.spike_patience)
            if self._spike_streak >= self.spike_patience:
                return self._diverged(f"loss spike streak {self._spike_streak}")
            # a spike must not drag the EMA towards itself
            return "ok"
        self._spike_streak = 0
        self.ema = cost if self.ema is None else (
            self.ema_decay * self.ema + (1.0 - self.ema_decay) * cost)
        self._stats.observe("robustness.loss_ema", self.ema)
        return "ok"

    def _diverged(self, why: str) -> str:
        """Declare divergence; the obs flight recorder dumps the last span
        events first, so the postmortem shows what led into the incident
        before a rollback erases it."""
        from paddle_tpu_torch import obs as _obs

        _log.error("sentinel: divergence declared (%s)", why)
        _obs.flight_dump(f"sentinel-divergence: {why}")
        return "diverged"

    @classmethod
    def from_flags(cls, stats=None) -> "DivergenceSentinel":
        from paddle_tpu_torch.utils import flags as _flags

        return cls(
            skip_limit=_flags.get_flag("sentinel_skip_limit"),
            ema_decay=_flags.get_flag("sentinel_ema_decay"),
            spike_factor=_flags.get_flag("sentinel_spike_factor"),
            spike_patience=_flags.get_flag("sentinel_spike_patience"),
            stats=stats,
        )
