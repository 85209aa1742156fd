"""Serving requests — the ``Request`` record of ``paddle_tpu/serving/scheduler.py``
(:138) with its id counter.

Not ported yet: ``ServingScheduler`` (the request queue, the step thread and
the SLO plane), and with it the scheduler's half of ``Request`` (``done``,
``wait``, ``result``, ``callback``, deadlines, priorities and statuses);
``paddle_tpu_torch.serving`` raises ``NotImplementedError`` naming it when
it is asked for.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

_req_counter = itertools.count()


class Request:
    """One generation request and its result and latency record.

    ``src_ids``: source token ids; ``max_new_tokens``: per-request decode
    cap (None = the engine's default); ``beam_size`` > 1 asks for per-request
    beam serving (not ported yet: the engine raises).  The engine stamps
    ``t_admit``, ``t_first_token`` and one ``token_times`` entry per
    generated token with its clock (and its log-probability in
    ``token_logprobs``), and sets ``tokens`` when the request finishes;
    ``_resume`` holds its preemption save-state."""

    def __init__(
        self,
        src_ids: Sequence,
        max_new_tokens: Optional[int] = None,
        req_id: Optional[str] = None,
        beam_size: Optional[int] = None,
    ):
        self.req_id = req_id if req_id is not None else f"r{next(_req_counter)}"
        self.src_ids = list(src_ids)
        self.max_new_tokens = max_new_tokens
        self.beam_size = beam_size
        self.tokens: Optional[List[int]] = None
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.token_times: List[float] = []
        # the log-probability of each generated token under the decode chain
        # (the port's addition; chip_smoke.py holds it to the one-shot path's)
        self.token_logprobs: List[float] = []
        self._resume = None  # engine preemption save-state

    def __repr__(self) -> str:  # pragma: no cover
        return f"Request({self.req_id}, tokens={self.tokens})"
