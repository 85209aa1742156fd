"""Training events — the ``paddle.v2.event`` surface, a copy of
``paddle_tpu/event.py``."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Event:
    pass


class TestResult(Event):
    def __init__(self, evaluator: Dict[str, float], cost: float):
        self.evaluator = evaluator
        self.cost = cost

    @property
    def metrics(self) -> Dict[str, float]:
        return self.evaluator


class BeginPass(Event):
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(Event):
    def __init__(self, pass_id: int, evaluator: Optional[Dict[str, float]] = None):
        self.pass_id = pass_id
        self.evaluator = evaluator or {}


class BeginIteration(Event):
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(Event):
    def __init__(
        self,
        pass_id: int,
        batch_id: int,
        cost: float,
        evaluator: Optional[Dict[str, float]] = None,
    ):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.evaluator = evaluator or {}

    @property
    def metrics(self) -> Dict[str, Any]:
        return self.evaluator
