"""paddle.v2.plot parity — training-curve plotting (reference:
python/paddle/v2/plot/plot.py Ploter/PlotData); a copy of ``paddle_tpu/plot.py``.

The data model is identical (named series of (step, value)); rendering uses
matplotlib when importable and not disabled via DISABLE_PLOT=True, else the
Ploter degrades to a silent recorder so headless training scripts run
unchanged."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

__all__ = ["Ploter", "PlotData"]


class PlotData:
    def __init__(self) -> None:
        self.step: List[int] = []
        self.value: List[float] = []

    def append(self, step: int, value: float) -> None:
        self.step.append(step)
        self.value.append(value)

    def reset(self) -> None:
        self.step = []
        self.value = []


class Ploter:
    """::

        ploter = Ploter("train", "test")
        ploter.append("train", step, cost)
        ploter.plot("curve.png")
    """

    def __init__(self, *titles: str):
        self.__args__ = titles
        self.__plot_data__: Dict[str, PlotData] = {t: PlotData() for t in titles}
        self._disabled = os.environ.get("DISABLE_PLOT") == "True"
        self._plt = None
        if not self._disabled:
            try:
                import sys

                import matplotlib

                if (
                    not os.environ.get("DISPLAY")
                    and "matplotlib.pyplot" not in sys.modules
                ):
                    # headless AND nothing rendered yet: choose Agg; never
                    # switch a backend a notebook/session already activated
                    matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                self._plt = plt
            except ImportError:
                self._disabled = True

    def append(self, title: str, step: int, value: float) -> None:
        self.__plot_data__[title].append(step, float(value))

    def data(self, title: str) -> PlotData:
        return self.__plot_data__[title]

    def plot(self, path: Optional[str] = None) -> None:
        """Render all series; with `path` writes an image file (headless),
        without it shows the interactive figure when a display exists."""
        if self._disabled or self._plt is None:
            return
        plt = self._plt
        plt.figure()
        titles = []
        for title in self.__args__:
            d = self.__plot_data__[title]
            if len(d.step) > 0:
                plt.plot(d.step, d.value, label=title)
                titles.append(title)
        if titles:
            plt.legend()
        plt.xlabel("step")
        if path is not None:
            plt.savefig(path)
            plt.close()
        else:  # pragma: no cover - needs a display
            plt.show()

    def reset(self) -> None:
        for d in self.__plot_data__.values():
            d.reset()
