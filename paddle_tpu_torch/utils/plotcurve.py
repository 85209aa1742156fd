"""Plot training/testing curves from a trainer log — the
``python -m paddle.utils.plotcurve`` tool (reference:
python/paddle/utils/plotcurve.py; the demo train.sh scripts pipe their
training log straight into it); a copy of ``paddle_tpu/utils/plotcurve.py``.

Reads a log from a file or stdin, extracts ``key=value``-style metrics from
pass/batch lines (both this package's CLI output and the reference's
``AvgCost`` style), and writes a matplotlib PNG (or, without matplotlib, a
plain-text table).

usage: python -m paddle_tpu_torch.utils.plotcurve -i train.log -o plot.png [key ...]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List

# "Pass 3: mean cost 0.123456" (the JAX package's cli) / "AvgCost=0.123" (reference
# logs) / "cost 0.123" mid-line
_PATTERNS = (
    re.compile(r"Pass\s+(?P<p>\d+):\s+mean\s+(?P<key>\w+)\s+(?P<v>[-\d.eE]+)"),
    re.compile(r"(?P<key>[A-Za-z_][\w/]*)=(?P<v>-?\d+\.?\d*(?:[eE][-+]?\d+)?)"),
    re.compile(r"\b(?P<key>cost)\s+(?P<v>-?\d+\.\d+)"),
)


def parse_log(lines) -> Dict[str, List[float]]:
    curves: Dict[str, List[float]] = {}
    for line in lines:
        for pat in _PATTERNS:
            for m in pat.finditer(line):
                try:
                    v = float(m.group("v"))
                except ValueError:
                    continue
                curves.setdefault(m.group("key"), []).append(v)
            if pat.search(line):
                break
    return curves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Plot training curves from a paddle-tpu/paddle log."
    )
    ap.add_argument("-i", "--input", default=None,
                    help="log file (default: stdin)")
    ap.add_argument("-o", "--output", default=None,
                    help="output PNG (default: stdout text table)")
    ap.add_argument("--format", default="png")
    ap.add_argument("key", nargs="*",
                    help="metric keys to plot (default: every cost-like key)")
    args = ap.parse_args(argv)

    lines = open(args.input) if args.input else sys.stdin
    curves = parse_log(lines)
    if args.input:
        lines.close()
    keys = args.key or [
        k for k in curves if "cost" in k.lower()
    ] or sorted(curves)
    keys = [k for k in keys if curves.get(k)]
    if not keys:
        print("no metrics found in log", file=sys.stderr)
        return 1

    if args.output:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; writing text table", file=sys.stderr)
        else:
            fig, ax = plt.subplots()
            for k in keys:
                ax.plot(curves[k], label=k)
            ax.set_xlabel("record")
            ax.legend()
            fig.savefig(args.output, format=args.format)
            print(f"wrote {args.output}")
            return 0
    for k in keys:
        vals = curves[k]
        print(f"{k}: n={len(vals)} first={vals[0]:.6g} last={vals[-1]:.6g} "
              f"min={min(vals):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
