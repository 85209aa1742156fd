"""Metrics export — StatSet + SLO gauges in Prometheus text format.

The reference prints its ``StatSet`` table per ``log_period``
(TrainerInternal.cpp:443); that surface stays, but a table scraped from
a log is not a production metrics plane.  This module renders the same
aggregates — plus live **gauges** for the serving SLO variables the
production gate asserts on (serving queue depth, pages in use, EWMA
predicted queue wait, the served/shed/rejected/timeout ledger) — in the
Prometheus text exposition format, periodically snapshotted to a file
(atomic replace) and/or served on a localhost HTTP endpoint.  The gated
quantities become observable LIVE, not only in the post-run summary.

Gauges are callbacks: a plane that owns an SLO variable registers
``register_gauge(name, fn, help)`` (the serving scheduler does this on
construction and unregisters on close); the exporter polls them at
render time and skips any that raise — a crashing gauge must never take
the exporter down.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.analysis.lock_sanitizer import THREAD_PREFIX, make_lock

__all__ = [
    "register_gauge",
    "unregister_gauge",
    "render_prometheus",
    "MetricsExporter",
]

_log = logging.getLogger("paddle_tpu_torch.obs")


def _series_key(name: str, labels) -> str:
    """The exposition line's series id: ``family`` bare, or
    ``family{k="v",...}`` with labels sorted (one canonical key per
    label set, so register/unregister pairs always meet)."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return f"{name}{{{inner}}}"


class _GaugeRegistry:
    """Process-wide named gauge callbacks (guarded; reads snapshot)."""

    def __init__(self) -> None:
        self._lock = make_lock("obs-gauges")
        # series key -> (fn, help, family name)
        self._gauges: Dict[str, Tuple[Callable[[], float], str, str]] = {}

    def register(self, name: str, fn: Callable[[], float],
                 help_: str = "", labels=None) -> None:
        """Latest registration wins (a newer scheduler instance takes the
        name over); keep the returned ``fn`` to unregister safely.
        ``labels`` (dict) makes a LABELED series of the ``name`` family —
        the fleet router registers one series per engine
        (``engine="..."``); HELP/TYPE render once per family."""
        with self._lock:
            self._gauges[_series_key(name, labels)] = (fn, help_, name)

    def unregister(self, name: str, fn: Optional[Callable] = None,
                   labels=None) -> None:
        """Remove a gauge — but only if ``fn`` (when given) is still the
        registered callback: a closed older instance must not tear down
        the gauge a newer instance re-registered under the same name."""
        key = _series_key(name, labels)
        with self._lock:
            if fn is not None and self._gauges.get(key, (None,))[0] is not fn:
                return
            self._gauges.pop(key, None)

    def snapshot(self) -> Dict[str, Tuple[Callable[[], float], str, str]]:
        with self._lock:
            return dict(self._gauges)


_registry = _GaugeRegistry()
register_gauge = _registry.register
unregister_gauge = _registry.unregister


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# StatSet counters -> first-class serving ledger statuses (the disjoint
# categories serving.status_counts reports)
_LEDGER = (
    ("served", "serving/completed"),
    ("shed", "serving/shed"),
    ("rejected", "serving/rejected"),
    ("timeout", "serving/timeout"),
)

# the router-tier ledger (serving/router.py increments fleet/<status>):
# same disjoint categories, distinct StatSet names — a process hosting
# BOTH a router and an engine reports each tier's counts once
_FLEET_LEDGER = (
    ("served", "fleet/served"),
    ("shed", "fleet/shed"),
    ("rejected", "fleet/rejected"),
    ("timeout", "fleet/timeout"),
)


def render_prometheus(stats=None) -> str:
    """The full exposition: registered gauges, the serving ledger, and
    the generic StatSet aggregates (count/total/avg/max per stat, stat
    name as a label — names like ``lock_held/<x>`` stay intact)."""
    if stats is None:
        from paddle_tpu_torch.utils.timers import global_stats as stats
    summary = stats.summary()
    lines: List[str] = []

    seen_families = set()
    for key, (fn, help_, family) in sorted(_registry.snapshot().items()):
        try:
            value = float(fn())
        except Exception:  # noqa: BLE001 — a dead gauge must not kill export
            continue
        if family not in seen_families:
            # HELP/TYPE once per FAMILY: labeled series (the router's
            # per-engine gauges) share one header like any exporter's
            seen_families.add(family)
            if help_:
                lines.append(f"# HELP {family} {help_}")
            lines.append(f"# TYPE {family} gauge")
        lines.append(f"{key} {value}")

    lines.append(
        "# HELP paddle_tpu_serving_requests_total finalized serving "
        "requests by disjoint terminal status"
    )
    lines.append("# TYPE paddle_tpu_serving_requests_total counter")
    for status, stat in _LEDGER:
        count = summary.get(stat, {}).get("count", 0)
        lines.append(
            f'paddle_tpu_serving_requests_total{{status="{status}"}} '
            f"{int(count)}"
        )
    # the per-class ledger: the scheduler increments
    # serving/class/<class>/<status> on every finalization (ALL
    # statuses, served included) — rendered as class-labeled series of
    # the same family, labels sorted (class before status) like every
    # series key this module emits
    for name in sorted(summary):
        parts = name.split("/")
        if (len(parts) == 4 and parts[0] == "serving"
                and parts[1] == "class"):
            cls, status = parts[2], parts[3]
            lines.append(
                "paddle_tpu_serving_requests_total"
                f'{{class="{_escape(cls)}",status="{_escape(status)}"}} '
                f"{int(summary[name]['count'])}"
            )

    lines.append(
        "# HELP paddle_tpu_fleet_requests_total requests finalized by the "
        "fleet router, by disjoint terminal status (serving/router.py — "
        "distinct from the per-engine serving ledger so an in-process "
        "fleet never double-counts)"
    )
    lines.append("# TYPE paddle_tpu_fleet_requests_total counter")
    for status, stat in _FLEET_LEDGER:
        count = summary.get(stat, {}).get("count", 0)
        lines.append(
            f'paddle_tpu_fleet_requests_total{{status="{status}"}} '
            f"{int(count)}"
        )

    lines.append(
        "# HELP paddle_tpu_stat_count StatSet event count per stat "
        "(utils/timers.py — the REGISTER_TIMER plane)"
    )
    lines.append("# TYPE paddle_tpu_stat_count counter")
    for name in sorted(summary):
        lines.append(
            f'paddle_tpu_stat_count{{name="{_escape(name)}"}} '
            f"{int(summary[name]['count'])}"
        )
    for field, kind in (("total", "counter"), ("avg", "gauge"),
                        ("max", "gauge")):
        lines.append(f"# TYPE paddle_tpu_stat_{field} {kind}")
        for name in sorted(summary):
            lines.append(
                f'paddle_tpu_stat_{field}{{name="{_escape(name)}"}} '
                f"{summary[name][field]}"
            )
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Periodic exposition writer + optional localhost HTTP endpoint.

    ``path``: write the exposition there every ``period_s`` seconds
    (tmp + atomic replace — a scraper never reads a torn file);
    ``port``: also serve GET /metrics on 127.0.0.1 (0 picks a free
    port, exposed as ``self.port``).  The port and the period default
    to the ``metrics_port`` / ``metrics_period_s`` flags; the file is
    written only when ``path`` is given.
    ``close()`` stops the writer thread and the HTTP server."""

    def __init__(
        self,
        path: Optional[str] = None,
        port: Optional[int] = None,
        period_s: Optional[float] = None,
        stats=None,
    ):
        from paddle_tpu_torch.utils import flags as _flags

        self._stats = stats
        self.path = path or ""
        self.period_s = float(
            period_s if period_s is not None
            else _flags.get_flag("metrics_period_s")
        )
        # an EXPLICIT port=0 argument means "pick a free port" (tests);
        # the metrics_port flag's default 0 means "no endpoint"; an
        # explicit NEGATIVE port forces the endpoint OFF even when the
        # flag/env would arm it (the CLI's `--metrics-port 0` contract)
        explicit_port = port is not None
        if port is None:
            port = _flags.get_flag("metrics_port")
        if explicit_port and int(port) < 0:
            explicit_port, port = False, 0
        self._stop = threading.Event()
        self._httpd = None
        self._http_thread = None
        self._writer_thread = None
        self.port: Optional[int] = None
        if int(port) > 0 or (explicit_port and int(port) == 0):
            self._start_http(int(port))
        if self.path:
            self._writer_thread = threading.Thread(
                target=self._write_loop,
                name=THREAD_PREFIX + "obs-metrics",
                daemon=True,
            )
            self._writer_thread.start()

    # -- file sink -------------------------------------------------------
    def write_once(self) -> bool:
        if not self.path:
            return False
        text = render_prometheus(self._stats)
        try:
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)
            return True
        except OSError as exc:
            _log.warning("metrics_out %s unwritable: %s", self.path, exc)
            return False

    def _write_loop(self) -> None:
        while not self._stop.wait(self.period_s):  # bounded: stop-aware
            self.write_once()
        self.write_once()  # final snapshot on close

    # -- http sink -------------------------------------------------------
    def _start_http(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render_prometheus(exporter._stats).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not log news
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=THREAD_PREFIX + "obs-http",
            daemon=True,
        )
        self._http_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._writer_thread is not None:
            self._writer_thread.join(timeout=5)
            self._writer_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
