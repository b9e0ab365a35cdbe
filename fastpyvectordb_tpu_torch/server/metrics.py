"""Prometheus-text request metrics for the serving layer.

The reference exposes only ``/health`` and a per-response ``took_ms``
(server.py:70-83); production serving wants scrapeable counters.  This is
a dependency-free registry (no prometheus_client in the image) rendering
the standard exposition format: request counts and latency histograms per
(route, method, status), plus engine-level gauges the handler layer can
set (collection count, resident rows).

Wired by ``server/app.py`` as a middleware + a ``/metrics`` route; the
shard router (server/router.py) reuses it unchanged.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Tuple

# upper bounds in seconds; +Inf is implicit
BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
           1.0, 2.5, 5.0, 10.0)


class Metrics:
    """Thread-safe request counters + latency histograms + gauges."""

    def __init__(self, namespace: str = "fpvt"):
        self.ns = namespace
        self._lock = threading.Lock()
        self._count: Dict[Tuple[str, str, int], int] = defaultdict(int)
        self._sum: Dict[Tuple[str, str], float] = defaultdict(float)
        self._hist: Dict[Tuple[str, str], list] = {}
        self._gauges: Dict[str, float] = {}

    def observe(self, route: str, method: str, status: int,
                seconds: float) -> None:
        with self._lock:
            self._count[(route, method, status)] += 1
            key = (route, method)
            self._sum[key] += seconds
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0] * (len(BUCKETS) + 1)
            for i, ub in enumerate(BUCKETS):
                if seconds <= ub:
                    h[i] += 1
                    break
            else:
                h[-1] += 1

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def render(self) -> str:
        """Prometheus exposition format (text/plain; version=0.0.4)."""
        ns = self.ns
        out = []
        with self._lock:
            out.append(f"# HELP {ns}_requests_total HTTP requests served\n"
                       f"# TYPE {ns}_requests_total counter\n")
            for (route, method, status), n in sorted(self._count.items()):
                out.append(
                    f'{ns}_requests_total{{route="{route}",'
                    f'method="{method}",status="{status}"}} {n}\n')
            out.append(
                f"# HELP {ns}_request_seconds request latency histogram\n"
                f"# TYPE {ns}_request_seconds histogram\n")
            for (route, method), h in sorted(self._hist.items()):
                acc = 0
                lab = f'route="{route}",method="{method}"'
                for i, ub in enumerate(BUCKETS):
                    acc += h[i]
                    out.append(f'{ns}_request_seconds_bucket{{{lab},'
                               f'le="{ub}"}} {acc}\n')
                acc += h[-1]
                out.append(f'{ns}_request_seconds_bucket{{{lab},'
                           f'le="+Inf"}} {acc}\n')
                out.append(f'{ns}_request_seconds_sum{{{lab}}} '
                           f'{self._sum[(route, method)]:.6f}\n')
                out.append(f'{ns}_request_seconds_count{{{lab}}} {acc}\n')
            for name, v in sorted(self._gauges.items()):
                out.append(f"# TYPE {ns}_{name} gauge\n")
                out.append(f"{ns}_{name} {v}\n")
        return "".join(out)


def install(app, metrics: Metrics, *, gauge_hook=None) -> None:
    """Attach the counting middleware and the /metrics route to an aiohttp
    app.  ``gauge_hook(metrics)`` (optional) refreshes engine gauges on
    each scrape."""
    import time

    from aiohttp import web

    @web.middleware
    async def _mw(request, handler):
        t0 = time.perf_counter()
        status = 500
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            # unmatched paths collapse to one label: raw request.path
            # would give scanners unbounded label cardinality (and
            # unbounded registry memory)
            res = request.match_info.route.resource
            route = res.canonical if res is not None else "<unmatched>"

            metrics.observe(route, request.method, status,
                            time.perf_counter() - t0)

    async def _metrics(request):
        if gauge_hook is not None:
            gauge_hook(metrics)
        return web.Response(text=metrics.render(),
                            content_type="text/plain")

    app.middlewares.append(_mw)
    app.router.add_get("/metrics", _metrics)
