"""Metrics: counters, gauges, histograms and meters in a scoped group
hierarchy, exported as Prometheus text (``MetricRegistry.to_prometheus``)
or served at /metrics by ``MetricsServer`` on ``metrics.port`` (0, the
default, serves nothing). The driver registers its records in/out,
fired windows, loss counters, events/s meter, fire-to-sink latency
histogram, watermark lag and its operators' planned device bytes.
"""
from __future__ import annotations

import http.server
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.config import MetricsOptions

METRICS_PORT = MetricsOptions.PORT
METRICS_BIND = MetricsOptions.BIND


# The primitives' WRITE paths are lock-guarded: host-pool worker
# threads (parallel/hostpool.py), the drain thread, and the scrape
# thread all hit one registry, and `self._v += n` / reservoir writes
# are read-modify-write races without it. Reads stay lock-free — a
# scrape observing a value one update stale is fine; losing updates
# is not.
class Counter:
    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._fn = fn
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._v


class Histogram:
    """Fixed-reservoir histogram (ref: DescriptiveStatisticsHistogram) —
    keeps the last ``size`` samples; quantiles computed on demand."""

    def __init__(self, size: int = 1024) -> None:
        self._buf = np.zeros(size, np.float64)
        self._n = 0
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = v
            self._n += 1

    def _samples(self) -> np.ndarray:
        return self._buf[: min(self._n, len(self._buf))]

    def quantile(self, q: float) -> float:
        s = self._samples()
        return float(np.quantile(s, q)) if len(s) else 0.0

    def quantile_recent(self, q: float, window: int = 32) -> float:
        """Quantile over the newest ``window`` samples — control loops
        (the batch debloater) steer on recent behavior, not the whole
        reservoir's history."""
        n = min(self._n, len(self._buf), window)
        if n == 0:
            return 0.0
        ix = (np.arange(self._n - n, self._n)) % len(self._buf)
        return float(np.quantile(self._buf[ix], q))

    @property
    def count(self) -> int:
        return self._n

    @property
    def mean(self) -> float:
        s = self._samples()
        return float(s.mean()) if len(s) else 0.0


class Meter:
    """Events per second over a sliding minute (ref: MeterView)."""

    def __init__(self) -> None:
        self._events: List[Tuple[float, int]] = []
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        now = time.time()
        with self._lock:
            self._events.append((now, n))
            cut = now - 60
            while self._events and self._events[0][0] < cut:
                self._events.pop(0)

    @property
    def rate(self) -> float:
        with self._lock:  # a concurrent mark() pops the head this reads
            if not self._events:
                return 0.0
            span = max(time.time() - self._events[0][0], 1e-9)
            return sum(n for _, n in self._events) / span


class MetricGroup:
    """Scope-named registry node (ref: MetricGroup addGroup/counter)."""

    def __init__(self, registry: "MetricRegistry", scope: Tuple[str, ...]):
        self._registry = registry
        self._scope = scope

    def _register(self, name: str, metric: Any) -> Any:
        self._registry.register(self._scope + (name,), metric)
        return metric

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter())

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._register(name, Gauge(fn))

    def histogram(self, name: str, size: int = 1024) -> Histogram:
        return self._register(name, Histogram(size))

    def meter(self, name: str) -> Meter:
        return self._register(name, Meter())


class MetricRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, ...], Any] = {}

    def group(self, *scope: str) -> MetricGroup:
        return MetricGroup(self, tuple(scope))

    def register(self, scope: Tuple[str, ...], metric: Any) -> None:
        self._metrics[scope] = metric

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for scope, m in self._metrics.items():
            key = ".".join(scope)
            if isinstance(m, Counter):
                out[key] = m.value
            elif isinstance(m, Gauge):
                out[key] = m.value
            elif isinstance(m, Meter):
                out[key] = m.rate
            elif isinstance(m, Histogram):
                out[key + ".p50"] = m.quantile(0.5)
                out[key + ".p90"] = m.quantile(0.9)
                out[key + ".p99"] = m.quantile(0.99)
                out[key + ".max"] = m.quantile(1.0)
                out[key + ".mean"] = m.mean
                out[key + ".count"] = m.count
        return out

    def to_prometheus(self) -> str:
        """Prometheus exposition text (ref: flink-metrics-prometheus
        PrometheusReporter serialization)."""
        lines = []
        for key, v in sorted(self.snapshot().items()):
            name = "flink_tpu_" + key.replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(v)}")
        return "\n".join(lines) + "\n"


class MetricsServer:
    """Minimal /metrics HTTP endpoint (pull model)."""

    def __init__(self, registry: MetricRegistry, port: int,
                 bind: str = "127.0.0.1") -> None:
        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = reg.to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence
                pass

        self._httpd = http.server.ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop serving and release the port: a restarted attempt binds
        it again at once."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
