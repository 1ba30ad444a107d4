"""/metrics exposition: a tiny stdlib HTTP endpoint over a Registry (a
copy of the JAX package's ``obs/exposition.py`` on the port's
``utils/network.py``).

Pull-model exposition (the Borg/Kubernetes-lineage convention): every
process serves its own registry; the scraper joins series across
processes by target.  CLI entry points (and :class:`ElasticTrainer`)
enable it the same way ``utils.logger.configure`` installs handlers —
opt-in via :func:`serve_from_env` (``EDL_TPU_METRICS_PORT``), never at
import time.

``EDL_TPU_METRICS_PORT=0`` binds an OS-assigned free port — the
multi-process-per-host default (launcher + N trainers can't share an
explicit port); the advertised host comes from ``utils.network``'s
``local_ip`` (``EDL_TPU_HOST_IP``, else the loopback address).  Set ``EDL_TPU_METRICS_DIR`` to have
each process
drop a ``metrics-<component>-<pid>.addr`` file with its ``host:port``,
so harnesses and scrapers can discover auto-picked ports.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from edl_tpu_torch.obs.metrics import REGISTRY, Registry
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# process-wide extra GET routes on the /metrics endpoint: path ->
# fn(query: dict[str, str]) -> JSON-able dict.  The profiler capture
# (obs/profile.py) mounts "/profile" here, so the endpoint every
# process already advertises in the coord store is also the surface
# alert actions and operators hit for an on-demand capture — no second
# server, no second advert.  Registered lazily at runtime; the handler
# consults the dict per request, so routes added after the server
# started (the trainer builds its ledger after install_from_env) work.
_routes: dict[str, object] = {}


def register_route(path: str, fn) -> None:
    """Serve ``fn(query)`` as JSON at ``path`` on this process's
    metrics endpoint(s).  Last registration per path wins."""
    _routes[path] = fn


def unregister_route(path: str) -> None:
    _routes.pop(path, None)


# observers of every served /metrics page: ``fn(text)`` runs after a
# scrape renders, so the flight recorder (obs/flightrec.py) can keep
# the LAST-SCRAPED exposition — what the aggregator actually saw —
# without a second render.  Same registration pattern as _routes.
_scrape_observers: list = []


def observe_scrapes(fn) -> None:
    """Register ``fn(exposition_text)`` to see every served page."""
    if fn not in _scrape_observers:
        _scrape_observers.append(fn)


def unobserve_scrapes(fn) -> None:
    try:
        _scrape_observers.remove(fn)
    except ValueError:
        pass


def _notify_scrape(text: str) -> None:
    for fn in list(_scrape_observers):
        try:
            fn(text)
        except Exception:  # noqa: BLE001 — an observer must not fail a scrape
            logger.exception("scrape observer failed")


def parse_query(query: str) -> dict[str, str]:
    """Query string → last-value-wins flat dict — the one parser every
    route handler (here, the aggregator's /profile, obs/profile.py)
    shares, so target-side and aggregator-side parsing can't diverge."""
    return {k: v[-1] for k, v in urllib.parse.parse_qs(query).items()}


def query_float(q: dict, key: str, default: float = 0.0) -> float:
    """A float query param, tolerating absence and garbage."""
    try:
        return float(q.get(key, default) or default)
    except (TypeError, ValueError):
        return default


class MetricsServer:
    """Serve ``registry.render()`` at ``/metrics`` (and ``/``), plus
    any process-wide :func:`register_route` extras."""

    def __init__(self, registry: Registry | None = None,
                 host: str = "0.0.0.0", port: int = 0):
        reg = registry or REGISTRY

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                route = _routes.get(path)
                if route is not None:
                    try:
                        body = json.dumps(
                            route(parse_query(query))).encode("utf-8")
                        ctype = "application/json"
                    except Exception:  # noqa: BLE001 — a bad route != dead endpoint
                        logger.exception("route %s failed", path)
                        self.send_error(500)
                        return
                elif path in ("/metrics", "/"):
                    text = reg.render()
                    _notify_scrape(text)
                    body = text.encode("utf-8")
                    ctype = CONTENT_TYPE
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log lines
                pass

        self.registry = reg
        # port 0 = OS-assigned ephemeral port, atomically (no probe race);
        # server_address[1] reports the bound port
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        host = self._httpd.server_address[0]
        if host in ("0.0.0.0", ""):
            host = local_ip()
        return f"{host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"metrics:{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_install_lock = threading.Lock()
_server: MetricsServer | None = None


def installed_server() -> MetricsServer | None:
    return _server


def shutdown_installed() -> None:
    """Stop the process-wide endpoint :func:`serve_from_env` started, so a
    later call starts a new one (harnesses that run several jobs in one
    process; idempotent)."""
    global _server
    with _install_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def serve_from_env(component: str = "edl",
                   registry: Registry | None = None) -> MetricsServer | None:
    """Start the process-wide /metrics endpoint if ``EDL_TPU_METRICS_PORT``
    is set (0 = auto free port); idempotent; never raises — metrics must
    never fail a job."""
    global _server
    port_s = os.environ.get("EDL_TPU_METRICS_PORT", "")
    if not port_s:
        return None
    with _install_lock:
        if _server is not None:
            return _server
        try:
            port = int(port_s)
        except ValueError:
            logger.warning("EDL_TPU_METRICS_PORT=%r is not an int; "
                           "metrics endpoint disabled", port_s)
            return None
        if port < 0:
            return None
        try:
            try:
                srv = MetricsServer(registry, port=port).start()
            except OSError:
                if port == 0:
                    raise
                # explicit port busy (several processes per host): serve
                # anyway on a free port — an addr file still locates it
                logger.warning("metrics port %d busy; falling back to a "
                               "free port", port)
                srv = MetricsServer(registry, port=0).start()
        except Exception:  # noqa: BLE001 — metrics must never fail a job
            logger.exception("metrics endpoint failed to start")
            return None
        _server = srv
    addr_dir = os.environ.get("EDL_TPU_METRICS_DIR")
    if addr_dir:
        try:
            os.makedirs(addr_dir, exist_ok=True)
            path = os.path.join(addr_dir,
                                f"metrics-{component}-{os.getpid()}.addr")
            with open(path, "w") as f:
                f.write(srv.endpoint + "\n")
        except OSError:
            logger.exception("could not write metrics addr file")
    logger.info("metrics: serving /metrics on %s", srv.endpoint)
    return srv
