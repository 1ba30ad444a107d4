"""Discovery service: the register and heartbeat RPCs, and the
student-side client (the port of the JAX package's ``distill/discovery.py``,
speaking its wire, so a port student works against a JAX discovery server
and the other way round).

Reference: discovery_server.py (105) + discovery_client.py (268).
Server = a BalanceTable behind the EDL1 RPC wire, self-registered in
the coordination store under ``__balance__`` so peers form the redirect
ring.  Client = register, then a 2 s heartbeat thread maintaining a
versioned teacher list; it handles OK / NO_READY / REDIRECT /
UNREGISTERED (discovery_client.py:70-142).

Not ported: a discovery server whose ring advert rides a caller's shared
``CoordSession`` (``session=`` raises; ROADMAP.md Queue 1 item 6.4, with
the distillation fleet).
"""

from __future__ import annotations

import logging
import os
import threading
import uuid

from edl_tpu_torch.coord.register import leased_register
from edl_tpu_torch.distill.balance import (
    BALANCE_SERVICE, OK, REDIRECT, UNREGISTERED, BalanceTable, server_key,
)
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.network import local_ip

logger = logging.getLogger(__name__)


class DiscoveryServer:
    """``python -m edl_tpu_torch.distill.discovery --coord_endpoints ...``.
    A server built without a ``host`` advertises the interface that routes
    to the store."""

    def __init__(self, store, host: str | None = None, port: int = 0,
                 ttl: float | None = None, client_ttl: float | None = None,
                 session=None):
        if session is not None:
            raise NotImplementedError("a DiscoveryServer on a shared CoordSession is not "
                                      "ported yet (ROADMAP.md Queue 1 item 6.4, with the "
                                      "distillation fleet)")
        host = host or local_ip(getattr(store, "endpoint", None))
        self._rpc = RpcServer(host="0.0.0.0", port=port)
        self.endpoint = f"{host}:{self._rpc.port}"
        table_kw = {"client_ttl": client_ttl} if client_ttl else {}
        self._table = BalanceTable(store, self.endpoint, **table_kw)
        self._rpc.register("register", self._table.register_client)
        self._rpc.register("heartbeat", self._table.heartbeat)
        self._rpc.register("unregister", self._table.unregister_client)
        self._rpc.start()
        self._register = leased_register(
            store, server_key(BALANCE_SERVICE, self.endpoint), self.endpoint.encode(),
            ttl=ttl or constants.etcd_ttl())
        logger.info("discovery server on %s", self.endpoint)

    def stop(self) -> None:
        self._register.stop()
        self._table.close()
        self._rpc.stop()


class DiscoveryClient:
    """Maintains the client's balanced teacher list."""

    def __init__(self, endpoints: str | list[str], service: str,
                 require_num: int = 1, heartbeat_period: float = 2.0):
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
        self._endpoints = endpoints
        self._service = service
        self._require = require_num
        self._period = heartbeat_period
        self.client_id = (f"{local_ip()}-{os.getpid()}-{id(self):x}-"
                          f"{uuid.uuid4().hex[:8]}")
        self._lock = threading.Lock()
        self._servers: list[str] = []
        self._version = -1
        self._halt = threading.Event()
        self._rpc: RpcClient | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"discovery:{service}")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DiscoveryClient":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=5.0)
        if self._rpc is not None:
            try:
                self._rpc.call("unregister", client_id=self.client_id,
                               service=self._service)
            except Exception as e:  # noqa: BLE001 — best effort
                logger.debug("unregister of %s failed (%s); the server's "
                             "client GC expires it", self.client_id, e)
            self._rpc.close()

    def servers(self) -> list[str]:
        with self._lock:
            return list(self._servers)

    # -- the loop ------------------------------------------------------------
    def _connect(self, endpoint: str) -> None:
        if self._rpc is not None:
            self._rpc.close()
        self._rpc = RpcClient(endpoint, timeout=10.0)

    def _run(self) -> None:
        ep_iter = 0
        registered = False
        while not self._halt.is_set():
            try:
                if self._rpc is None:
                    self._connect(self._endpoints[ep_iter % len(self._endpoints)])
                    ep_iter += 1
                if not registered:
                    r = self._rpc.call("register", client_id=self.client_id,
                                       service=self._service,
                                       require_num=self._require)
                    if r["code"] == REDIRECT:
                        self._follow_redirect(r)
                        continue
                    registered = r["code"] == OK
                    if not registered:
                        self._halt.wait(1.0)
                        continue
                r = self._rpc.call("heartbeat", client_id=self.client_id,
                                   service=self._service, version=self._version)
                code = r["code"]
                if code == REDIRECT:
                    self._follow_redirect(r)
                    registered = False
                    continue
                if code == UNREGISTERED:
                    registered = False
                    continue
                if code == OK and r.get("servers") is not None:
                    with self._lock:
                        self._servers = list(r["servers"])
                        self._version = r["version"]
                    logger.info("service %s v%d: teachers %s", self._service,
                                self._version, self._servers)
                # NO_READY: wait for the next beat
            except Exception as e:  # noqa: BLE001 — server churn
                logger.warning("discovery heartbeat failed: %s", e)
                if self._rpc is not None:
                    self._rpc.close()
                self._rpc = None
                registered = False
            self._halt.wait(self._period)

    def _follow_redirect(self, r: dict) -> None:
        owners = r.get("discovery_servers") or []
        if owners:
            logger.info("redirected to discovery server %s", owners[0])
            self._connect(owners[0])


def main(argv: list[str] | None = None) -> None:
    """``python -m edl_tpu_torch.distill.discovery`` (reference
    discovery_server.py:65-105 CLI): serve until SIGTERM or Ctrl-C."""
    import argparse
    import signal

    from edl_tpu_torch.coord.client import connect

    p = argparse.ArgumentParser("edl_tpu_torch.distill.discovery")
    p.add_argument("--coord_endpoints", required=True)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    store = connect(args.coord_endpoints)
    server = DiscoveryServer(store, host=args.host, port=args.port)
    print(f"[discovery] serving on {server.endpoint}", flush=True)
    halt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: halt.set())
    try:
        halt.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        store.close()


if __name__ == "__main__":
    main()
