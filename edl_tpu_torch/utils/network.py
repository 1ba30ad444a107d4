"""Socket helpers: a free-port finder, endpoint parsing and the address a
server advertises (from the JAX package's ``utils/network.py``)."""

from __future__ import annotations

import os
import socket
from contextlib import closing


def find_free_port() -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]


def split_endpoint(endpoint: str) -> tuple[str, int]:
    host, _, port = endpoint.rpartition(":")
    return host, int(port)


def _self_connectable(ip: str) -> bool:
    """Whether a listener bound to ``ip`` accepts a connection from here."""
    try:
        with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as srv:
            srv.bind((ip, 0))
            srv.listen(1)
            with closing(socket.create_connection(srv.getsockname(), timeout=1.0)):
                return True
    except OSError:
        return False


def local_ip(probe_endpoint: str | None = None) -> str:
    """The address a server advertises: ``EDL_TPU_HOST_IP`` when set; else
    the interface this host routes ``probe_endpoint`` (``host:port``, a
    peer the deployment already talks to, e.g. the coordination store)
    through, found by connecting a UDP socket (which sends nothing) and
    checked by a self-connect; else the loopback address.  Unlike the JAX
    package's, it probes no public address of its own choosing."""
    override = os.environ.get("EDL_TPU_HOST_IP", "")
    if override:
        return override
    if probe_endpoint:
        host, port = split_endpoint(probe_endpoint)
        try:
            with closing(socket.socket(socket.AF_INET, socket.SOCK_DGRAM)) as s:
                s.connect((host or "127.0.0.1", port))
                candidate = s.getsockname()[0]
            if _self_connectable(candidate):
                return candidate
        except OSError:
            pass
    return "127.0.0.1"
