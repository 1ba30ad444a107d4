"""Elastic LM serving gateway (the port of the JAX package's ``gateway``).

LM replicas (:class:`edl_tpu_torch.serving.replica.ReplicaServer`) keep
TTL-leased adverts with live load stats in the coordination store; the
:class:`~edl_tpu_torch.gateway.gateway.Gateway` watches that fleet, routes
each generate request least-loaded (session affinity over the
consistent-hash ring and migration pins), applies admission control
(bounded queue + token bucket), hedges requests stuck past a deadline, and
replays a request whose replica died, so accepted work survives replica
churn.
"""

from edl_tpu_torch.gateway.fleet import FleetView, advertise, list_replicas
from edl_tpu_torch.gateway.gateway import Gateway, GatewayConfig, GatewayServer

__all__ = ["Gateway", "GatewayConfig", "GatewayServer", "FleetView", "advertise",
           "list_replicas"]
