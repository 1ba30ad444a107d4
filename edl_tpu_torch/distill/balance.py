"""Where teachers advertise themselves in the coordination store: the
root and key layout of the JAX package's ``distill/balance.py`` (its
balance table, which assigns teachers to students, is not ported).

A teacher registers under ``/edl_tpu_distill/<service>/nodes/<endpoint>``
on a TTL lease, so the JAX package's discovery servers see it.
"""

DISTILL_ROOT = "/edl_tpu_distill"


def server_key(service: str, endpoint: str) -> str:
    return f"{DISTILL_ROOT}/{service}/nodes/{endpoint}"
