"""Key-path schema for the coordination store (a copy of the JAX
package's ``cluster/paths.py``): ``/edl_tpu/<job_id>/<table>/<key>``."""

from edl_tpu_torch.utils.constants import ROOT


def job_prefix(job_id: str) -> str:
    return f"{ROOT}/{job_id}"


def table_prefix(job_id: str, table: str) -> str:
    return f"{ROOT}/{job_id}/{table}/"


def key(job_id: str, table: str, name: str) -> str:
    return f"{ROOT}/{job_id}/{table}/{name}"
