"""Coordination-store names the cluster model uses (copies of the JAX
package's ``utils/constants.py`` and ``cluster/paths.py`` entries)."""

ROOT = "/edl_tpu"                   # a job's state lives under ROOT/<job_id>/<table>/
ETCD_POD_RANK = "rank"              # leader seat lives at rank/0
ETCD_STATE = "state"                # train State (data checkpoint etc.)
LEADER_KEY = "0"                    # rank table key seized by the leader


def key(job_id: str, table: str, name: str) -> str:
    return f"{ROOT}/{job_id}/{table}/{name}"
