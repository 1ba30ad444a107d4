"""The port's ``ElasticInput`` (``edl_tpu_torch/data/elastic_input.py``):

- at world 1, against the JAX package's on the same recordio files (written
  from a seed) and batch size, each under its own package's store, cluster
  record and DataService: the same batch count and mask vectors, the same
  multiset of records in each epoch, and the same merged spans;
- in a 2-rank gloo world spawned by hand (a 120 s limit on each process):
  the has-next agreement makes both ranks step equally often while their
  shares of the records differ, every record trains once, and
  ``sync_checkpoint`` leaves on both ranks the ``merge_span`` of the union
  of their spans."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from edl_tpu.cluster import paths as jpaths
from edl_tpu.cluster.cluster import Cluster as JCluster
from edl_tpu.cluster.pod import Pod as JPod
from edl_tpu.cluster.state import DataCheckpoint as JDataCheckpoint
from edl_tpu.coord.memory import MemoryKV as JMemoryKV
from edl_tpu.data import ElasticInput as JElasticInput
from edl_tpu.data import RecordioSplitter as JRecordioSplitter
from edl_tpu.data.data_server import DataService as JDataService
from edl_tpu.rpc.server import RpcServer as JRpcServer
from edl_tpu.utils import constants as jconstants
from edl_tpu_torch.cluster import paths
from edl_tpu_torch.cluster.cluster import Cluster
from edl_tpu_torch.cluster.pod import Pod
from edl_tpu_torch.cluster.state import DataCheckpoint
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.data.data_server import DataService
from edl_tpu_torch.data.dataset import RecordioSplitter
from edl_tpu_torch.data.elastic_input import SPANS_KEY, ElasticInput
from edl_tpu_torch.native.recordio import RecordWriter
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.spans import merge_span
from tests.helpers.exactly_once import audit_spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FILES, PER_FILE, BATCH = 3, 13, 8          # 39 records: 4 full batches and 7 rows


@pytest.fixture
def rec_files(tmp_path):
    rng = np.random.default_rng(3)
    out = []
    for f in range(N_FILES):
        path = str(tmp_path / f"train-{f:03d}.rec")
        with RecordWriter(path, use_native=False) as w:
            for r in range(PER_FILE):
                body = rng.integers(0, 256, int(rng.integers(8, 40)), dtype=np.uint8).tobytes()
                w.write(np.int32(100 * f + r).tobytes() + body)
        out.append(path)
    return out


def assemble(records: list) -> dict:
    return {"id": np.asarray([np.frombuffer(r[:4], np.int32)[0] for r in records], np.int32)
            .reshape(-1),
            "head": np.asarray([np.frombuffer(r[4:12], np.uint8) for r in records],
                               np.uint8).reshape(-1, 8)}


def _epochs(package, files):
    """Two epochs of one package's ElasticInput at world 1: per epoch, the
    masks, the real records' ids and the merged spans."""
    jax = package == "jax"
    store = (JMemoryKV if jax else MemoryKV)(sweep_period=0.1)
    srv = (JRpcServer if jax else RpcServer)("127.0.0.1", 0)
    srv.register_instance((JDataService if jax else DataService)())
    srv.start()
    cluster = (JCluster if jax else Cluster).from_pods(
        [(JPod if jax else Pod)("pod-a", addr="127.0.0.1", port=srv.port)])
    key = (jpaths.key("jei", jconstants.ETCD_CLUSTER, "cluster") if jax
           else paths.key("jei", constants.ETCD_CLUSTER, "cluster"))
    store.put(key, cluster.to_json().encode())
    ei = (JElasticInput if jax else ElasticInput)(
        store, "jei", "pod-a", "rec", files, BATCH,
        (JRecordioSplitter if jax else RecordioSplitter)(), assemble)
    out = []
    try:
        for epoch in range(2):
            ckpt = (JDataCheckpoint if jax else DataCheckpoint)()
            masks, ids = [], []
            for batch in ei.epoch(epoch, ckpt):
                for fi, b, e in batch.pop(SPANS_KEY):
                    ckpt.mark_processed(fi, b, e)
                masks.append(batch["mask"].tolist())
                ids += batch["id"][batch["mask"] > 0].tolist()
                assert batch["head"].shape == (BATCH, 8)
            out.append((masks, sorted(ids),
                        [[r.file_idx, r.begin, r.end] for r in ckpt.processed]))
    finally:
        ei.stop()
        srv.stop()
        store.close()
    return out


def test_world_one_matches_the_jax_elastic_input(rec_files):
    port, jax = _epochs("port", rec_files), _epochs("jax", rec_files)
    assert port == jax
    every = sorted(100 * f + r for f in range(N_FILES) for r in range(PER_FILE))
    for masks, ids, spans in port:
        assert ids == every
        assert [sum(m) for m in masks] == [8, 8, 8, 8, 7]
        assert sorted(spans) == [[f, 0, PER_FILE] for f in range(N_FILES)]


_RANK = r"""
import json, sys, time
import torch.distributed as dist
from edl_tpu_torch.cluster.state import DataCheckpoint
from edl_tpu_torch.coord.client import connect
from edl_tpu_torch.data.dataset import TxtFileSplitter
from edl_tpu_torch.data.elastic_input import SPANS_KEY, ElasticInput, sync_checkpoint
import numpy as np

rank, port, store_ep, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
files = sys.argv[5:]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
store = connect(store_ep)

def assemble(records):
    return {"f": np.asarray([int(r[1:r.index("r")]) for r in records], np.int32),
            "r": np.asarray([int(r[r.index("r") + 1:]) for r in records], np.int32)}

ei = ElasticInput(store, "jw2", f"pod-{rank}", "txt", files, 4, TxtFileSplitter(), assemble,
                  distributed=True)
ckpt = DataCheckpoint()
steps = []
for batch in ei.epoch(0, ckpt):
    spans = batch.pop(SPANS_KEY)
    for fi, b, e in spans:
        ckpt.mark_processed(fi, b, e)
    steps.append({"real": int(batch["mask"].sum()), "spans": spans})
    time.sleep(0.05 * (1 + 3 * rank))      # rank 1 consumes slower: ragged shares
local = [[r.file_idx, r.begin, r.end] for r in ckpt.processed]
sync_checkpoint(ckpt)
merged = [[r.file_idx, r.begin, r.end] for r in ckpt.processed]
ei.stop()
store.close()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump({"steps": steps, "local": local, "merged": merged}, f)
"""


def test_two_rank_agreement_and_checkpoint_merge(tmp_path, coord_client):
    from edl_tpu_torch.utils.network import find_free_port

    files = []
    for f in range(4):
        p = tmp_path / f"part-{f}.txt"
        p.write_text("".join(f"f{f}r{r}\n" for r in range(10)))
        files.append(str(p))
    srv = RpcServer("127.0.0.1", 0)
    srv.register_instance(DataService())
    srv.start()
    cluster = Cluster.from_pods([Pod("pod-0", addr="127.0.0.1", port=srv.port), Pod("pod-1")])
    coord_client.put(paths.key("jw2", constants.ETCD_CLUSTER, "cluster"),
                     cluster.to_json().encode())
    port = find_free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs, outs = [], []
    try:
        for rank in range(2):
            out = str(tmp_path / f"rank{rank}.json")
            log = open(tmp_path / f"rank{rank}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, str(rank), str(port), coord_client.endpoint,
                 out, *files], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
            outs.append(out)
        for rank, p in enumerate(procs):
            rc = p.wait(timeout=120)
            assert rc == 0, (tmp_path / f"rank{rank}.log").read_text()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        srv.stop()
    ranks = [json.load(open(o)) for o in outs]
    assert len(ranks[0]["steps"]) == len(ranks[1]["steps"])
    shares = [sum(s["real"] for s in r["steps"]) for r in ranks]
    assert sum(shares) == 40 and shares[0] != shares[1], shares
    audit_spans([sp for r in ranks for s in r["steps"] for sp in s["spans"]], 4, 10)
    union: dict = {}
    for r in ranks:
        for fi, b, e in r["local"]:
            merge_span(union.setdefault(fi, []), b, e)
    want = [[fi, b, e] for fi in sorted(union) for b, e in union[fi]]
    assert ranks[0]["merged"] == ranks[1]["merged"] == want
