"""The port stands alone: ``edl_tpu_torch``, ``chip_smoke.py`` and
``bench_attention.py`` import nothing of JAX, flax, optax, orbax or the JAX
package ``edl_tpu`` (each slice's modules listed, and imported alone too);
and only the store client imports ``msgpack`` (the card
machine's packages need not include it), which a run without a store never
loads."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "edl_tpu")
# the modules of the distributed slice, each a copy of a JAX module or a port
DISTRIBUTED_MODULES = (
    "edl_tpu_torch.utils.retry", "edl_tpu_torch.utils.network", "edl_tpu_torch.rpc.framing",
    "edl_tpu_torch.rpc.client", "edl_tpu_torch.coord.kv", "edl_tpu_torch.coord.client",
    "edl_tpu_torch.cluster.paths", "edl_tpu_torch.cluster.train_status",
    "edl_tpu_torch.cluster.heartbeat", "edl_tpu_torch.train.lr",
    "edl_tpu_torch.train.distributed")
# the modules of the serving slice
SERVING_MODULES = (
    "edl_tpu_torch.models.generate", "edl_tpu_torch.serving", "edl_tpu_torch.serving.engine",
    "edl_tpu_torch.rpc.server", "edl_tpu_torch.coord.register",
    "edl_tpu_torch.distill", "edl_tpu_torch.distill.predict_client",
    "edl_tpu_torch.distill.balance", "edl_tpu_torch.distill.teacher", "edl_tpu_torch.serve_lm")
# the modules of the ResNet slice, with the trainer's recovery record,
# resilient store client and preemption grace
RESNET_MODULES = (
    "edl_tpu_torch.cluster.recovery", "edl_tpu_torch.cluster.preempt",
    "edl_tpu_torch.coord.resilient", "edl_tpu_torch.models.resnet",
    "edl_tpu_torch.native", "edl_tpu_torch.native.build", "edl_tpu_torch.native.recordio",
    "edl_tpu_torch.native.imagedec", "edl_tpu_torch.data", "edl_tpu_torch.data.images",
    "edl_tpu_torch.train_resnet")
# the modules of the data-service slice
DATA_SERVICE_MODULES = (
    "edl_tpu_torch.cluster.pod", "edl_tpu_torch.cluster.cluster", "edl_tpu_torch.coord.memory",
    "edl_tpu_torch.data.dataset", "edl_tpu_torch.data.registry", "edl_tpu_torch.data.resilient",
    "edl_tpu_torch.data.data_server", "edl_tpu_torch.data.distribute_reader",
    "edl_tpu_torch.data.elastic_input")
# the modules of the image-distillation slice
DISTILL_MODULES = (
    "edl_tpu_torch.coord.consistent_hash", "edl_tpu_torch.distill.tasks",
    "edl_tpu_torch.distill.timeline", "edl_tpu_torch.distill.predict_pool",
    "edl_tpu_torch.distill.reader", "edl_tpu_torch.distill.discovery",
    "edl_tpu_torch.distill.lite_discovery", "edl_tpu_torch.distill.qps",
    "edl_tpu_torch.train_image_distill")
# the modules of the serving-fleet slice
FLEET_MODULES = (
    "edl_tpu_torch.serving.kv_cache", "edl_tpu_torch.serving.replica",
    "edl_tpu_torch.coord.session", "edl_tpu_torch.rpc.chunks", "edl_tpu_torch.gateway",
    "edl_tpu_torch.gateway.fleet", "edl_tpu_torch.gateway.gateway",
    "edl_tpu_torch.gateway.__main__")
# the modules of the resizable-world slice: the peer checkpoint cache, the
# delta plane and the live reshard's records and transfers
RESHARD_MODULES = (
    "edl_tpu_torch.memstate", "edl_tpu_torch.memstate.advert",
    "edl_tpu_torch.memstate.placement", "edl_tpu_torch.memstate.reshard",
    "edl_tpu_torch.memstate.shards", "edl_tpu_torch.memstate.service",
    "edl_tpu_torch.memstate.tee", "edl_tpu_torch.memstate.restore",
    "edl_tpu_torch.memstate.delta", "edl_tpu_torch.cluster.resize",
    "edl_tpu_torch.rpc.transfer")
# the modules of the teacher-fleet and journaled-leader slice
FLEET_LEADER_MODULES = (
    "edl_tpu_torch.cluster.scale", "edl_tpu_torch.distill.fleet",
    "edl_tpu_torch.distill.backlog", "edl_tpu_torch.data.journal", "edl_tpu_torch.data.leader")
# the modules of the mesh slice
MESH_MODULES = (
    "edl_tpu_torch.parallel", "edl_tpu_torch.parallel.mesh", "edl_tpu_torch.parallel.sharding",
    "edl_tpu_torch.parallel.tp", "edl_tpu_torch.models.logical")
# the modules of the tensor-parallel serving slice: the tp group's command
# channel (the engine, the paged pool, the teacher and the entry points that
# drive it are listed above)
SERVING_TP_MODULES = ("edl_tpu_torch.serving.spmd",)
# the modules of the MoE and sequence-parallel slice
MOE_SP_MODULES = ("edl_tpu_torch.ops.moe", "edl_tpu_torch.ops.ring")
# the modules of the last models slice: five models and four entry points
SMALL_MODELS_MODULES = (
    "edl_tpu_torch.models.layers", "edl_tpu_torch.models.linear",
    "edl_tpu_torch.models.wide_deep", "edl_tpu_torch.models.mnist",
    "edl_tpu_torch.models.text", "edl_tpu_torch.models.vgg", "edl_tpu_torch.models.convert",
    "edl_tpu_torch.train_linear", "edl_tpu_torch.train_wide_deep",
    "edl_tpu_torch.train_mnist_distill", "edl_tpu_torch.train_nlp_distill")
# the modules of the trainer's observability slice
OBS_MODULES = (
    "edl_tpu_torch.obs", "edl_tpu_torch.obs.metrics", "edl_tpu_torch.obs.context",
    "edl_tpu_torch.obs.trace", "edl_tpu_torch.obs.exposition", "edl_tpu_torch.obs.flightrec",
    "edl_tpu_torch.obs.ledger", "edl_tpu_torch.obs.profile", "edl_tpu_torch.obs.flops",
    "edl_tpu_torch.obs.advert")
MSGPACK_IMPORTERS = ["edl_tpu_torch/rpc/framing.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _port_sources():
    return sorted((ROOT / "edl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                             ROOT / "bench_attention.py"]


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
FORBIDDEN = {FORBIDDEN!r}
bad = lambda: sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
before = set(bad())
import edl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(edl_tpu_torch.__path__, 'edl_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke, bench_attention
print(sorted(names))
print(sorted(set(bad()) - before))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.splitlines()
    names = ast.literal_eval(out[-2])
    assert len(names) >= 60 and set(DISTRIBUTED_MODULES + SERVING_MODULES + RESNET_MODULES
                                    + DATA_SERVICE_MODULES + DISTILL_MODULES
                                    + FLEET_MODULES + RESHARD_MODULES
                                    + FLEET_LEADER_MODULES + MESH_MODULES
                                    + SERVING_TP_MODULES + MOE_SP_MODULES
                                    + SMALL_MODELS_MODULES + OBS_MODULES) <= set(names), names
    assert out[-1] == "[]", f"the port loaded {out[-1]}"


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders
    assert len(_port_sources()) >= 61


def test_only_the_store_client_imports_msgpack():
    importers = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            if any(n.split(".")[0] == "msgpack" for n in names):
                importers.append(str(path.relative_to(ROOT)))
    assert importers == MSGPACK_IMPORTERS


def test_importing_the_resnet_slice_loads_no_cv2():
    """``cv2`` is imported only inside the functions that decode or encode
    an image, so a machine without it imports the whole slice."""
    code = ("import sys; import edl_tpu_torch.data.images, edl_tpu_torch.train_resnet, "
            "edl_tpu_torch.native.imagedec; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('cv2',) + " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_distill_slice_loads_no_jax_and_no_cv2():
    """The distillation modules and the image-distillation entry point
    load neither JAX nor ``cv2`` (only writing the synthetic data needs
    it, inside the function that writes)."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(DISTILL_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('cv2',) + " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_fleet_slice_loads_no_jax():
    """The paged pool, the replica, the gateway and the shared lease load
    no JAX."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(FLEET_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_reshard_slice_loads_no_jax():
    """The cache, the delta plane, the resize records and the striped
    transfer load no JAX and nothing of the JAX package."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(RESHARD_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_mesh_slice_loads_no_jax():
    """The mesh, the logical sharding, the tensor-parallel functions and the
    logical-axes rules load no JAX and nothing of the JAX package."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(MESH_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_serving_tp_slice_loads_no_jax():
    """The tp group's command channel, with the engine, the paged pool, the
    teachers, serve_lm and the replica that drive it, load no JAX and
    nothing of the JAX package."""
    modules = SERVING_TP_MODULES + ("edl_tpu_torch.serving.engine",
                                    "edl_tpu_torch.serving.kv_cache",
                                    "edl_tpu_torch.distill.teacher", "edl_tpu_torch.serve_lm",
                                    "edl_tpu_torch.serving.replica")
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(modules) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_fleet_and_leader_slice_loads_no_jax():
    """The scale records, the teacher fleet, the student feed, the data
    journal and the elected data leader load no JAX and nothing of the JAX
    package."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(FLEET_LEADER_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_models_slice_loads_no_jax():
    """The linear, Wide&Deep, MNIST, text and VGG models, their converters
    and the four example trainers load no JAX and nothing of the JAX
    package."""
    code = ("import sys, importlib; [importlib.import_module(m) for m in "
            + repr(SMALL_MODELS_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_importing_the_obs_slice_loads_no_jax_and_no_msgpack():
    """The observability modules load no JAX, nothing of the JAX package and
    no ``msgpack``; the trainer and ``obs/`` itself leave the advert, and so
    the coordination layer, unloaded until a store asks for it."""
    code = ("import sys, importlib; importlib.import_module('edl_tpu_torch.train.trainer'); "
            "print(sorted(m for m in sys.modules if m.startswith(('edl_tpu_torch.coord', "
            "'edl_tpu_torch.obs.advert')))); [importlib.import_module(m) for m in "
            + repr(OBS_MODULES) + "]; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('msgpack',) + " + repr(FORBIDDEN) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.splitlines() == ["[]", "[]"]


def test_standalone_train_lm_run_imports_no_msgpack(tmp_path):
    """``python -m edl_tpu_torch.train_lm`` with no store in the env (no
    launcher, or a launcher-shaped env without one) trains and never
    imports ``msgpack``: ``-X importtime`` lists every module it loads."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=str(ROOT), EDL_TPU_TRAINERS_NUM="1", EDL_TPU_TRAINER_ID="0",
               EDL_TPU_CKPT_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-X", "importtime", "-m", "edl_tpu_torch.train_lm",
                          "--device", "cpu", "--vocab", "64", "--layers", "1", "--embed", "32",
                          "--heads", "2", "--mlp", "64", "--seq_len", "16", "--batch_size", "2",
                          "--steps_per_epoch", "2", "--epochs", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = {line.split("|")[-1].strip() for line in out.stderr.splitlines()
              if line.startswith("import time:")}
    assert "edl_tpu_torch.train.trainer" in loaded and '"world": 1' in out.stdout
    assert not {m for m in loaded if m.split(".")[0] == "msgpack"}
    assert "edl_tpu_torch.coord.client" not in loaded
