"""The port stands alone: ``edl_tpu_torch``, ``chip_smoke.py`` and
``bench_attention.py`` import nothing of JAX, flax, optax, orbax or the JAX
package ``edl_tpu``; and only the store client imports ``msgpack`` (the card
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
    assert len(names) >= 40 and set(DISTRIBUTED_MODULES + SERVING_MODULES) <= set(names), names
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
    assert len(_port_sources()) >= 41


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
