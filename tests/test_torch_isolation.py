"""The port stands alone: ``edl_tpu_torch``, ``chip_smoke.py`` and
``bench_attention.py`` import nothing of JAX, flax, optax, orbax or the JAX
package ``edl_tpu``."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "edl_tpu")


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
print(len(names))
print(sorted(set(bad()) - before))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.splitlines()
    assert int(out[-2]) >= 15, out
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
    assert len(_port_sources()) >= 16
