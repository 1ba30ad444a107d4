"""Spawn a gloo world of worker processes on the CPU, the launcher's env
given to each rank, and wait for it (a time limit on each process)."""

import os
import pathlib
import subprocess
import sys

import torch

from edl_tpu_torch.utils.network import find_free_port

ROOT = pathlib.Path(__file__).resolve().parents[2]


def run_world(worker: pathlib.Path, io_dir: pathlib.Path, world: int, timeout: float) -> list:
    """Run ``worker io_dir`` as ranks 0..world-1; every rank must exit 0
    within ``timeout`` seconds (the others are killed when one does not).
    Returns each rank's ``io_dir/out<rank>.pt``, in rank order."""
    port = find_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    logs = [open(io_dir / f"log{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(io_dir)], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, text=True,
        env={**env, "PYTHONPATH": str(ROOT), "EDL_TPU_TRAINER_ID": str(r),
             "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
             "OMP_NUM_THREADS": "1"})
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (io_dir / f"log{r}.txt").read_text()[-4000:]
    return [torch.load(io_dir / f"out{r}.pt", weights_only=False) for r in range(world)]
