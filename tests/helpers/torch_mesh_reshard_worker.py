"""One trainer of the live reshard across a mesh change in
``tests/test_torch_mesh_train.py``: a pod of one trainer with its own peer
checkpoint cache service, in the resizable world the launcher's env names
(the test plays the launcher on a coordination server).  ``train_lm``'s
trainer at auto tp (2 at world 2, 1 at world 3) trains the same rows every
step; the test flags a grow mid-run and spawns the joiner.

    python tests/helpers/torch_mesh_reshard_worker.py <io_dir> <epochs> <train_lm flags...>
        # io_dir/in.pt: {"ids": [B, L+1] ids}; writes io_dir/out-<pod>.pt:
        # this rank's losses (with the mesh each ran on), reshards, restores
"""

import sys

import torch

from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.coord.client import connect
from edl_tpu_torch.models.transformer import LOGICAL_RULES
from edl_tpu_torch.parallel.mesh import mesh_sizes
from edl_tpu_torch.train.distributed import initialize_from_env, shutdown
from tests.helpers.torch_cache import serve_pods, teardown


def main(io_dir, epochs, argv):
    tenv = initialize_from_env(TrainerEnv(), "cpu")
    store = connect(tenv.coord_endpoints)
    pods = serve_pods(store, [tenv.pod_id])
    try:
        args = train_lm.parse_args(argv)
        ids = torch.load(f"{io_dir}/in.pt", weights_only=True)["ids"]
        _, tr, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                    tenv.checkpoint_dir, store, tenv)
        inner, losses = tr.loss_fn, []

        def recording(*a):
            loss, aux = inner(*a)
            losses.append((float(loss.detach()), mesh_sizes(tr.layout)["tp"]))
            return loss, aux

        tr.loss_fn = recording

        def data_fn(_epoch):
            for _ in range(args.steps_per_epoch):
                yield {"ids": ids}

        state, meta = tr.restore_or_create(init_fn, tx, LOGICAL_RULES)
        first_step = state.step
        state, meta = tr.fit(state, meta, data_fn, epochs=int(epochs))
        torch.save({"losses": losses, "first_step": first_step, "step": state.step,
                    "reshards": tr.reshards, "restores": tr.restores,
                    "mesh": mesh_sizes(tr.layout), "processes": tr.processes},
                   f"{io_dir}/out-{tenv.pod_id}.pt")
    finally:
        teardown(pods)
        store.close()
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
