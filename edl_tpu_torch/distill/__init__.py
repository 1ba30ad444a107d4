"""Service distillation (the port of the JAX package's ``distill/``).

Students stream minibatches to a fleet of discovered, load-balanced
teacher servers and get the teachers' predictions back, appended to their
own batch fields:

- :class:`DistillReader`: the user API (ins and predicts, fixed or
  discovered teachers, the teacher batch size), over
  :mod:`~edl_tpu_torch.distill.predict_pool` (task slicing, a worker
  thread a teacher, requeue, reorder by task);
- :mod:`~edl_tpu_torch.distill.discovery` and
  :mod:`~edl_tpu_torch.distill.balance`: the teacher registry and the
  greedy student-to-teacher assignment, sharded over discovery servers by
  consistent hash; :mod:`~edl_tpu_torch.distill.lite_discovery`, the same
  behind a length-prefixed JSON wire;
- :mod:`~edl_tpu_torch.distill.teacher`: the teacher server (padding,
  bucketing and coalescing behind the EDL1 wire) with ``module_teacher``
  (an ``nn.Module`` forward) and ``lm_teacher`` (a serving engine).

Not ported: ``DistillFleet``, ``TeacherReplica`` and ``StudentFeed``, which
ride the gateway's fleet view and the shared ``CoordSession`` (both in the
port now) and ``cluster/scale`` (ROADMAP.md Queue 1 item 6.4).
"""

from edl_tpu_torch.distill.predict_client import NopPredictClient, TeacherClient
from edl_tpu_torch.distill.reader import DistillReader

__all__ = ["DistillReader", "TeacherClient", "NopPredictClient"]
