#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases build,kernels,flash
    python3 chip_smoke.py --phases build,kernels,d256
    python3 chip_smoke.py --phases build,kernels,d384
    python3 chip_smoke.py --phases build,kernels,d768
    python3 chip_smoke.py --phases build,elastic
    python3 chip_smoke.py --phases build,serve
    python3 chip_smoke.py --phases fleet
    python3 chip_smoke.py --phases build,resnet
    python3 chip_smoke.py --phases build,data
    python3 chip_smoke.py --phases distill
    python3 chip_smoke.py --phases build,reshard
    python3 chip_smoke.py --phases build,mesh
    python3 chip_smoke.py --phases build,meshserve
    python3 chip_smoke.py --phases build,moe,ring

Phases, in order; each prints its numbers on a line of its own, and any
failure exits non-zero:

1. ``build``: compile the CUDA kernels from ``edl_tpu_torch/csrc`` with nvcc,
   one process per source, all at once (every instantiation: the Hopper
   forward, dQ and dK/dV at 4 head dims each, causal and not, the Hopper
   forward whose consumers split the output columns at D = 320, 384, 448,
   512 and the one that does so on chunks of the columns above 512, the
   Hopper dK/dV whose blocks split the output columns at D = 320, 384,
   the Hopper dQ and dK/dV on thread block clusters that split
   D, at 3 and 4 column boxes a block, and the mma.sync dQ and dK/dV past
   the largest cluster), and print each one's registers and spills, and
   the cluster kernels' shared memory; the cluster kernels must neither
   spill nor carry a ptxas C75xx note.
2. ``kernels``: each kernel against its plain PyTorch version (f32 from the
   same bf16 inputs; dQ's two outputs, dq and delta, both) at the flagship
   shape and at ragged, cross-length (causal ``Lq < Lk``: keys that no
   query sees must get exactly zero gradients),
   wide-head (D = 192 to 2112: the cluster kernels from 320 on, with 2 to
   8 blocks a cluster, and the mma.sync backward at 2112), many-head (B *
   H > 65,535, at D = 64 and 256) and transposed-layout ones (D = 128, 192,
   256, 384, 768); which forward, dQ and dK/dV kernel each head dim runs
   (from the profile); f32 causal cross-length
   attention on the card (the top-left function, through dense); and
   device times (``torch.profiler``) of the kernel, of its plain version
   and of one PyTorch library call as a yardstick only, and the least time
   the card could take (the bound), at the flagship shape, at the ``d256``
   phase's ``[8, 1024, 3, 256]``, at the ``d384`` phase's ``[8, 1024,
   2, 384]``, at the ``d768`` phase's ``[8, 1024, 1, 768]`` and at the
   ``meshserve`` phase's tp-2 teacher's ``[8, 1024, 3, 128]`` a rank; and,
   untimed, at the ``ring`` phase's gathered sequence, ``[4, 2048, 6, 128]``.
3. ``parity``: one training step of small bf16 configs on the card (with
   the kernels) and on the CPU (plain path) from the same weights: the
   splash path at head dims 128, 192, 256, 384 and 768, and the flash path
   with grouped-query attention at head dims 64 and 256.
4. ``flagship``: the 124M-parameter LM at batch 8 x seq 1024 with the fused
   cross-entropy, through ``edl_tpu_torch.train_lm``'s trainer: 2 warm-up
   steps and 10 timed steps on a fixed batch; tokens/s, MFU and peak memory;
   the splash kernels' launch counters (forward, dQ, dK/dV) must equal 12
   per step each, and every other attention kernel's 0; the profile of two
   more steps must show this repo's attention kernels 36 times a step.
5. ``flash``: the same run with ``--attention flash``: the flash kernels
   launch 12 times per step each and every other attention kernel none,
   the loss falls, and the first loss equals the splash path's.
6. ``d256``: the flagship's widths and depth with ``--heads 3``, so head
   dim 256 (the Gemma family's): the same checks, and the profile must
   show the dK/dV kernel whose consumers split dK and dV 12 times a step.
7. ``d384``: the same with ``--heads 2``, head dim 384: the launch
   counters show forward, dQ and dK/dV 12 times a step each, and the
   profile the Hopper forward whose consumers split the output columns,
   the cluster dQ and the Hopper dK/dV whose blocks split the output
   columns 12 times a step each (36 attention kernels), and no other.
8. ``d768``: the same with ``--heads 1``, head dim 768: the profile shows
   the Hopper forward on chunks of the output columns, the cluster dQ and
   the cluster dK/dV 12 times a step each, and no other attention
   kernel.
9. ``resnet``: ResNet50 (width 64, 1000 classes) through
   ``edl_tpu_torch.train_resnet``'s trainer at bs 128, 224², bf16, on the
   JAX bench's fixed device batch with its SGD (0.1, momentum 0.9,
   Nesterov) and train_resnet's label-smoothed loss: 3 warm-up and 20 timed
   steps; img/s per card, wall ms a step, device ms a step by group from 2
   profiled steps, MFU (``obs/flops.py``), peak memory, and img/s again
   with cuDNN's autotuner on; the loss must fall on the memorised batch and
   no attention kernel may launch.  A uint8 BGR batch through
   ``device_normalize``, held to its numpy formula to 1e-6.  One ResNet18
   step (width 16, 32², batch 8, f32) on the card against the CPU: logits,
   loss, BN buffers and parameters within ``RESNET_CPU_TOL`` of each
   tensor's largest magnitude.  A checkpoint round trip: the next loss
   equals the uninterrupted run's and the BN buffers come back as saved.
   ``--remat``: one step with and without it from the same weights (the same
   loss and BN running stats, to ``RESUME_RTOL``), then img/s and peak
   memory over 20 remat steps beside the plain step's.  BN's world-1 branch:
   3 steps in an NCCL group of one equal 3 steps with no group to the bit
   (losses, BN running stats, parameters; cuDNN deterministic for both),
   and a step's profile holds only the gradient reduction's NCCL kernels;
   img/s with and without the group.
   The native record library builds and round-trips 1,000 records; the
   JPEG pipeline's host img/s is timed only where ``cv2`` imports.
10. ``resume``: save at an epoch's end, drop the trainer, restore a new one
   with ``restore_or_create`` and check that step, epoch and the next loss
   continue the uninterrupted run.  The restored trainer runs with a
   store (a dict) and a launcher's stage, and writes the trainer half of
   the resize's recovery record once: ``restored_to_first_step`` is
   printed.
11. ``data``: ResNet50 fed by the data service, in one process that plays
   the deployment's part (a ``MemoryKV`` store, the port's journaled
   ``DataService`` hosted by an elected ``DataLeaderHost`` on the port's
   ``RpcServer``, a one-pod cluster record): ``train_resnet``'s training
   function with ``--data_service --data_leader`` at bs 128,
   224², bf16, on ``--synthetic`` files of 2 x 330 records (5 full steps and
   one of 20 rows an epoch), 2 epochs, ``--save_every_steps 2``; the first
   run stops right after the save at epoch 1's second step, and a fresh
   trainer restores it in a new cluster stage.  Checks: (a) every record of
   each epoch trains exactly once and the ragged steps' masks sum to 20;
   (b) the BN buffers after a masked step equal those before it, and a full
   step changes them; (c) the resumed epoch trains exactly the records the
   checkpoint's spans lack; (d) host batches of the same shapes come out of
   ``device_put_stream`` on the card bit-equal and in order; (e) after
   epoch 0's second step the seated data leader stops and a standby takes
   the seat and rebuilds from the journal while the trainer steps on (every
   record still trains exactly once, by (a)).  Prints img/s a card through
   the data service, the H2D wait and the time blocked on the input (in
   total and a step), the host decode rate, the resnet phase's fixed-batch
   img/s beside them, and the leader-gone-to-next-step and
   leader-gone-to-successor's-first-batch seconds.
12. ``elastic``: the distributed trainer.  (1) An NCCL process group of
   one: 3 flagship steps through the gradient all-reduce give parameters
   and losses equal to the bit to 3 steps without a group, the splash
   kernels launch 12 times a step each, and the profile of a step shows
   the NCCL all-reduce kernel(s), their ms and the step's device time;
   tokens/s with and without the group.  (2) ``python -m
   edl_tpu_torch.train_lm`` (depth 2) under a launcher-shaped env with no
   store, 1 epoch then 2: the second resumes at epoch 1 in a world of 1,
   and neither imports ``msgpack``.  (3) A 2-rank gloo world on the CPU
   (2 layers, width 128) saves an epoch; the card restores it at world 1
   under ``EDL_TPU_LR_RESCALE=1``: epoch history [2, 1], LR scale 0.5,
   and the next loss within the parity phase's bf16 tolerance of the same
   continuation on the CPU.
13. ``serve``: generation and serving at the flagship's full width (12 x 768,
   6 heads x 128, MLP 3072, vocab 32,000, max_len 1024, seed-0 weights,
   bf16).  (a) ``generate`` greedy on [8, 128] prompts, 64 new tokens; the
   decode path's logits, teacher-forced on the emitted tokens, within
   ``SERVE_MARGIN / 2`` of the full-prefix dense forward's.  (b) ``python -m
   edl_tpu_torch.serve_lm --continuous 16`` as a subprocess, output to a
   file, its endpoint read from its first line; 32 greedy requests over the
   wire from 16 client threads, prompt lengths 16 to 900 from a seed (those
   over 512 tokens prefill in chunks); then SIGTERM.  (c) An in-process
   engine on the same requests: tokens/s, peak memory; decode ms a step at
   16 live slots and the device-busy share of that loop (``torch.profiler``);
   prefill ms per bucket.  Every request must return its length, and every
   emitted token must be the argmax of the full-prefix dense forward (no
   cache) on the emitted tokens wherever that forward's top-2 margin exceeds
   ``SERVE_MARGIN``; how many requests equal their isolated ``generate``
   token for token is reported.  The path computes attention densely, as the
   JAX package's serving path does, so no attention kernel launches in it.
14. ``fleet``: the LM serving fleet at the serve phase's width and weights,
   16 slots an engine, ``kv_block`` 16, the default pool, ``prefill_chunk``
   512.  (a) 16 requests, one shared 512-token system prompt (seed 21) plus
   a 16-256 token suffix each, 32 new tokens, through a paged and an
   unpaged engine (the first alone, then 15 at once): tokens/s of each,
   the share of prefill tokens skipped, hits and misses, and one 640-token
   admission's wall and device ms and launches cold and from the committed
   prompt, and its 32-block gather's.  (b) Two
   ``ReplicaServer``s, each over its own engine on the card, behind one
   ``Gateway`` over loopback RPC on a ``MemoryKV``: 8 sessions of 3 turns
   (turn n+1 is turn n's prompt, its 32 tokens and a new 32-128 token
   suffix) and 16 one-shot requests; after turn 2 the replica pinning the
   most sessions drains, and its sessions must be re-pinned to the
   survivor, their turn 3 skip more than the system prompt there, and no
   request be lost; the gateway's p50/p99 latency, hedges, failovers, the
   drain's seconds and the blocks migrated.  (c) 16 prompts of 16-256
   tokens, 64 new, ``spec_k`` 3, with a self-draft and an adversarial
   2-layer draft (seed 1) beside the plain engine: acceptance rate,
   tokens/s, and a round's and a verify pass's wall and device ms and
   launches; one verify call from a lane at the cache's last two columns
   and one past its end, against the same call on a CPU copy, must leave
   every unwritten column's bits alone.  (d)
   The phase's peak device memory.  Every token of (a), (b) and (c) is
   held to the full-prefix argmax by the serve phase's margin rule, and no
   attention kernel launches.
15. ``distill``: image distillation on one card, through
   ``edl_tpu_torch.train_image_distill``.  A ResNet152 teacher (width 64,
   1,000 classes, bf16) takes 20 SGD steps through ``train_teacher`` on four
   pre-decoded f32 batches [128, 224, 224, 3] (from a seed, cycled); two
   ``TeacherServer``s over ``module_teacher`` share it and register with a
   ``DiscoveryServer`` in a ``MemoryKV``.  A ResNet50vd student (bs 128)
   trains through ``train_student`` on ``make_distill_source`` (dynamic
   teachers): 2 warm-up and at least 16 timed steps; server A stops after
   timed step 4, server C starts after step 8, and the student steps on
   until C has served rows (30 s at most).  Then the same student step
   without the teacher.  Checks: every batch's logits equal the teacher's own
   forward on its rows at bucket 16 (relative max error 1e-2) and miss the
   next batch's by at least 10 times that; batches arrive in order with
   their labels, none lost or duplicated; the rows served cover every
   batch; C serves rows; the loss equals a float64 evaluation on the same
   logits (1e-3) and falls; both models' parameters and every teacher
   forward are on the card.  Prints img/s with the teacher and alone, the
   time blocked on the reader, teacher rows/s, passes and rows a pass,
   forward ms by bucket, wire MB/s, the nop reader's QPS at these rows,
   peak memory, the longest step interval around the leave and C's
   registration to its first row.  (d) The teacher fleet on the same store
   and teacher: two ``TeacherReplica``s of one job behind a
   ``DistillFleet``; a third server's balance advert and a
   ``DiscoveryServer`` on one shared ``CoordSession`` must ride one lease;
   one routed, hedged predict; the student reads through
   ``make_distill_source`` with the fleet's ``endpoints_fn()`` wrapped in a
   ``StudentFeed`` (2 warm-up and 10 timed steps), replica 0 stops after
   timed step 4: no batch lost or mispaired, the pairing audit and its
   control hold, the backlog record is read while the student runs and is
   gone after.  Prints img/s through the fleet against through discovery,
   the fleet's retries and hedges, the stop's stall and the backlog rows.
16. ``reshard``: the resizable world at the flagship's full width (seed-0
   weights, the fixed batch), in one process that plays the launcher's
   part: a ``MemoryKV`` store, the port's ``StateCacheService`` on its
   ``RpcServer`` and a one-pod cluster record.  (a) 4 steps and a save at
   step 4, teed and sealed; a fresh trainer restores cache-first
   (``peer``), bit-identical to the storage restore, and its next losses
   equal an uninterrupted run's (``RESUME_RTOL``).  (b) With
   ``EDL_TPU_DELTA_EVERY=2`` it trains to step 8 and stops; a fresh trainer
   rolls forward over the delta chain to step 8 (``delta``) and its next
   loss equals the uninterrupted run's; tokens/s with the delta plane off
   and on, in turns.  (c) A grow flag and a go record to a second stage: the
   same trainer pauses at the agreed step, reshards from its local snapshot
   (``delta``, 0 wire bytes), writes its done record and trains on with the
   uninterrupted run's losses; the splash kernels launch 12 times a step
   each after the reshard.  (d) An NCCL group of one forms through the
   store rendezvous and all-reduces, then again under a new nonce.  Prints
   restore seconds by source and bytes, the synchronous stage ms, the push
   seconds, detect to first step, and the formation ms.
17. ``mesh``: the flagship (seed-0 weights, the fixed batch) on a mesh.
   (a) tp = 2 on the one card: two processes, both on ``cuda:0``, in a gloo
   group (which must all-reduce CUDA tensors: no CPU path), each with 3
   heads through the Hopper kernels and a 16,000-column vocab shard
   through the fused CE; 3 steps whose losses and gathered step-1
   gradients are held to the one-process step on the card
   (``MESH_LOSS_RTOL``, ``MESH_GRAD_RTOL``), each rank's splash launch
   counters and a profiled step's attention kernels (12 each a step), wall
   ms a step; a storage checkpoint at step 3, then a 4th step.  (b) FSDP2
   forced on an fsdp axis of 1 in an NCCL group of one (``build_trainer(
   force_fsdp=True)``): 3 steps against the plain step (bit-equal or
   within ``MESH_LOSS_RTOL``), device ms and NCCL kernels a step against
   the plain step's.  (c) The checkpoint of (a) resumed by one process at
   tp = 1: its next loss against (a)'s 4th (``MESH_RESUME_ATOL``).
18. ``meshserve``: tensor-parallel serving at the serve phase's width and
   weights: two processes on the one card in a gloo group (CUDA tensors),
   rank 0 leading every tp group, rank 1 following.  First each decode
   step's collectives timed alone (the f32 residual all-reduce, the head's
   f32 vocab columns, the tokens' broadcast).  (a) The paged continuous
   engine at tp = 2 (16 slots, ``kv_block`` 16) over the serve phase's
   first 16 requests x 32 tokens (``MESHSERVE_REQUESTS``): tokens/s, wall ms a decode step at 16 slots, and
   beside them the one-process engine's on the same requests (each engine
   warmed at 128 tokens), with how many requests and tokens equal its.  (b) A session's turn exported from
   the tp-2 engine resumes in a one-process engine, and one from a
   one-process engine in a tp-2 engine: each warm (one hit, the chain's
   tokens skipped), the two blobs of one layout.  (c) Speculative decoding
   on the group with the replica's default draft (1 x 16, on rank 0 only),
   k = 3, over 8 requests of at most 256 prompt tokens: the accept rate.  (d) ``module_teacher(mesh=)`` on the flagship
   with ``attention_impl="auto"`` at [8, 1024]: its logits against the
   one-process teacher's (``MESHSERVE_TEACHER_RTOL``; both also against
   the same weights in f32, bf16's floor), and each rank's
   launch counters show 12 splash forwards a call at 3 heads.  (e) A
   ``ReplicaServer`` over a tp-2 engine behind the ``Gateway`` answers 8
   requests over the wire.  Every token of (a), (b), (c) and (e) is held to
   the full-prefix argmax by the serve phase's margin rule.
19. ``moe``: the mixture-of-experts LM.  (a) The MoE flagship (the
   flagship with ``--moe 8 --moe_top_k 2``, capacity 1.25, aux weight
   0.01) through train_lm's trainer on the fixed batch: 2 warm-up and 20
   timed steps; tokens/s, peak memory, the loss falling, the aux loss; the
   splash launch counters 12 a step each and no other attention kernel;
   the profile of two steps: the splash kernels 12 times a step each and
   no library attention kernel (SDPA, cuDNN); device ms a step by group:
   the splash kernels from the profile, and the router and routing, the
   dispatch and combine einsums, the expert GEMMs (each forward and
   backward timed alone at the flagship's shapes between CUDA events,
   queued behind a spin kernel, times 12) and the fused CE.  No MFU is printed (the dense formula would count every expert);
   the active parameters a token reads are.  The 2-layer MoE LM at full
   width in f32: its first loss on the card against the CPU's
   (``MOE_CPU_RTOL``).  (b) ep = 2 over gloo on the one card, 2 layers at
   full width: 3 steps' losses against ep 1's (``SPLIT_LOSS_RTOL``), each
   rank's half of the experts, and a step with its gloo calls timed where
   they are entered.  (c) ``serve_lm --moe 8 --continuous 16`` at full
   width (started before (a), so it loads meanwhile): the serve phase's
   32 requests over the wire, tokens/s, ``moe_prefill_drops``, and
   every token against ``generate`` teacher-forced, by the margin rule.
20. ``ring``: sequence parallelism at the flagship's width, seq 2048,
   batch 4, 2 layers: sp = 2 over gloo on the one card, (a) with ring
   attention (``--attention ring``; no attention kernel launches) and (b)
   with the sequence gathered for the splash kernels (launched on the
   whole sequence), 3 steps each against one process's splash run (the
   losses to ``SPLIT_LOSS_RTOL``, the step-1 gradients to
   ``SP_GRAD_RTOL``, bf16), and a step with each hop of the ring and
   each gloo all-reduce timed: ms a hop, bytes rotated a step.

It then prints the card's ``nvidia-smi`` name and power limit, one line
``{"kernels": [...]}``, and, last, ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import re
import sys
import time
from pathlib import Path

PHASES = ("build", "kernels", "parity", "flagship", "flash", "d256", "d384", "d768", "resnet",
          "resume", "data", "elastic", "serve", "fleet", "distill", "reshard", "mesh",
          "meshserve", "moe", "ring")

# card peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, f32
# outside them, and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP_SHAPE = (8, 1024, 6, 128)     # [B, L, H, D]
D256_SHAPE = (8, 1024, 3, 256)         # the d256 phase's attention
D384_SHAPE = (8, 1024, 2, 384)         # the d384 phase's attention
D768_SHAPE = (8, 1024, 1, 768)         # the d768 phase's attention
TP_SHAPE = (8, 1024, 3, 128)           # the meshserve phase's tp-2 teacher, a rank's heads
RING_SHAPE = (4, 2048, 6, 128)         # the ring phase's gathered sp path: the whole sequence
RAGGED_SHAPES = ((2, 200, 4, 64), (1, 77, 2, 128), (1, 17, 2, 64),
                 (2, 256, 4, 192), (2, 256, 4, 256), (1, 77, 2, 192), (1, 77, 2, 256),
                 (2, 256, 2, 320), (1, 77, 2, 320), (1, 200, 2, 320),
                 (1, 77, 2, 384), (1, 200, 2, 384), (2, 300, 2, 384),
                 (1, 77, 2, 448), (1, 100, 2, 448), (1, 200, 2, 448),
                 (1, 77, 2, 512), (1, 200, 2, 512),
                 (1, 77, 2, 576), (1, 200, 2, 576), (1, 77, 2, 640), (1, 200, 2, 640),
                 (1, 77, 2, 768), (1, 200, 2, 768), (1, 77, 2, 832), (1, 200, 2, 832),
                 (1, 77, 2, 1024), (1, 200, 2, 1024), (1, 130, 2, 1152), (1, 77, 1, 2048),
                 (1, 77, 1, 2112), (1, 300, 1, 2048))
# flash: (q's [B, Lq, H, D], Lk, causal), untimed
FLASH_CASES = (((2, 256, 4, 128), 512, True), ((2, 512, 4, 128), 256, True),
               ((1, 300, 2, 64), 1100, False),
               ((2, 256, 4, 192), 256, True), ((2, 256, 4, 192), 256, False),
               ((2, 256, 4, 256), 256, True), ((2, 256, 4, 256), 256, False),
               ((2, 200, 4, 256), 300, True), ((2, 300, 4, 192), 200, True),
               ((2, 128, 4, 256), 512, True),
               ((2, 256, 2, 320), 384, True), ((1, 300, 2, 320), 200, False),
               ((2, 128, 2, 384), 512, True), ((2, 300, 2, 384), 200, True),
               ((1, 300, 2, 384), 200, False), ((1, 100, 2, 448), 300, True),
               ((2, 256, 2, 512), 256, True), ((1, 200, 2, 512), 300, False),
               ((1, 200, 2, 320), 77, True), ((1, 300, 2, 448), 200, False),
               ((1, 77, 2, 448), 200, True), ((1, 128, 2, 512), 320, True),
               ((1, 300, 2, 512), 200, True), ((1, 200, 2, 512), 77, False),
               ((1, 77, 2, 576), 200, True), ((1, 200, 2, 576), 77, True),
               ((1, 200, 2, 576), 300, False),
               ((1, 77, 2, 640), 200, True), ((1, 200, 2, 640), 77, False),
               ((1, 300, 2, 640), 200, True),
               ((1, 77, 2, 768), 200, True), ((1, 200, 2, 768), 77, True),
               ((1, 200, 2, 768), 300, False),
               ((1, 77, 2, 832), 200, True), ((1, 200, 2, 832), 300, False),
               ((1, 77, 2, 1024), 200, True), ((1, 200, 2, 1024), 77, True),
               ((1, 200, 2, 1024), 300, False), ((1, 300, 1, 2048), 200, False))
# flash with every operand a transposed [B, H, L, D] tensor: (q's shape, Lk,
# causal), untimed
TRANSPOSED_CASES = (((2, 256, 4, 128), 384, True), ((2, 256, 4, 192), 384, True),
                    ((2, 320, 4, 256), 256, False), ((2, 256, 2, 384), 320, True),
                    ((1, 200, 2, 768), 256, True))
# B * H = 81,920 and 65,540 > 65,535 (grid y's limit): B * H rides on grid x
# (splash, untimed)
MANY_HEADS_SHAPES = ((16384, 128, 5, 64), (13108, 32, 5, 256))
REL_TOL = 1e-2                          # ||kernel - plain|| / ||plain||

SM90 = "edl_tpu_torch/csrc/attention_sm90.cu"     # the flagship path's forward, dQ and dK/dV
SPLIT = "edl_tpu_torch/csrc/attention_wide_sm90.cu"   # the forward at D = 320..512
CHUNK = "edl_tpu_torch/csrc/attention_chunk_sm90.cu"  # the forward above D = 512
CLUSTER = "edl_tpu_torch/csrc/attention_bwd_cluster_sm90.cu"  # dQ above 256, dK/dV above 384
SPLASH = "edl_tpu/ops/attention.py:112 -> jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"
FLASH = "edl_tpu/ops/attention.py:81 -> jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNELS = {
    # wrapper name -> (kernel name, source at the flagship shape, TPU code it replaces)
    "attention_fwd": ("edl_attn_fwd", SM90, f"{SPLASH}:1137"),
    "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", SM90, f"{SPLASH}:2196"),
    "attention_bwd_dq": ("edl_attn_bwd_dq", SM90, f"{SPLASH}:1635"),
    "flash_fwd": ("edl_flash_fwd", SM90, f"{FLASH}:758"),
    "flash_bwd_dkdv": ("edl_flash_bwd_dkdv", SM90, f"{FLASH}:1121"),
    "flash_bwd_dq": ("edl_flash_bwd_dq", SM90, f"{FLASH}:1456"),
}
# the d384 phase's kernels: the splash path's at D = 384 (the Hopper forward
# whose consumers split the output columns; the cluster dQ, delta folded
# in; the Hopper dK/dV whose blocks split the output columns)
KERNELS_D384 = {
    "attention_fwd": ("edl_attn_fwd", SPLIT, KERNELS["attention_fwd"][2]),
    "attention_bwd_dq": ("edl_attn_bwd_dq", CLUSTER, KERNELS["attention_bwd_dq"][2]),
    "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", SM90, KERNELS["attention_bwd_dkdv"][2]),
}
# the d768 phase's kernels: the splash path's at D = 768 (the Hopper forward
# on chunks of the output columns; the cluster dQ and dK/dV)
KERNELS_D768 = {**KERNELS_D384,
                "attention_fwd": ("edl_attn_fwd", CHUNK, KERNELS["attention_fwd"][2]),
                "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", CLUSTER, KERNELS["attention_bwd_dkdv"][2])}
# each path's kernels, in the order the autograd function launches them
SPLASH_WRAPPERS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")
FLASH_WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
# (causal, non-causal) x (Hopper forward, dQ and dK/dV at 4 head dims each;
# dK/dV at 192 and 256 is the kernel whose consumers split dK and dV),
# (causal, non-causal) x (the Hopper forward whose consumers split the
# output columns at 4 head dims, the Hopper dK/dV whose blocks split the
# output columns at 2 head dims), (causal, non-causal) x the forward above
# 512 (a compile-time plan at D = 576, 640, 704, 768, and the run-time one
# above), (causal, non-causal) x the cluster dQ and dK/dV at 3 and 4 boxes
# a block, and the mma.sync kernels past the largest cluster: (causal,
# non-causal) x (dK/dV, dQ)
KERNEL_INSTANTIATIONS = 2 * (4 + 4 + 4) + 2 * (4 + 2) + 2 * (4 + 1) + 2 * (2 + 2) + 2 * 2


def log(phase: str, **nums) -> None:
    print(f"[{phase}] " + json.dumps(nums, sort_keys=True), flush=True)


def kernel_times(fn, reps: int) -> list[tuple[float, str, int]]:
    """``(device µs, kernel name, launches)`` of every kernel that ``reps``
    calls of ``fn()`` launch, longest first (``torch.profiler``), between
    two spin kernels that are left out.  A user annotation on the device timeline
    (the optimizer's ``Optimizer.step#...``, the process group's
    ``nccl:all_reduce``) spans kernels that are counted already and is left
    out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a window's first or last records can go unrecorded when its
        # kernels are short (one of ten 20-µs multiplies, every retake, on
        # one card): spin kernels, left out below, stand at both ends
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    return sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                   and not ev.key.startswith(("Optimizer.", "nccl:"))
                   and "spin_kernel" not in ev.key), reverse=True)


def device_ms(fn, reps: int = 10, warmup: int = 3) -> tuple[float, int]:
    """Mean device time of ``fn()`` in ms: the summed time of the kernels it
    launches, so the host's launch overhead between calls, which exceeds the
    shortest kernels' run time, does not count.  Every call launches the
    same kernels, so a profile in which a kernel's count is not a multiple
    of ``reps`` lost records, and is taken again, as is one with none.
    Returns the time and how many profiles were taken again before it."""
    for _ in range(warmup):
        fn()
    for attempt in range(10):
        rows = kernel_times(fn, reps)
        if rows and all(count % reps == 0 for _, _, count in rows):
            return sum(us for us, _, _ in rows) / reps / 1e3, attempt
        print(f"device_ms: the profiler lost kernel records (counts "
              f"{[count for _, _, count in rows]} of {reps} calls); taken again",
              file=sys.stderr, flush=True)
        time.sleep(0.1 * (attempt + 1))
    raise RuntimeError("the profiler lost kernel records in 10 tries")


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` in ms between CUDA events around ``reps``
    back-to-back calls (launch gaps the host cannot hide count)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# -- phase 1 ---------------------------------------------------------------------

def phase_build(ctx) -> None:
    """Build, and print each kernel instantiation's registers and spill
    bytes from ``ptxas -v`` (``fwd_sm90<128,1>``: Hopper forward, D = 128,
    causal; ``fwd_split_sm90<384,1>``: the Hopper forward whose consumers
    split the output columns, D = 384, causal; ``fwd_chunk_sm90<768,1>``:
    the one on chunks of the columns above 512, D = 768, causal;
    ``fwd_chunk_sm90<1>``: the same with the run-time plan above 768).  A
    kernel that moves registers with setmaxnreg reports its launch-bound
    count (168); its consumer warpgroups run on 240.  Also every ptxas
    note C75xx, by instantiation (C7515, C7519, C7520: wgmma serialised or
    an arrive injected, slow, not wrong), which it prints as info, not as
    warnings; the note names its function, else it is the function being
    compiled."""
    from edl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(extra_flags=["-Xptxas", "-v"], force=True)
    seconds = time.perf_counter() - t0

    def key(m):
        # the kernel's name and its integer and bool template arguments (a
        # plan's head dim too), from the mangled name's tail
        targs = m.group(2).split("Ev")[0] if m.group(2).startswith("I") else ""
        params = ",".join(re.findall(r"L[ib](\d+)E", targs))
        return f"{m.group(1)}<{params}>" if params else m.group(1)

    kernels, notes, name = {}, {}, None
    for out in logs.values():
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '.*?attn_(\w+?)_kernel(\w*)", line)
            if m:
                name = key(m)
                kernels[name] = {}
            elif note := re.search(r"\((C75\d\d)\)", line):
                m = re.search(r"attn_(\w+?)_kernel(\w*)", line)
                notes.setdefault(key(m) if m else str(name), []).append(note.group(1))
            elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
                kernels[name]["spill_bytes"] = int(m.group(1))
            elif name and (m := re.search(r"Used (\d+) registers", line)):
                kernels[name]["registers"] = int(m.group(1))
            elif "error" in line or "warning" in line:
                print(f"[build] {line.strip()}", flush=True)
    log("build", seconds=seconds, libraries=sorted(logs), kernel_instantiations=len(kernels),
        kernels=kernels, wgmma_notes=notes)
    if len(kernels) != KERNEL_INSTANTIATIONS:
        raise AssertionError(f"compiled {len(kernels)} attention kernels, want "
                             f"{KERNEL_INSTANTIATIONS}")
    # the cluster kernels (3 or 4 column boxes a block): registers, spills,
    # C75xx notes and the dynamic shared memory a launch takes
    # (edl_attn_bwd_smem)
    from edl_tpu_torch.ops import attention as A
    cluster = {}
    for kname in ("dq_cluster_sm90", "dkdv_cluster_sm90"):
        for bpr in (3, 4):
            for causal in (0, 1):
                inst = f"{kname}<{bpr},{causal}>"
                cluster[inst] = {**kernels.get(inst, {}), "notes": notes.get(inst, []),
                                 "smem_bytes": A.bwd_cluster_smem(bpr, kname.startswith("dq"))}
    log("build", cluster_kernels=cluster)
    bad = {k: v for k, v in cluster.items()
           if v.get("spill_bytes", 1) or v["notes"] or not v["smem_bytes"]}
    if bad:
        raise AssertionError(f"cluster kernels that spill, carry a C75xx note or were not "
                             f"built: {bad}")


# -- phase 2 ---------------------------------------------------------------------

def _attention_work(B, Lq, Lk, H, D, causal) -> dict:
    """Operations (as ``(count, peak rate of their type)`` pairs) and bytes
    each kernel needs at this shape: the unmasked pairs (causal, top-left:
    key j <= query i) are what the data needs; each input read once, each
    output written once."""
    if causal:
        pairs = B * H * sum(min(i + 1, Lk) for i in range(Lq))
    else:
        pairs = B * H * Lq * Lk
    tq, tk = B * Lq * H * D * 2, B * Lk * H * D * 2   # bf16 [B, L, H, D] tensors
    s = B * H * Lq * 4                                 # one f32 [B, H, Lq] statistic
    delta = (2 * B * Lq * H * D, PEAK_F32_FLOPS)      # rowsum(dO * O) in f32, in dQ
    fwd = (((4 * pairs * D, PEAK_BF16_FLOPS),), 2 * tq + 2 * tk + s)
    dkdv = (((8 * pairs * D, PEAK_BF16_FLOPS),), 2 * tq + 4 * tk + 2 * s)
    # dQ with delta folded in: reads q, o, dO, k, v and lse; writes dq and delta
    dq = (((6 * pairs * D, PEAK_BF16_FLOPS), delta), 4 * tq + 2 * tk + 2 * s)
    return {
        "attention_fwd": fwd, "flash_fwd": fwd,
        "attention_bwd_dkdv": dkdv, "flash_bwd_dkdv": dkdv,
        "attention_bwd_dq": dq, "flash_bwd_dq": dq,
    }


def _bound(ops, nbytes):
    """The least time in ms for ``ops`` (``(count, peak rate)`` pairs, one
    per type: the types' units run side by side, so the slowest type
    bounds) and ``nbytes``, and which of the two bounds it."""
    t_ops = max(n / peak for n, peak in ops) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _randn(shape, g, transposed=False):
    """bf16 normal values of ``shape`` ([B, L, H, D]); ``transposed``: a
    [B, H, L, D] tensor seen as [B, L, H, D] (head stride above row stride)."""
    import torch
    if transposed:
        B, L, H, D = shape
        return _randn((B, H, L, D), g).transpose(1, 2)
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _kernel_set(flash: bool, causal: bool) -> dict:
    """wrapper name -> (kernel wrapper, plain version) of one path: the
    forward, dQ (with delta) and dK/dV."""
    from edl_tpu_torch.ops import attention as A
    if not flash:
        return {"attention_fwd": (A.attention_fwd, A.attention_fwd_plain),
                "attention_bwd_dq": (A.attention_bwd_dq, A.attention_bwd_dq_plain),
                "attention_bwd_dkdv": (A.attention_bwd_dkdv, A.attention_bwd_dkdv_plain)}
    c = functools.partial
    return {"flash_fwd": (c(A.flash_fwd, causal=causal), c(A.flash_fwd_plain, causal=causal)),
            "flash_bwd_dq": (c(A.flash_bwd_dq, causal=causal),
                             c(A.flash_bwd_dq_plain, causal=causal)),
            "flash_bwd_dkdv": (c(A.flash_bwd_dkdv, causal=causal),
                               c(A.flash_bwd_dkdv_plain, causal=causal))}


def check_kernels(shape, seed, timed: bool, Lk=None, causal=True, flash=False,
                  transposed=False) -> dict:
    """Each kernel of one path (splash: causal self-attention; flash: ``Lk``
    keys, ``causal`` or not) against its plain version at q's ``shape``;
    with ``timed``, also the times and bounds; with ``transposed``, every
    operand is a transposed [B, H, L, D] tensor, which the kernels must
    read in place.  Returns per-wrapper numbers."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import attention as A

    B, Lq, H, D = shape
    Lk = Lq if Lk is None else Lk
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_randn(s, g, transposed)
                   for s in (shape, (B, Lk, H, D), (B, Lk, H, D), shape))
    if transposed and any(A._operand(t, "t", t.shape) is not t for t in (q, k, v, do)):
        raise AssertionError("a transposed operand was copied before the kernels")
    scale = D ** -0.5
    ks = _kernel_set(flash, causal)
    (fwd, fwd_p), (dq_k, dq_p), (dkdv, dkdv_p) = ks.values()
    n_fwd, n_dq, n_dkdv = ks
    o, lse = fwd(q, k, v, scale)
    o_p, lse_p = fwd_p(q, k, v, scale)
    # dQ first: it computes delta, which dK/dV then takes, as on the path
    dq, delta = dq_k(q, k, v, o, do, lse, scale)
    dq_pl, delta_p = dq_p(q, k, v, o, do, lse, scale)
    dk, dv = dkdv(q, k, v, do, lse, delta, scale)
    dk_p, dv_p = dkdv_p(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    pairs = {n_fwd: [(o, o_p), (lse, lse_p)], n_dq: [(dq, dq_pl), (delta, delta_p)],
             n_dkdv: [(dk, dk_p), (dv, dv_p)]}
    out = {}
    for name, outs in pairs.items():
        errs = [rel_err(a, b) for a, b in outs]
        finite = all(bool(torch.isfinite(a).all()) for a, _ in outs)
        out[name] = {"rel_err": max(errs), "max_abs_err": max(max_abs(a, b) for a, b in outs),
                     "finite": finite}
        if not finite or max(errs) > REL_TOL:
            raise AssertionError(f"{name} at {shape}, Lk={Lk}, causal={causal}: rel err "
                                 f"{errs} (tol {REL_TOL}), finite={finite}")
    if causal and Lk > Lq:
        # keys that no query sees (top-left: j >= Lq) get exactly zero
        unseen = max(float(dk[:, Lq:].abs().max()), float(dv[:, Lq:].abs().max()))
        out["unseen_keys_max_abs_grad"] = unseen
        if unseen != 0.0:
            raise AssertionError(f"dk/dv of unseen keys are not zero: {unseen}")
    # the autograd function end to end against dense attention's autograd,
    # with the top-left causal mask as an explicit mask
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    if flash:
        ya = A.FlashAttention.apply(qa, ka, va, scale, causal)
    else:
        ya = A.SplashAttention.apply(qa, ka, va, scale)
    ga = torch.autograd.grad(ya, (qa, ka, va), do)
    qd, kd, vd = (t.detach().float().requires_grad_() for t in (q, k, v))
    keep = torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril() if causal else None
    yd = A.dense_attention(qd, kd, vd, mask=keep)
    gd = torch.autograd.grad(yd, (qd, kd, vd), do.float())
    e2e = [rel_err(ya, yd)] + [rel_err(a, b) for a, b in zip(ga, gd)]
    if max(e2e) > REL_TOL:
        raise AssertionError(f"autograd vs dense at {shape}, Lk={Lk}: rel errs {e2e}")
    out["autograd_vs_dense_rel_err"] = max(e2e)
    if not timed:
        return out

    work = _attention_work(B, Lq, Lk, H, D, causal)
    args = {n_fwd: (q, k, v, scale), n_dq: (q, k, v, o, do, lse, scale),
            n_dkdv: (q, k, v, do, lse, delta, scale)}
    # the library yardstick: PyTorch's fused attention, forward and backward
    # (its backward computes dq, dk and dv in one call; its is_causal is
    # top-left too)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    yt = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    lib_bwd = device_ms(lambda: torch.autograd.grad(yt, (qt, kt, vt), dot, retain_graph=True))
    library = {n_fwd: lib_fwd, n_dq: lib_bwd, n_dkdv: lib_bwd}
    for name, (kernel_fn, plain_fn) in ks.items():
        bound, by = _bound(*work[name])
        a = args[name]
        ms, retakes = device_ms(lambda: kernel_fn(*a))
        plain_ms, plain_retakes = device_ms(lambda: plain_fn(*a), reps=5)
        lib_ms, lib_retakes = library[name]
        # profiles taken again (records lost) behind ms, plain_ms and library_ms
        out[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                         bound_by=by, profile_retakes=retakes + plain_retakes + lib_retakes)
    return out


def check_fresh_thread() -> dict:
    """The forward and dQ as the first launches of a host thread that has
    made no CUDA call (autograd runs the backward on such a thread): the
    Hopper kernels' tensor maps need the thread's context current."""
    import threading

    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (_randn((2, 200, 4, 64), g) for _ in range(4))
    o, lse = A.attention_fwd_plain(q, k, v, 0.125)
    errors = []

    def body():
        try:
            A.attention_fwd(q, k, v, 0.125)
            A.attention_bwd_dq(q, k, v, o, do, lse, 0.125)
            torch.cuda.synchronize()
        except Exception as e:  # raised again on the main thread below
            errors.append(e)

    for _ in range(2):
        thread = threading.Thread(target=body)
        thread.start()
        thread.join()
    if errors:
        raise AssertionError(f"a launch from a fresh host thread failed: {errors[0]!r}")
    return {"fresh_thread_launches": "ok"}


ROUTE_HEAD_DIMS = (128, 256, 320, 384, 448, 512, 576, 640, 768, 832, 1024, 2048, 2112)


def check_routes() -> dict:
    """The device kernel the forward, dQ and dK/dV entry points run at each
    head dim, from the profile of one causal call (one kernel each), against
    ``device_kernels``' routing."""
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(6)
    routes = {"forward": {}, "dq": {}, "dkdv": {}}
    for d in ROUTE_HEAD_DIMS:
        q = _randn((1, 128, 2, d), g)
        o, lse = A.attention_fwd(q, q, q, d ** -0.5)
        delta = A.attention_bwd_delta_plain(o, q)
        calls = {"forward": (lambda: A.attention_fwd(q, q, q, d ** -0.5), 0),
                 "dq": (lambda: A.attention_bwd_dq(q, q, q, o, q, lse, d ** -0.5), 1),
                 "dkdv": (lambda: A.attention_bwd_dkdv(q, q, q, q, lse, delta, d ** -0.5), 2)}
        for kind, (fn, at) in calls.items():
            fn()
            for _ in range(5):   # a profile that lost the kernel's record is taken again
                rows = kernel_times(fn, reps=1)
                names = [key for _, key, _ in rows if "attn_" in key]
                if names:
                    break
            want = A.device_kernels(d)[at]
            if len(names) != 1 or not re.search(rf"::{want}[<(]", names[0]):
                raise AssertionError(f"the {kind} at D = {d} ran {names}, want {want}")
            routes[kind][d] = want
    return {"kernel_by_head_dim": routes}


def check_f32_cross_length() -> dict:
    """f32 causal attention with Lq != Lk on the card, which the JAX package
    hands to its flash kernel: ``impl="auto"`` and ``"flash"`` compute its
    top-left function (through dense; the kernels take bf16) and launch no
    kernel."""
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for lq, lk in ((128, 256), (256, 128)):
        q = torch.randn(2, lq, 2, 64, generator=g, device="cuda")
        k, v = (torch.randn(2, lk, 2, 64, generator=g, device="cuda") for _ in range(2))
        A.reset_launch_counts()
        got = [A.dot_product_attention(q, k, v, causal=True, impl=impl) for impl in ("auto", "flash")]
        o, _ = A.flash_fwd_plain(q, k, v, 64 ** -0.5, True)
        errs = [rel_err(x, o) for x in got]
        if max(errs) > 1e-5 or sum(A.launch_counts().values()) != 0:
            raise AssertionError(f"f32 causal {lq}x{lk}: rel errs {errs} against the top-left "
                                 f"function, launches {A.launch_counts()}")
        out[f"{lq}x{lk}"] = max(errs)
    return {"f32_causal_cross_length_rel_err": out}


def phase_kernels(ctx) -> None:
    import torch
    # the largest error of each wrapper: over every shape, and over D = 256,
    # 384 and 768
    worst: dict[str, float] = {}
    worst_at = {256: {}, 384: {}, 768: {}}
    log("kernels", **check_fresh_thread())
    log("kernels", **check_routes())
    log("kernels", **check_f32_cross_length())

    def record(res, shape, log_it=True, **where):
        for name, r in res.items():
            if isinstance(r, dict):
                worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
                if shape[3] in worst_at:
                    at = worst_at[shape[3]]
                    at[name] = max(at.get(name, 0.0), r["max_abs_err"])
        if log_it:
            log("kernels", shape=list(shape), **where, **res)

    for i, shape in enumerate(RAGGED_SHAPES):
        record(check_kernels(shape, seed=10 + i, timed=False), shape, path="splash")
    for seed, shape in zip((9, 31), MANY_HEADS_SHAPES):
        record(check_kernels(shape, seed=seed, timed=False), shape, path="splash")
        torch.cuda.empty_cache()
    for seed, (shape, Lk, causal) in zip((8, 41, 42, 43, 44), TRANSPOSED_CASES, strict=True):
        record(check_kernels(shape, seed=seed, timed=False, Lk=Lk, causal=causal, flash=True,
                             transposed=True),
               shape, path="flash", Lk=Lk, causal=causal, layout="[B, H, L, D] transposed")
    for i, (shape, Lk, causal) in enumerate(FLASH_CASES):
        record(check_kernels(shape, seed=20 + i, timed=False, Lk=Lk, causal=causal, flash=True),
               shape, path="flash", Lk=Lk, causal=causal)
    res = check_kernels(FLAGSHIP_SHAPE, seed=1, timed=True)
    flash = check_kernels(FLAGSHIP_SHAPE, seed=2, timed=True, causal=False, flash=True)
    d256 = check_kernels(D256_SHAPE, seed=3, timed=True)
    d384 = check_kernels(D384_SHAPE, seed=4, timed=True)
    d768 = check_kernels(D768_SHAPE, seed=5, timed=True)
    tp = check_kernels(TP_SHAPE, seed=6, timed=True)
    record(check_kernels(RING_SHAPE, seed=7, timed=False), RING_SHAPE, path="splash",
           used_by="ring (b): sp 2 with the sequence gathered")
    for path, r, causal, shape in (("splash", res, True, FLAGSHIP_SHAPE),
                                   ("flash", flash, False, FLAGSHIP_SHAPE),
                                   ("splash", d256, True, D256_SHAPE),
                                   ("splash", d384, True, D384_SHAPE),
                                   ("splash", d768, True, D768_SHAPE),
                                   ("splash", tp, True, TP_SHAPE)):
        record(r, shape, log_it=False)
        for name, nums in r.items():
            if name in KERNELS and "ms" in nums:
                log("kernels", path=path, shape=list(shape), causal=causal, kernel=name, **nums)
        log("kernels", path=path, shape=list(shape), causal=causal,
            autograd_vs_dense_rel_err=r["autograd_vs_dense_rel_err"])
    timed = {**res, **{n: flash[n] for n in FLASH_WRAPPERS}}
    for name in KERNELS:
        timed[name]["max_abs_err"] = worst[name]
    ctx["kernels"] = timed
    ctx["kernels_d256"] = {n: {**d256[n], "max_abs_err": worst_at[256][n]} for n in SPLASH_WRAPPERS}
    ctx["kernels_d384"] = {n: {**d384[n], "max_abs_err": worst_at[384][n]} for n in KERNELS_D384}
    ctx["kernels_d768"] = {n: {**d768[n], "max_abs_err": worst_at[768][n]} for n in KERNELS_D768}
    ctx["kernels_meshserve"] = {"attention_fwd": tp["attention_fwd"]}
    torch.cuda.synchronize()


# -- phase 3 ---------------------------------------------------------------------

PARITY_LOSS_RTOL = 2e-2    # bf16 compute rounds to ~0.4% at every layer output
PARITY_GRAD_RTOL = 5e-2    # per-parameter gradient norms, same reason
# (attention impl, width, heads, kv heads): the splash path at head dims
# 128, 192, 256, 384 and 768, and the flash path with grouped-query
# attention at head dims 64 and 256
PARITY_CONFIGS = (("auto", 256, 2, 0), ("flash", 256, 4, 2), ("auto", 384, 2, 0),
                  ("auto", 512, 2, 0), ("flash", 512, 2, 1), ("auto", 768, 2, 0),
                  ("auto", 768, 1, 0))


def phase_parity(ctx) -> None:
    """One training step of 2-layer bf16 configs on the card (kernels) and
    on the CPU (plain path), from the same weights and the same batch."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer

    for impl, width, heads, kv_heads in PARITY_CONFIGS:
        cfg = TransformerConfig(vocab_size=1000, num_layers=2, embed_dim=width, num_heads=heads,
                                num_kv_heads=kv_heads, mlp_dim=512, max_len=256,
                                dtype=torch.bfloat16, remat=False, attention_impl=impl)
        args = train_lm.parse_args(["--fused_ce", "--ce_block", "256"])
        ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)
        weights = TransformerLM(cfg, torch.Generator().manual_seed(0)).state_dict()
        out = {}
        for dev in ("cuda", "cpu"):
            tr = ElasticTrainer(train_lm.make_loss_fn(args), device=dev)

            def init():
                model = TransformerLM(cfg)
                model.load_state_dict(weights)
                return model, None

            state = tr.create_state(init, adamw(3e-4))
            A.reset_launch_counts()
            state, metrics = tr.step_fn(state, {"ids": torch.from_numpy(ids).to(dev)},
                                        torch.Generator(device=dev).manual_seed(0))
            out[dev] = (float(metrics["loss"]),
                        {n: float(p.grad.float().norm()) for n, p in state.model.named_parameters()},
                        A.launch_counts())
        (loss_c, g_c, n_c), (loss_h, g_h, n_h) = out["cuda"], out["cpu"]
        grad_rel = max(abs(g_c[n] - g_h[n]) / max(g_h[n], 1e-30) for n in g_h)
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        log("parity", attention=impl, head_dim=cfg.head_dim, kv_heads=cfg.kv_heads,
            loss_card=loss_c, loss_cpu=loss_h, loss_rel=loss_rel, grad_norm_max_rel=grad_rel,
            launches_card=n_c, launches_cpu=n_h, loss_rtol=PARITY_LOSS_RTOL,
            grad_rtol=PARITY_GRAD_RTOL)
        if not (math.isfinite(loss_c) and loss_rel <= PARITY_LOSS_RTOL
                and grad_rel <= PARITY_GRAD_RTOL):
            raise AssertionError(f"card and CPU disagree on the 2-layer {impl} step at "
                                 f"head dim {cfg.head_dim}")
        used = FLASH_WRAPPERS if impl == "flash" else SPLASH_WRAPPERS
        want = {n: cfg.num_layers if n in used else 0 for n in n_c}
        if n_c != want or max(n_h.values()) != 0:
            raise AssertionError(f"the card's {impl} step must launch its path's kernels once "
                                 f"per layer and no others, the CPU step none: {n_c} / {n_h}")


# -- phases 4 and 5 ----------------------------------------------------------------

FLAGSHIP_ARGS = ["--layers", "12", "--embed", "768", "--heads", "6", "--mlp", "3072",
                 "--vocab", "32000", "--seq_len", "1024", "--batch_size", "8",
                 "--fused_ce", "--lr", "3e-4"]
WARMUP_STEPS, TIMED_STEPS = 2, 10
FIRST_LOSS_RTOL = 1e-3   # splash and flash: one function, other kernels' rounding


def _drive_flagship(phase: str, extra_args: list[str], path_wrappers):
    """The 124M LM through train_lm's trainer on a fixed batch: 2 warm-up
    and 10 timed steps; ``path_wrappers`` must launch 12 times a step each
    and every other attention kernel none, and the profile must show each
    device kernel that one layer's attention launches at the run's head
    dim (``device_kernels``) 12 times a step and no other attention
    kernel.  Returns the losses and the launch counts of the timed steps."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import param_count
    from edl_tpu_torch.obs.flops import analytic_lm_flops_per_token, peak_tflops
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    args = train_lm.parse_args(FLAGSHIP_ARGS + extra_args)
    device = torch.device("cuda")
    cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)
    batch = {"ids": torch.from_numpy(ids).to(device)}
    gen = torch.Generator(device=device).manual_seed(3)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = A.launch_counts()
    losses = [float(x) for x in losses]
    tok_s = args.batch_size * args.seq_len * TIMED_STEPS / dt
    flops_tok = analytic_lm_flops_per_token(cfg.num_layers, cfg.embed_dim, cfg.mlp_dim,
                                            cfg.vocab_size, args.seq_len)
    peak = peak_tflops(torch.cuda.get_device_name(0))
    log(phase, nvidia_smi=smi_name_and_power_limit(), attention=args.attention,
        head_dim=cfg.head_dim, params=param_count(cfg), remat=cfg.remat,
        dtype=str(cfg.dtype), steps=TIMED_STEPS, step_ms=dt / TIMED_STEPS * 1e3,
        tokens_per_s=tok_s, tflops=tok_s * flops_tok / 1e12,
        mfu=(tok_s * flops_tok / 1e12 / peak) if peak else None,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=losses, launches=launches)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # unit-variance random logits put the first loss near ln V + 1/2
    if abs(losses[0] - math.log(args.vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln V = {math.log(args.vocab)}")
    if not losses[-1] < losses[0] - 0.1:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = cfg.num_layers * TIMED_STEPS
    want = {n: per_step if n in path_wrappers else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"(12 layers x {TIMED_STEPS} steps on the path's kernels)")

    # where the step's device time goes, by kernel, over two steps
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    total = sum(r[0] for r in rows)
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        groups[_kernel_group(key)] = groups.get(_kernel_group(key), 0.0) + us / 2 / 1e3
    log(f"{phase}_profile", nvidia_smi=smi_name_and_power_limit(),
        device_busy_ms_per_step=total / 2 / 1e3, wall_ms_per_step=dt / TIMED_STEPS * 1e3,
        ms_per_step_by_group=groups)
    for rank, (us, key, count) in enumerate(rows):
        if rank < 15 or "attn_" in key:
            log(f"{phase}_profile", kernel=key[:100], ms_per_step=us / 2 / 1e3,
                share=us / total, calls_per_step=count / 2)
    # the device's own record: per layer a forward and the backward's two
    # kernels (dQ with delta, then dK/dV), and no other attention kernel
    device_kernels = A.device_kernels(cfg.head_dim)
    attn_calls = {key: count / 2 for _, key, count in rows
                  if _kernel_group(key).startswith("attention")}
    by_kernel = {k: sum(n for key, n in attn_calls.items() if re.search(rf"::{k}[<(]", key))
                 for k in device_kernels}
    if (sum(attn_calls.values()) != len(device_kernels) * cfg.num_layers
            or any(n != cfg.num_layers for n in by_kernel.values())):
        raise AssertionError(f"the profile shows attention kernels per step {attn_calls}, "
                             f"want {cfg.num_layers} each of {device_kernels} and no other")
    A.reset_launch_counts()
    del trainer, state
    torch.cuda.empty_cache()
    return losses, launches


def phase_flagship(ctx) -> None:
    """The 124M LM on the default (splash) path; also the splash path's
    pre-scale of q and of dq, timed apart at the flagship's q shape."""
    losses, launches = _drive_flagship("flagship", [], SPLASH_WRAPPERS)
    ctx["first_loss"] = losses[0]
    _keep_launches(ctx, launches, SPLASH_WRAPPERS)
    log("flagship", **prescale_cost())


def prescale_cost() -> dict:
    """Device ms a flagship step spends scaling q before the splash kernels
    and dq after them (``SplashAttention``): 12 layers x 2 bf16 multiplies
    of a [8, 1024, 6, 128] tensor."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(8)
    x = _randn(FLAGSHIP_SHAPE, g)
    s_b = float(torch.tensor(FLAGSHIP_SHAPE[3] ** -0.5, dtype=torch.bfloat16))
    ms, retakes = device_ms(lambda: x * s_b)
    return {"prescale_ms_per_call": ms, "prescale_ms_per_step": 2 * 12 * ms,
            "prescale_profile_retakes": retakes}


def phase_flash(ctx) -> None:
    """The 124M LM with ``--attention flash``; its first loss against the
    splash path's (one step of it here if the flagship phase did not run)."""
    losses, launches = _drive_flagship("flash", ["--attention", "flash"], FLASH_WRAPPERS)
    splash_first = ctx.get("first_loss")
    if splash_first is None:
        splash_first = _first_loss(["--attention", "splash"])
    rel = abs(losses[0] - splash_first) / abs(splash_first)
    log("flash", first_loss=losses[0], splash_first_loss=splash_first, first_loss_rel=rel,
        rtol=FIRST_LOSS_RTOL)
    if rel > FIRST_LOSS_RTOL:
        raise AssertionError(f"flash path's first loss {losses[0]} != splash path's "
                             f"{splash_first} (rel {rel}, tol {FIRST_LOSS_RTOL})")
    _keep_launches(ctx, launches, FLASH_WRAPPERS)


def phase_d256(ctx) -> None:
    """The flagship's widths and depth at head dim 256 (``--heads 3``) on the
    splash path: the dK/dV kernel whose consumers split dK and dV runs
    every layer."""
    _, launches = _drive_flagship("d256", ["--heads", "3"], SPLASH_WRAPPERS)
    ctx["launches_d256"] = {n: launches[n] for n in SPLASH_WRAPPERS}


def phase_d384(ctx) -> None:
    """The flagship's widths and depth at head dim 384 (``--heads 2``) on the
    splash path: every layer runs the Hopper forward whose consumers split
    the output columns, the cluster dQ and the Hopper dK/dV whose blocks
    split the output columns."""
    _, launches = _drive_flagship("d384", ["--heads", "2"], tuple(KERNELS_D384))
    ctx["launches_d384"] = {n: launches[n] for n in KERNELS_D384}


def phase_d768(ctx) -> None:
    """The flagship's widths and depth at head dim 768 (``--heads 1``) on the
    splash path: every layer runs the Hopper forward on chunks of the output
    columns and the cluster dQ and dK/dV."""
    _, launches = _drive_flagship("d768", ["--heads", "1"], tuple(KERNELS_D768))
    ctx["launches_d768"] = {n: launches[n] for n in KERNELS_D768}


def _keep_launches(ctx, launches, path_wrappers) -> None:
    """Keep a main-path run's counts of its path's kernels for the kernels
    line."""
    ctx.setdefault("launches", {}).update({n: launches[n] for n in path_wrappers})


def _first_loss(extra_args: list[str]) -> float:
    """The flagship's first training-step loss on another path."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm

    args = train_lm.parse_args(FLAGSHIP_ARGS + extra_args)
    device = torch.device("cuda")
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(3)
    _, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(ids).to(device)}, gen)
    loss = float(metrics["loss"])
    del trainer, state
    torch.cuda.empty_cache()
    return loss


def _kernel_group(name: str) -> str:
    if "attn_" in name:
        return "attention (this repo's kernels)"
    if any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "reduce" in name:
        return "elementwise and reductions"
    return "other"


# -- phase 9 ---------------------------------------------------------------------

RESNET_ARGS = ["--model", "resnet50", "--width", "64", "--num_classes", "1000",
               "--image_size", "224", "--batch_size", "128"]
RESNET_WARMUP, RESNET_TIMED, RESNET_PROFILED = 3, 20, 2
# the card against the CPU: a ResNet18 step in f32 (TF32 off), each tensor
# within this share of its largest magnitude
RESNET_CPU_TOL = 1e-4
NATIVE_RECORDS = 1000


def _resnet_group(name: str) -> str:
    if "batch_norm" in name:
        return "batch norm"
    if any(tag in name.lower() for tag in ("conv", "xmma", "implicit", "cutlass", "cudnn",
                                           "wgrad", "dgrad", "fprop", "gemm", "nvjet")):
        return "convolution and matmul (cuDNN, cuBLAS)"
    if "elementwise" in name or "reduce" in name:
        return "elementwise and reductions"
    return "other"


def _resnet_batch(n, size, dtype, seed=0):
    """The JAX bench's fixed device batch: images ``normal`` from ``seed``,
    labels uniform in 1000 from ``seed + 1``."""
    import numpy as np
    import torch
    image = np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)
    label = np.random.default_rng(seed + 1).integers(0, 1000, (n,)).astype(np.int32)
    return {"image": torch.from_numpy(image).to("cuda", dtype),
            "label": torch.from_numpy(label).to("cuda")}


def _resnet_steps() -> dict:
    """ResNet50 at bs 128, 224², bf16, through train_resnet's trainer with
    the JAX bench's SGD (0.1, momentum 0.9, Nesterov): 3 warm-up and 20
    timed steps on a fixed batch; img/s, MFU, peak memory, and device ms a
    step by group from 2 profiled steps.  The fixed batch is memorised, so
    the loss must fall.  Then a few steps on a uint8 BGR batch through
    ``device_normalize``, held to its numpy formula."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_resnet
    from edl_tpu_torch.data import images
    from edl_tpu_torch.obs.flops import analytic_resnet_flops_per_image, peak_tflops
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train.state import sgd
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    args = train_resnet.parse_args(RESNET_ARGS)
    device = torch.device("cuda")
    init_fn, trainer, _, _ = train_resnet.build_trainer(args, device)
    state = trainer.create_state(init_fn, sgd(0.1, momentum=0.9, nesterov=True))
    batch = _resnet_batch(args.batch_size, args.image_size, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(3)
    losses = []
    for _ in range(RESNET_WARMUP):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(RESNET_TIMED):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = A.launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    img_s = args.batch_size * RESNET_TIMED / dt
    flops_img = analytic_resnet_flops_per_image(state.model, args.image_size)
    peak = peak_tflops(torch.cuda.get_device_name(0))
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=RESNET_PROFILED)
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        g = _resnet_group(key)
        groups[g] = groups.get(g, 0.0) + us / RESNET_PROFILED / 1e3
    # the same steps with cuDNN's autotuner on (off above, PyTorch's default)
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(RESNET_WARMUP):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_TIMED):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        img_s_tuned = args.batch_size * RESNET_TIMED / (time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.benchmark = False
    out = {"nvidia_smi": smi_name_and_power_limit(), "model": args.model,
           "batch": args.batch_size, "image_size": args.image_size, "dtype": "bfloat16",
           "steps": RESNET_TIMED, "img_s_per_card": img_s, "wall_ms_per_step": dt / RESNET_TIMED * 1e3,
           "train_flops_per_image": flops_img, "tflops": img_s * flops_img / 1e12,
           "mfu": (img_s * flops_img / 1e12 / peak) if peak else None,
           "device_busy_ms_per_step": sum(r[0] for r in rows) / RESNET_PROFILED / 1e3,
           "device_ms_per_step_by_group": groups, "max_memory_allocated": peak_mem,
           "losses": losses, "attention_launches": launches,
           "img_s_per_card_cudnn_benchmark": img_s_tuned}
    log("resnet", **out)
    total = sum(r[0] for r in rows)
    for rank, (us, key, count) in enumerate(rows[:15]):
        log("resnet_profile", kernel=key[:100], group=_resnet_group(key),
            ms_per_step=us / RESNET_PROFILED / 1e3, share=us / total,
            calls_per_step=count / RESNET_PROFILED)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ResNet loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the ResNet loss did not fall on a fixed batch: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the ResNet step launched attention kernels: {launches}")

    # the uint8 path: device_normalize on the card against its numpy formula
    u8 = np.random.default_rng(4).integers(0, 256, (args.batch_size, args.image_size,
                                                    args.image_size, 3)).astype(np.uint8)
    batch_u8 = {"image": torch.from_numpy(u8).to(device), "label": batch["label"]}
    got = images.device_normalize(batch_u8["image"][:8]).cpu().numpy()
    want = (u8[:8, ..., ::-1].astype(np.float32) - images.IMAGENET_MEAN) / images.IMAGENET_STD
    norm_err = float(np.abs(got - want).max())
    u8_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, metrics = trainer.step_fn(state, batch_u8, gen)
        u8_losses.append(metrics["loss"])
    torch.cuda.synchronize()
    u8_ms = (time.perf_counter() - t0) / 3 * 1e3
    u8_losses = [float(x) for x in u8_losses]
    norm_ms = event_ms(lambda: images.device_normalize(batch_u8["image"]))
    log("resnet", uint8_normalize_max_abs_err=norm_err, uint8_normalize_tol=1e-6,
        uint8_wall_ms_per_step=u8_ms, uint8_losses=u8_losses,
        device_normalize_event_ms=norm_ms)
    del trainer, state, batch, batch_u8
    torch.cuda.empty_cache()
    if norm_err > 1e-6 or not all(math.isfinite(x) for x in u8_losses):
        raise AssertionError(f"the uint8 path: normalize error {norm_err}, losses {u8_losses}")
    return out


def _resnet_remat(plain: dict) -> dict:
    """``--remat``: one step from the same weights on the same batch with and
    without it (the same loss, the same BN running stats: the recomputed
    forward leaves them alone, and the same parameters after the update: the
    recomputation's backward gives the plain gradients), then 3 warm-up and
    20 timed remat steps on the fixed batch: img/s and peak memory beside
    the plain step's."""
    import torch

    from edl_tpu_torch import train_resnet
    from edl_tpu_torch.train.state import sgd

    device = torch.device("cuda")
    batch = _resnet_batch(128, 224, torch.bfloat16)
    first = {}
    for remat in (False, True):
        args = train_resnet.parse_args(RESNET_ARGS + (["--remat"] if remat else []))
        init_fn, trainer, _, _ = train_resnet.build_trainer(args, device)
        state = trainer.create_state(init_fn, sgd(0.1, momentum=0.9, nesterov=True))
        gen = torch.Generator(device=device).manual_seed(3)
        state, metrics = trainer.step_fn(state, batch, gen)
        first[remat] = (float(metrics["loss"]),
                        torch.cat([b.flatten() for b in state.model.buffers()]),
                        [p.detach().clone() for p in state.model.parameters()])
    loss_diff = abs(first[True][0] - first[False][0]) / abs(first[False][0])
    stats_diff = float((first[True][1] - first[False][1]).abs().max()
                       / first[False][1].abs().max())
    # the worst leaf's difference, relative to that leaf's largest magnitude
    param_diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                     for a, b in zip(first[True][2], first[False][2]))
    del first
    for _ in range(RESNET_WARMUP):
        state, metrics = trainer.step_fn(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for _ in range(RESNET_TIMED):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"img_s_per_card": 128 * RESNET_TIMED / dt, "wall_ms_per_step": dt / RESNET_TIMED * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "plain_img_s_per_card": plain["img_s_per_card"],
           "plain_max_memory_allocated": plain["max_memory_allocated"],
           "first_loss_rel_diff": loss_diff, "first_step_bn_stats_rel_diff": stats_diff,
           "first_step_params_rel_diff": param_diff, "tol": RESUME_RTOL}
    log("resnet", remat=out)
    del trainer, state, batch
    torch.cuda.empty_cache()
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"non-finite remat losses: {[float(x) for x in losses]}")
    if max(loss_diff, stats_diff, param_diff) > RESUME_RTOL:
        raise AssertionError(f"the remat step is not the plain step: {out}")
    return out


RESNET_GROUP_STEPS, RESNET_GROUP_TIMED = 3, 10


def _world_bn_on_card(model, images) -> dict:
    """The BN of a world of 2 or more (``_WorldBatchNorm``), run in the NCCL
    group of one the caller has formed, at every BN shape of a ResNet50 step
    (bs 128, 224², bf16, channels_last, read from ``model``'s forward on
    ``images``), against ``torch.native_batch_norm`` (the world-1 path) on
    the same inputs from a seed: out and dx within 1e-2 of the native one's
    largest magnitude (bf16), dweight and dbias within 1e-3 (f32); and the
    wall ms of forward and backward of each (CUDA events over 5 calls after
    2, so the host's launches count where the card waits on them), summed
    over the step's BN layers."""
    from collections import Counter

    import torch

    from edl_tpu_torch.models.resnet import BN_EPS, BatchNorm, _WorldBatchNorm

    shapes: Counter = Counter()
    hooks = [m.register_forward_pre_hook(lambda _m, a: shapes.update([tuple(a[0].shape)]))
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device="cuda").manual_seed(21)

    def normal(shape, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t.to(dtype).contiguous(memory_format=torch.channels_last) if len(shape) == 4 \
            else t

    def fwd_bwd(world, x, w, b, dy):
        x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
        if world:
            out, _, _ = _WorldBatchNorm.apply(x, w, b)
        else:
            out, _, _ = torch.native_batch_norm(x, w, b, None, None, True, 0.0, BN_EPS)
        out.backward(dy)
        return out, x.grad, w.grad, b.grad

    def ms(fn):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    rows, errs = [], {"out": 0.0, "dx": 0.0, "dweight": 0.0, "dbias": 0.0}
    for shape, layers in sorted(shapes.items()):
        c = shape[1]
        x = (normal(shape, torch.float32) * 2 + 0.5).to(torch.bfloat16)
        w, b, dy = normal((c,), torch.float32) * 0.5 + 1, normal((c,), torch.float32), normal(shape)
        got, ref = fwd_bwd(True, x, w, b, dy), fwd_bwd(False, x, w, b, dy)
        for key, g, r in zip(errs, got, ref):
            errs[key] = max(errs[key], float((g.float() - r.float()).abs().max()
                                             / r.float().abs().max()))
        rows.append({"shape": list(shape), "layers": layers,
                     "world_wall_ms": ms(lambda: fwd_bwd(True, x, w, b, dy)),
                     "native_wall_ms": ms(lambda: fwd_bwd(False, x, w, b, dy))})
        del x, dy, got, ref
    out = {"shapes": rows, "rel_err": errs,
           "world_wall_ms_per_step": sum(r["world_wall_ms"] * r["layers"] for r in rows),
           "native_wall_ms_per_step": sum(r["native_wall_ms"] * r["layers"] for r in rows)}
    out["world_over_native_wall"] = out["world_wall_ms_per_step"] / out["native_wall_ms_per_step"]
    if sum(r["layers"] for r in rows) != 53:
        raise AssertionError(f"ResNet50 has 53 BN layers, the forward ran {rows}")
    if errs["out"] > 1e-2 or errs["dx"] > 1e-2 or errs["dweight"] > 1e-3 \
            or errs["dbias"] > 1e-3:
        raise AssertionError(f"the world BN disagrees with native_batch_norm: {errs}")
    return out


def _resnet_group_of_one(plain_img_s: float | None) -> dict:
    """BN's world-1 branch: 3 ResNet50 steps (bs 128, 224², bf16, the fixed
    batch) with no process group, then 3 from the same weights in an NCCL
    group of one, formed as the elastic phase forms it, with cuDNN's
    deterministic algorithms on for both: the losses, the BN running stats
    and the parameters equal to the bit, and the profile of a step holds as
    many NCCL kernels as the gradient reduction issues (one a gradient
    dtype), so BN adds none.  img/s over 10 steps with and without the
    group, beside the phase's fixed-batch figure.  In the group, the BN of
    a larger world held to the native one (``_world_bn_on_card``), and the
    step's img/s and device ms with every BN on that branch."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_resnet
    from edl_tpu_torch.models import resnet as resnet_model
    from edl_tpu_torch.train.state import sgd
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    from edl_tpu_torch.utils.network import find_free_port

    t_part = time.perf_counter()
    args = train_resnet.parse_args(RESNET_ARGS)
    device = torch.device("cuda", 0)
    batch = _resnet_batch(args.batch_size, args.image_size, torch.bfloat16)

    def steps():
        init_fn, trainer, _, _ = train_resnet.build_trainer(args, device)
        state = trainer.create_state(init_fn, sgd(0.1, momentum=0.9, nesterov=True))
        gen = torch.Generator(device=device).manual_seed(3)
        losses = []
        for _ in range(RESNET_GROUP_STEPS):
            state, metrics = trainer.step_fn(state, batch, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        return trainer, state, gen, [float(x) for x in losses]

    def img_s(trainer, state, gen):
        trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_GROUP_TIMED):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        return args.batch_size * RESNET_GROUP_TIMED / (time.perf_counter() - t0)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer, state, gen, plain_losses = steps()
        plain = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        del trainer, state
        torch.cuda.empty_cache()
        torch.cuda.set_device(device)
        store = dist.TCPStore("127.0.0.1", find_free_port(), 1, True)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0, device_id=device)
        try:
            trainer, state, gen, losses = steps()
            if trainer.world_size != 1 or dist.get_backend() != "nccl":
                raise AssertionError(f"world {trainer.world_size}, backend {dist.get_backend()}")
            differing = [k for k, v in state.model.state_dict().items()
                         if not torch.equal(v, plain[k])]
            grad_dtypes = {p.grad.dtype for p in state.model.parameters() if p.grad is not None}
            rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
            torch.backends.cudnn.deterministic = deterministic
            with_group = img_s(trainer, state, gen)
            world_bn = _world_bn_on_card(state.model, batch["image"])
            # the whole step with every BN on the world branch: in a group
            # of one its all-reduces are the identity and its statistics
            # are this rank's, so only its speed differs
            world = resnet_model._world
            resnet_model._world = lambda: 2
            try:
                rows_world = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
                world_bn["step"] = {
                    "img_s_per_card_world_bn": img_s(trainer, state, gen),
                    "img_s_per_card_native_bn": with_group,
                    "device_ms_world_bn": sum(us for us, _, _ in rows_world) / 2e3,
                    "device_ms_native_bn": sum(us for us, _, _ in rows) / 2e3,
                    "launches_world_bn": sum(n for _, _, n in rows_world) / 2,
                    "launches_native_bn": sum(n for _, _, n in rows) / 2}
            finally:
                resnet_model._world = world
        finally:
            dist.destroy_process_group()
            del store
        without_group = img_s(trainer, state, gen)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    nccl = {key: count / 2 for _, key, count in rows if re.search(r"nccl|onerank", key, re.I)}
    # the flat gradient buffer of each dtype, the loss riding the f32 one
    want_nccl = len(grad_dtypes | {torch.float32})
    out = {"nvidia_smi": smi_name_and_power_limit(), "model": "resnet50", "batch": 128,
           "losses_group": losses, "losses_no_group": plain_losses,
           "state_tensors_differing": differing, "nccl_kernels_per_step": nccl,
           "nccl_calls_per_step": sum(nccl.values()), "nccl_calls_want": want_nccl,
           "img_s_per_card_group_of_one": with_group, "img_s_per_card_no_group": without_group,
           "img_s_per_card_fixed_batch": plain_img_s, "world_bn": world_bn,
           "seconds": time.perf_counter() - t_part}
    log("resnet", group_of_one=out)
    del trainer, state
    torch.cuda.empty_cache()
    if losses != plain_losses or differing:
        raise AssertionError(f"the NCCL group of one changed the ResNet step: losses {losses} "
                             f"vs {plain_losses}, state differing: {differing[:5]}")
    if sum(nccl.values()) != want_nccl:
        raise AssertionError(f"NCCL kernels a step {nccl} != the gradient reduction's "
                             f"{want_nccl}: BN issued a collective at world 1")
    return out


def _resnet_card_vs_cpu() -> dict:
    """One ResNet18 (width 16, 32², batch 8, f32) training step on the card
    and on the CPU from the same weights: logits, loss, the updated BN
    buffers and the parameters after one SGD step."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.train.state import sgd

    x = np.random.default_rng(5).normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = np.random.default_rng(6).integers(0, 10, (8,))
    results = {}
    for dev in ("cuda", "cpu"):
        model = resnet.ResNet18(num_classes=10, width=16, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(7)).to(dev)
        opt = sgd(0.1, momentum=0.9, nesterov=True, weight_decay=1e-4)(model.parameters())
        logits = model(torch.from_numpy(x).to(dev))
        loss = F.cross_entropy(logits, torch.from_numpy(y).to(dev), label_smoothing=0.1)
        loss.backward()
        opt.step()
        results[dev] = {"logits": logits.detach().cpu(), "loss": loss.detach().cpu(),
                        **{k: v.detach().cpu() for k, v in model.state_dict().items()}}
    errs = {k: float((results["cuda"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in results["cpu"].items()}
    worst = max(errs, key=errs.get)
    out = {"tensors": len(errs), "logits_err": errs["logits"], "loss_err": errs["loss"],
           "worst": worst, "worst_err": errs[worst],
           "bn_buffers_worst_err": max(v for k, v in errs.items() if "running" in k),
           "params_worst_err": max(v for k, v in errs.items()
                                   if k not in ("logits", "loss") and "running" not in k),
           "tol": RESNET_CPU_TOL}
    log("resnet", card_vs_cpu=out)
    if errs[worst] > RESNET_CPU_TOL:
        raise AssertionError(f"the card's ResNet18 step is not the CPU's: {worst} {errs[worst]}")
    return out


def _resnet_resume(root) -> dict:
    """ResNet50 (bs 32) through train_resnet's trainer: 2 epochs of 2 steps
    straight, then 1 epoch with a checkpoint and a restore into a fresh
    trainer for the next: the next loss must equal the uninterrupted run's,
    and the BN buffers must come back as saved."""
    import torch

    from edl_tpu_torch import train_resnet

    args = train_resnet.parse_args(RESNET_ARGS + ["--batch_size", "32", "--epochs", "2",
                                                  "--warmup_epochs", "0.5"])
    device = torch.device("cuda")
    batches = [_resnet_batch(args.batch_size, args.image_size, torch.bfloat16, seed=10 + i)
               for i in range(4)]

    def data_fn(epoch):
        yield from batches[2 * epoch:2 * epoch + 2]

    def run(epochs, checkpoint_dir):
        init_fn, trainer, tx, _ = train_resnet.build_trainer(args, device, 2, checkpoint_dir)
        inner, losses = trainer.loss_fn, []

        def recording(*a):
            loss, aux = inner(*a)
            losses.append(loss.detach())
            return loss, aux

        trainer.loss_fn = recording
        state, meta = trainer.restore_or_create(init_fn, tx)
        restored = {k: v.clone() for k, v in state.model.named_buffers()}
        state, meta = trainer.fit(state, meta, data_fn, epochs=epochs)
        buffers = {k: v.clone() for k, v in state.model.named_buffers()}
        out = (state.step, restored, buffers, [float(x) for x in losses])
        del trainer, state
        torch.cuda.empty_cache()
        return out

    _, _, _, straight = run(2, "")
    step_a, _, saved, first = run(1, str(root))
    step_b, restored, _, second = run(2, str(root))
    diff = abs(second[0] - straight[2]) / abs(straight[2])
    same_buffers = all(torch.equal(restored[k], saved[k]) for k in saved)
    out = {"uninterrupted_losses": straight, "before_stop": first, "after_restore": second,
           "saved_step": step_a, "final_step": step_b, "next_loss_rel_diff": diff,
           "rtol": RESUME_RTOL, "bn_buffers_restored": same_buffers}
    log("resnet", resume=out)
    if (step_a, step_b) != (2, 4) or not same_buffers or diff > RESUME_RTOL:
        raise AssertionError(f"the ResNet run did not continue across the restore: {out}")
    return out


def _resnet_native(root) -> dict:
    """The native record library builds here and round-trips 1,000 records
    (native writer, native and Python readers); where ``cv2`` imports, the
    JPEG pipeline's host img/s on a synthetic set."""
    import numpy as np

    from edl_tpu_torch.native import build, imagedec, recordio

    if build.ensure_built() is None:
        raise AssertionError("the native record library did not build")
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(8)
    recs = [rng.bytes(int(n)) for n in rng.integers(1, 5000, NATIVE_RECORDS)]
    path = str(root / "records.rec")
    with recordio.RecordWriter(path, use_native=True) as w:
        for r in recs:
            w.write(r)
    readers = {}
    for native in (True, False):
        reader = recordio.RecordReader(path, use_native=native)
        readers[native] = list(reader)
        reader.close()
    out = {"library": build.OUT.name,
           "records": NATIVE_RECORDS, "round_trip": readers[True] == recs == readers[False],
           "imagedec": imagedec.available()}
    try:
        import cv2  # noqa: F401 — only to learn whether the JPEG path can run here
    except ImportError:
        out["jpeg_pipeline"] = "not timed: cv2 does not import on this machine"
    else:
        from edl_tpu_torch.data import images
        files = images.write_synthetic_imagenet(str(root / "synth"), n_files=2, per_file=128,
                                                size=256, classes=10)
        it = images.ImageBatches(files, 64, image_size=224, train=True, num_workers=8)
        t0 = time.perf_counter()
        n = sum(len(b["label"]) for b in it)
        out["jpeg_pipeline"] = {"img_s": n / (time.perf_counter() - t0), "images": n,
                                "decoder": "native" if imagedec.available() else "cv2"}
    log("resnet", native=out)
    if not out["round_trip"]:
        raise AssertionError("the native record files did not round-trip")
    return out


def phase_resnet(ctx) -> None:
    """ResNet50 training on the card: step timing, the uint8 path, BN in an
    NCCL group of one, ``--remat``, the card against the CPU, a checkpoint
    round trip, and the native record library."""
    import shutil
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_resnet"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ctx["resnet"] = _resnet_steps()
        _resnet_group_of_one(ctx["resnet"]["img_s_per_card"])
        _resnet_remat(ctx["resnet"])
        _resnet_card_vs_cpu()
        _resnet_resume(root / "ckpt")
        _resnet_native(root / "native")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 10 --------------------------------------------------------------------

RESUME_RTOL = 1e-4   # the same card, deterministic kernels, a bit-exact restore


class DictStore:
    """A coordination store in a dict (the store interface a trainer uses:
    put, get, get_prefix, delete, scoped_deadline)."""

    def __init__(self):
        self.kv: dict[str, bytes] = {}

    def put(self, key, value, lease_id=0):
        self.kv[key] = value
        return len(self.kv)

    def get(self, key):
        from edl_tpu_torch.coord.kv import KVRecord
        return KVRecord(key, self.kv[key]) if key in self.kv else None

    def get_prefix(self, prefix):
        from edl_tpu_torch.coord.kv import KVRecord
        return [KVRecord(k, v) for k, v in sorted(self.kv.items()) if k.startswith(prefix)], 0

    def delete(self, key):
        return self.kv.pop(key, None) is not None

    def scoped_deadline(self, seconds):
        import contextlib
        return contextlib.nullcontext(self)


def phase_resume(ctx) -> None:
    """Stop at an epoch's end, restore into a new trainer, and continue:
    the next loss must match an uninterrupted run's."""
    import shutil

    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster import recovery
    from edl_tpu_torch.cluster.env import TrainerEnv

    args = train_lm.parse_args(FLAGSHIP_ARGS + ["--steps_per_epoch", "2"])
    device = torch.device("cuda")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, 1000 * (epoch + 1))
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    def run(epochs, checkpoint_dir, store=None, tenv=None):
        _, trainer, init_fn, tx = train_lm.build_trainer(args, device, checkpoint_dir, store,
                                                         tenv)
        inner, losses = trainer.loss_fn, []

        def recording(*a):
            loss, aux = inner(*a)
            losses.append(loss.detach())
            return loss, aux

        trainer.loss_fn = recording
        state, meta = trainer.restore_or_create(init_fn, tx)
        resumed = (state.step, meta.next_epoch)
        state, meta = trainer.fit(state, meta, data_fn, epochs=epochs)
        out = (resumed, state.step, meta.next_epoch, [float(x) for x in losses])
        del trainer, state
        torch.cuda.empty_cache()
        return out

    # the restored trainer runs as under the launcher: a store and a stage,
    # so it writes the trainer half of the resize's recovery record
    store = DictStore()
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "chip-smoke", "EDL_TPU_POD_ID": "pod-0",
                       "EDL_TPU_CLUSTER_STAGE": "stage-1"})
    _, _, _, straight = run(2, "")
    _, step_a, next_a, first = run(1, str(ckpt_dir))
    (step_b0, epoch_b0), step_b, next_b, second = run(2, str(ckpt_dir), store, tenv)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    halves = recovery.load_recovery_records(store, "chip-smoke")
    half = halves.get("stage-1", {}).get("trainer", {}).get("pod-0")
    n = args.steps_per_epoch
    diff = abs(second[0] - straight[n]) / abs(straight[n])
    log("resume", uninterrupted_losses=straight, before_stop=first, after_restore=second,
        saved_step=step_a, restored_step=step_b0, restored_next_epoch=epoch_b0,
        final_step=step_b, final_next_epoch=next_b, next_loss_rel_diff=diff,
        rtol=RESUME_RTOL, recovery_trainer_half=half,
        restored_to_first_step=(half["first_step"] - half["restored"]) if half else None)
    if (step_a, next_a) != (n, 1) or (step_b0, epoch_b0) != (n, 1) or (step_b, next_b) != (2 * n, 2):
        raise AssertionError("step / next_epoch did not continue across the restore")
    if (list(halves) != ["stage-1"] or half is None or half.get("restore_source") != "storage"
            or not 0 < half["first_step"] - half["restored"] < 60):
        raise AssertionError(f"the restored trainer's recovery record: {halves}")
    before = max(abs(a - b) / abs(b) for a, b in zip(first, straight[:n]))
    if diff > RESUME_RTOL or before > RESUME_RTOL:
        raise AssertionError("the resumed run does not continue the uninterrupted one")


# -- phase 11 --------------------------------------------------------------------

# --synthetic files: 2 x 330 records an epoch at bs 128 = 5 full steps and one
# of 20 rows; the first run stops right after the save at epoch 1's second step
DATA_FILES, DATA_PER_FILE, DATA_STOP_STEP = 2, 330, 8
DATA_RECORDS = DATA_FILES * DATA_PER_FILE
DATA_JOB = "chip-smoke-data"
DATA_FAILOVER_STEP = 2    # epoch 0's steps trained before the data leader stops (of 6)


class _StopAfterSave(Exception):
    pass


class _DataLeaders:
    """The data service as a standalone deployment hosts it: elected
    ``DataLeaderHost`` candidates, each a journaled ``DataService`` on the
    port's ``RpcServer``, contending for the job's seat on the phase's store.
    ``failover()`` starts a standby, stops the seated leader and returns the
    time its server was down and its seat free, the time the standby took
    the seat, and the standby's endpoint."""

    def __init__(self, store):
        self.store = store
        self.hosts, self.threads = [], []

    def start(self):
        import threading

        from edl_tpu_torch.data.leader import DataLeaderHost

        host = DataLeaderHost(self.store, DATA_JOB, host="127.0.0.1")
        self.hosts.append(host)
        self.threads.append(threading.Thread(target=host.run, daemon=True,
                                             name=f"data-leader-{len(self.hosts)}"))
        self.threads[-1].start()
        return host

    def wait_seated(self, host, timeout=30.0):
        deadline = time.monotonic() + timeout
        while host.service is None:
            if time.monotonic() > deadline:
                raise AssertionError("the data leader did not take its seat")
            time.sleep(0.01)

    def failover(self) -> tuple[float, float, str]:
        seated = [i for i, h in enumerate(self.hosts) if h.service is not None]
        standby = self.start()
        for i in seated:
            self.hosts[i].stop()
            self.threads[i].join(timeout=30)
        gone = time.perf_counter()
        self.wait_seated(standby)
        return gone, time.perf_counter(), standby.endpoint

    def stop(self):
        for h in self.hosts:
            h.stop()
        for t in self.threads:
            t.join(timeout=30)


def _data_stand_in():
    """What a trainer is given: a store (``MemoryKV``), the job's elected data
    leader (``_DataLeaders``: a trainer given ``--data_leader`` resolves it
    with ``resolve_data_leader``), and a one-pod cluster record naming the
    seated leader's endpoint as the pod's, which a trainer without the flag
    resolves as the launcher's leader; ``new_stage(endpoint)`` writes the
    record again with a new stage and that endpoint."""
    from edl_tpu_torch.cluster import paths
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.pod import Pod
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.utils import constants

    store = MemoryKV()
    leaders = _DataLeaders(store)
    first = leaders.start()
    leaders.wait_seated(first)

    def new_stage(endpoint: str):
        addr, port = endpoint.rsplit(":", 1)
        cluster = Cluster.from_pods([Pod("pod-0", addr=addr, port=int(port))])
        store.put(paths.key(DATA_JOB, constants.ETCD_CLUSTER, "cluster"),
                  cluster.to_json().encode())

    new_stage(first.endpoint)
    return store, leaders, new_stage


def _check_staged_copy() -> dict:
    """(d) Host batches of the data service's shapes (f32 images [128, 224,
    224, 3] from a seed, labels, mask, spans) through ``device_put_stream``
    on the card: each comes out in order, bit-equal to its host arrays, its
    spans on the host."""
    import numpy as np
    import torch

    from edl_tpu_torch.data.elastic_input import SPANS_KEY, device_put_stream

    rng = np.random.default_rng(12)
    host = [{"image": rng.normal(size=(128, 224, 224, 3)).astype(np.float32),
             "label": rng.integers(0, 1000, 128).astype(np.int32),
             "mask": (np.arange(128) < 128 - 40 * i).astype(np.float32),
             SPANS_KEY: [[i, 0, 128 - 40 * i]]} for i in range(3)]
    stream = device_put_stream(iter(host), "cuda")
    equal, order = [], []
    for i, (dev, spans) in enumerate(stream):
        order.append(spans)
        equal.append(all(dev[k].device.type == "cuda"
                         and torch.equal(dev[k].cpu(), torch.from_numpy(host[i][k]))
                         for k in ("image", "label", "mask")))
    out = {"batches": stream.batches, "bit_equal": equal,
           "spans_in_order": order == [h[SPANS_KEY] for h in host],
           "h2d_wait_s": stream.h2d_wait_s}
    if not (all(equal) and len(equal) == 3 and out["spans_in_order"]):
        raise AssertionError(f"(d) the staged copy is not the host batch: {out}")
    return out


def phase_data(ctx) -> None:
    """ResNet50 fed by the data service: ``train_resnet``'s own training
    function with ``--data_service`` at full width (bs 128, 224², bf16), one
    pod, the port's journaled DataService hosted by an elected
    ``DataLeaderHost``; 2 epochs of 660 records.  The first run resolves the
    service with ``--data_leader``; its seated leader is stopped after epoch
    0's second step and a standby takes the seat, and the run stops right
    after the save at epoch 1's second step.  The restore into a fresh
    trainer runs without the flag in a new cluster stage whose record names
    the successor as the pod's endpoint, so it resolves the service as a
    trainer under the launcher does.  Checks (a) exactly once and the ragged
    step's mask, (b) the BN buffers across the masked step, (c) the resumed
    epoch trains what the checkpoint lacks, (d) the staged copy, (e) the
    failover: the successor seated and serving, the trainer stepping on."""
    import torch

    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    _data_run(ctx, torch.device("cuda"), smi_name_and_power_limit())
    log("data", staged_copy=_check_staged_copy())


def _data_run(ctx, device, card: str) -> None:
    """The two runs of ``phase_data`` on ``device``, the leader failover in
    the first, and checks (a) to (c) and (e)."""
    import shutil
    import threading

    import torch

    from edl_tpu_torch import train_resnet
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.cluster.state import DataCheckpoint
    from edl_tpu_torch.data.data_server import DataService
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.utils import constants

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    argv = RESNET_ARGS + ["--data_service", "--synthetic", "1000", "--synthetic_files",
                          str(DATA_FILES), "--synthetic_per_file", str(DATA_PER_FILE),
                          "--data_dir", str(root / "data"), "--epochs", "2",
                          "--save_every_steps", "2", "--num_workers", "8"]
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": DATA_JOB, "EDL_TPU_POD_ID": "pod-0",
                       "EDL_TPU_CKPT_DIR": str(root / "ckpt")})
    # what the path did, read through three hooks that are taken out after:
    # the spans the trainer marks (it marks a batch's spans when it trains
    # it), each step's mask sum and BN buffers before and after its forward,
    # and each save's seconds, with a stop right after the mid-epoch save at
    # DATA_STOP_STEP in the first run
    trained, steps, saves, metas_served = [], [], [], []
    stop = [DATA_STOP_STEP]
    failover: dict = {}
    mark, make_loss_fn, save, get_batch_meta = (
        DataCheckpoint.mark_processed, train_resnet.make_loss_fn, CheckpointManager.save,
        DataService.get_batch_meta)

    def serving(self, *a, **kw):
        out = get_batch_meta(self, *a, **kw)
        if out.get("metas"):
            metas_served.append((id(self), time.perf_counter()))
        return out

    def marking(self, file_idx, begin, end):
        trained.append((int(self.reader_name.split("@e")[1].split("@")[0]), file_idx, begin, end))
        mark(self, file_idx, begin, end)

    def recording_loss_fn(args):
        inner = make_loss_fn(args)

        def loss_fn(model, extra, batch, gen):
            t = time.perf_counter()
            if len(steps) == DATA_FAILOVER_STEP and not failover:
                # the seated data leader stops a third of the way into epoch
                # 0; a standby takes the seat while the trainer steps on
                failover["thread"] = threading.Thread(
                    target=lambda: failover.update(zip(("gone", "seated", "successor"),
                                                       leaders.failover())),
                    name="data-failover")
                failover["thread"].start()
            before = torch.cat([b.flatten() for b in model.buffers()])
            out = inner(model, extra, batch, gen)
            steps.append((batch["mask"].sum(), before,
                          torch.cat([b.flatten() for b in model.buffers()]), out[0].detach(), t))
            return out
        return loss_fn

    def timed_save(self, step, state, meta=None, force=False):
        t0 = time.perf_counter()
        saved = save(self, step, state, meta, force)
        saves.append((step, time.perf_counter() - t0))
        if step in stop:
            raise _StopAfterSave(step)
        return saved

    store, leaders, new_stage = _data_stand_in()
    DataCheckpoint.mark_processed = marking
    train_resnet.make_loss_fn = recording_loss_fn
    CheckpointManager.save = timed_save
    DataService.get_batch_meta = serving
    A.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        try:
            train_resnet.train(train_resnet.parse_args(argv + ["--data_leader"]), device, tenv,
                               store)
            raise AssertionError("the first run did not stop after its mid-epoch save")
        except _StopAfterSave:
            pass
        first_s = time.perf_counter() - t0
        n_before = len(trained)
        stop.clear()
        if "thread" in failover:
            failover["thread"].join(timeout=60)
        if not failover.get("successor"):
            raise AssertionError(f"(e) no standby took the data leader's seat: {failover}")
        new_stage(failover["successor"])
        successor = id(leaders.hosts[-1].service)
        t0 = time.perf_counter()
        state, meta = train_resnet.train(train_resnet.parse_args(argv), device, tenv, store)
        second_s = time.perf_counter() - t0
        second_served = {sid for sid, t in metas_served if t > t0}
    finally:
        DataCheckpoint.mark_processed = mark
        train_resnet.make_loss_fn = make_loss_fn
        CheckpointManager.save = save
        DataService.get_batch_meta = get_batch_meta
        if "thread" in failover:
            failover["thread"].join(timeout=60)
        leaders.stop()
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = A.launch_counts()
    masks = [int(m) for m, _, _, _, _ in steps]
    losses = [float(x) for _, _, _, x, _ in steps]
    bn_kept = [bool(torch.equal(a, b)) for _, a, b, _, _ in steps]
    # host ms between consecutive steps' starts (a save or an epoch end
    # between two steps counts in that interval), within each run
    starts = [t for *_, t in steps]
    step_ms = [[(b - a) * 1e3 for a, b in zip(run[:-1], run[1:])]
               for run in (starts[:DATA_STOP_STEP], starts[DATA_STOP_STEP:])]
    del state
    torch.cuda.empty_cache()

    # (a) every record of each epoch trained once; the ragged step's mask
    every = {(f, r) for f in range(DATA_FILES) for r in range(DATA_PER_FILE)}
    counts = {}
    for e, f, b, t in trained:
        for r in range(b, t):
            counts[(e, f, r)] = counts.get((e, f, r), 0) + 1
    once = {e: sorted({(f, r) for (ee, f, r) in counts if ee == e}) == sorted(every)
            and all(c == 1 for (ee, _, _), c in counts.items() if ee == e) for e in (0, 1)}
    ragged = DATA_RECORDS % 128
    want_masks = [128] * 5 + [ragged] + [128, 128] + [128] * 3 + [ragged]
    # (c) the resumed epoch trains exactly what the checkpoint lacks
    stopped = {(f, r) for e, f, b, t in trained[:n_before] if e == 1 for r in range(b, t)}
    resumed = {(f, r) for e, f, b, t in trained[n_before:] for r in range(b, t)}

    epochs = {a.epoch_no: a for a in meta.epochs}
    bench = {r["epoch"]: r for r in meta.user_defined.get("bench", [])}
    n_steps = sum(a.step_num for a in meta.epochs)
    # the segments' wall time: epoch 0 (steps 1-6) and the resumed part of
    # epoch 1 (steps 9-12), with and without the mid-epoch saves in them
    seg = {0: epochs[0].step_num * epochs[0].avg_step_time,
           1: (epochs[1].step_num - 2) * epochs[1].avg_step_time}
    seg_saves = {0: sum(t for step, t in saves if step <= 6),
                 1: sum(t for step, t in saves if 8 < step <= 12)}
    h2d = sum(r.get("h2d_wait_s", 0.0) for r in bench.values())
    input_wait = sum(r.get("input_wait_s", 0.0) for r in bench.values())
    fixed = ctx.get("resnet", {}).get("img_s_per_card")
    # (e) the data leader's failover in epoch 0: leader gone (its server
    # down, its seat free) to the trainer's next step, and to the first batch
    # meta the successor served
    gone = failover.get("gone")
    after = [t for t in starts if gone is not None and t > gone]
    served_after = [t for _, t in metas_served if gone is not None and t > gone]
    out_failover = {
        "at_step": DATA_FAILOVER_STEP, "successor": failover.get("successor"),
        "leader_gone_to_seated_s": (failover["seated"] - gone) if gone else None,
        "leader_gone_to_next_step_s": (after[0] - gone) if after else None,
        "leader_gone_to_successor_first_meta_s": (served_after[0] - gone) if served_after
        else None,
        "rebuild_grace_s": constants.data_rebuild_grace(),
        "resumed_run_resolves": "cluster record", "resumed_run_served_by_successor":
        second_served == {successor},
        "host_ms_around_failover": step_ms[0][max(0, DATA_FAILOVER_STEP - 2):
                                              DATA_FAILOVER_STEP + 3]}
    out = {"nvidia_smi": card, "model": "resnet50", "batch": 128,
           "image_size": 224, "dtype": "bfloat16", "records_per_epoch": DATA_RECORDS,
           "img_s_per_card_data_service_epoch0": DATA_RECORDS / seg[0],
           "img_s_per_card_data_service_resumed_segment": len(resumed) / seg[1],
           "img_s_per_card_data_service_without_saves": {
               "epoch0": DATA_RECORDS / (seg[0] - seg_saves[0]),
               "resumed_segment": len(resumed) / (seg[1] - seg_saves[1])},
           "saves_step_seconds": saves, "host_ms_between_steps": step_ms,
           "h2d_wait_s_total": h2d, "h2d_wait_ms_per_step": h2d / n_steps * 1e3,
           "input_wait_s_total": input_wait, "input_wait_ms_per_step": input_wait / n_steps * 1e3,
           "host_decode_img_s": {e: r.get("decode_img_s") for e, r in bench.items()},
           "img_s_per_card_fixed_batch_resnet_phase": fixed,
           "run_seconds": [first_s, second_s], "steps": n_steps, "masks": masks,
           "bn_kept_per_step": bn_kept, "losses": losses, "exactly_once": once,
           "stopped_records": len(stopped), "resumed_records": len(resumed),
           "attention_launches": launches, "leader_failover": out_failover, "bench": bench}
    log("data", **out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    if not all(once.values()) or masks != want_masks:
        raise AssertionError(f"(a) not exactly once: {once}, masks {masks} != {want_masks}")
    if bn_kept != [m < 128 for m in masks]:
        raise AssertionError(f"(b) the BN buffers across the masked steps: {bn_kept}")
    if len(stopped) != 2 * 128 or resumed != every - stopped:
        raise AssertionError(f"(c) the resumed epoch: {len(stopped)} stopped, {len(resumed)} "
                             f"resumed, {len(every - stopped - resumed)} missed")
    if (meta.next_epoch, n_steps) != (2, 12):
        raise AssertionError(f"the run did not end at epoch 2 after 12 steps: {out}")
    if gone is None or not failover.get("successor") or not after or not served_after:
        raise AssertionError(f"(e) the data leader's failover: {out_failover}")
    if second_served != {successor}:
        raise AssertionError("(e) the resumed run, resolving the service through the cluster "
                             "record, was not served by the seated successor alone")
    if any(launches.values()):
        raise AssertionError(f"the data path launched attention kernels: {launches}")
    if fixed is None:
        log("data", img_s_per_card_fixed_batch_resnet_phase="not measured: the resnet phase "
            "did not run in this call")


# -- phase 12 --------------------------------------------------------------------

ELASTIC_STEPS = 3
# the entry point's run (full width, depth cut to 2) and the 2-rank CPU world
ENTRY_ARGS = FLAGSHIP_ARGS + ["--layers", "2", "--steps_per_epoch", "2"]
WORLD_ARGS = ["--vocab", "1000", "--layers", "2", "--embed", "128", "--heads", "2",
              "--mlp", "512", "--seq_len", "256", "--batch_size", "2", "--steps_per_epoch", "2",
              "--fused_ce", "--ce_block", "256", "--lr", "3e-4", "--tp", "1"]
SUBPROCESS_TIMEOUT = 300


def _launch_env(rank: int, world: int, port: int, ckpt_dir, **extra) -> dict:
    """The env the elastic launcher exports to one trainer (one trainer a
    pod), with no coordination store."""
    import os
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    root = str(Path(__file__).resolve().parent)
    env.update({"PYTHONPATH": root, "EDL_TPU_JOB_ID": "chip-smoke",
                "EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINER_RANK_IN_POD": "0",
                "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "EDL_TPU_TRAINER_ENDPOINTS": ",".join(f"127.0.0.1:{port + r}"
                                                      for r in range(world)),
                "EDL_TPU_POD_ID": f"pod-{rank}", "EDL_TPU_POD_RANK": str(rank),
                "EDL_TPU_DEVICE_IDS": "0", "EDL_TPU_CKPT_DIR": str(ckpt_dir), **extra})
    return env


def _run_ranks(argv: list[str], world: int, ckpt_dir, **extra) -> list[tuple[str, str]]:
    """Run ``python -X importtime -m edl_tpu_torch.train_lm argv`` as
    ``world`` ranks; returns each rank's (stdout, stderr).  Their output goes
    to files, so no rank blocks on a full pipe while its peers wait for it
    in a collective; every process is stopped by the time this returns."""
    import subprocess
    import tempfile

    from edl_tpu_torch.utils.network import find_free_port
    port = find_free_port()
    root = Path(__file__).resolve().parent
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-X", "importtime", "-m", "edl_tpu_torch.train_lm",
                               *argv], cwd=root, env=_launch_env(r, world, port, ckpt_dir, **extra),
                              stdout=out, stderr=err, text=True)
             for r, (out, err) in enumerate(files)]
    try:
        for proc in procs:
            proc.wait(timeout=SUBPROCESS_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for proc, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        outs.append((out.read(), err.read()))
        out.close()
        err.close()
        if proc.returncode != 0:
            raise AssertionError(f"train_lm {argv} exited {proc.returncode}:\n"
                                 f"{outs[-1][0][-2000:]}\n{outs[-1][1][-4000:]}")
    return outs


def _imported(importtime_stderr: str) -> set[str]:
    return {line.split("|")[-1].strip() for line in importtime_stderr.splitlines()
            if line.startswith("import time:")}


def _elastic_group_of_one() -> dict:
    """3 flagship steps with no process group, then 3 from the same weights
    in an NCCL group of one: equal to the bit; the profile of a step and
    tokens/s with and without the group."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    from edl_tpu_torch.utils.network import find_free_port

    args = train_lm.parse_args(FLAGSHIP_ARGS)
    device = torch.device("cuda", 0)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)

    def steps(n):
        cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
        state = trainer.create_state(init_fn, tx)
        batch = {"ids": torch.from_numpy(ids).to(device)}
        gen = torch.Generator(device=device).manual_seed(3)
        losses = []
        for _ in range(n):
            state, metrics = trainer.step_fn(state, batch, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        return cfg, trainer, state, batch, gen, [float(x) for x in losses]

    def tokens_per_s(trainer, state, batch, gen):
        for _ in range(WARMUP_STEPS):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        return args.batch_size * args.seq_len * TIMED_STEPS / (time.perf_counter() - t0)

    *_, plain_state, _, _, plain_losses = steps(ELASTIC_STEPS)
    plain = {n: t.detach().clone() for n, t in plain_state.model.state_dict().items()}
    del plain_state
    torch.cuda.empty_cache()

    torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", find_free_port(), 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0, device_id=device)
    try:
        A.reset_launch_counts()
        cfg, trainer, state, batch, gen, losses = steps(ELASTIC_STEPS)
        launches = A.launch_counts()
        if trainer.world_size != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"world {trainer.world_size}, backend {dist.get_backend()}")
        differing = [n for n, t in state.model.state_dict().items() if not torch.equal(t, plain[n])]
        rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
        with_group = tokens_per_s(trainer, state, batch, gen)
    finally:
        dist.destroy_process_group()
        del store
    rows_plain = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    without_group = tokens_per_s(trainer, state, batch, gen)
    nccl = {key: (us / 2 / 1e3, count / 2) for us, key, count in rows
            if re.search(r"nccl|onerank", key, re.I)}
    plain_keys = {key for _, key, _ in rows_plain}
    reduction = {key: us / 2 / 1e3 for us, key, _ in rows if key not in plain_keys}
    out = {"nvidia_smi": smi_name_and_power_limit(), "losses_group": losses,
           "losses_no_group": plain_losses, "params_differing": differing,
           "launches": launches, "nccl_kernels": {k: {"ms_per_step": ms, "calls_per_step": n}
                                                  for k, (ms, n) in nccl.items()},
           "nccl_ms_per_step": sum(ms for ms, _ in nccl.values()),
           "reduction_kernels_ms_per_step": reduction,
           "device_busy_ms_per_step": sum(r[0] for r in rows) / 2 / 1e3,
           "device_busy_ms_per_step_no_group": sum(r[0] for r in rows_plain) / 2 / 1e3,
           "tokens_per_s_group": with_group, "tokens_per_s_no_group": without_group}
    del trainer, state
    torch.cuda.empty_cache()
    log("elastic", **out)
    if losses != plain_losses or differing:
        raise AssertionError(f"the NCCL group of one changed the step: losses {losses} vs "
                             f"{plain_losses}, parameters differing: {differing[:5]}")
    want = {n: cfg.num_layers * ELASTIC_STEPS if n in SPLASH_WRAPPERS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not nccl:
        raise AssertionError(f"no NCCL kernel in the step's profile; kernels the group added: "
                             f"{sorted(reduction)}")
    return launches


def _elastic_entry_point(ckpt_dir) -> dict:
    """The entry point under a launcher-shaped env with no store: 1 epoch,
    then 2, resuming at epoch 1; no msgpack import."""
    first, = _run_ranks(ENTRY_ARGS + ["--epochs", "1"], 1, ckpt_dir)
    second, = _run_ranks(ENTRY_ARGS + ["--epochs", "2"], 1, ckpt_dir)
    out = {}
    for name, (stdout, stderr) in (("first", first), ("second", second)):
        lines = [line for line in stdout.splitlines() if line.startswith("[train_lm]")]
        msgpack = sorted(m for m in _imported(stderr) if m.split(".")[0] == "msgpack")
        out[name] = {"lines": lines, "msgpack_imports": msgpack}
        if msgpack:
            raise AssertionError(f"the {name} run imported {msgpack}")
    log("elastic", entry_point=out)
    if ("resume_epoch=0" not in first[0] or "resume_epoch=1" not in second[0]
            or '"world": 1' not in second[0] or "rank=0/1 device=cuda" not in second[0]):
        raise AssertionError("the entry point did not resume at epoch 1 in a world of 1")
    return out


def _elastic_world_change(root) -> dict:
    """A 2-rank gloo world on the CPU saves an epoch; the card and the CPU
    each restore it at world 1 under EDL_TPU_LR_RESCALE=1 and train the
    next epoch from the same batches."""
    import os
    import shutil

    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.train import lr as lr_mod

    saved = root / "world2"
    _run_ranks(WORLD_ARGS + ["--device", "cpu", "--epochs", "1"], 2, saved,
               EDL_TPU_LR_RESCALE="1", OMP_NUM_THREADS="4")
    out = {}
    os.environ["EDL_TPU_LR_RESCALE"] = "1"
    try:
        for dev in ("cuda", "cpu"):
            ckpt = root / f"restore_{dev}"
            shutil.copytree(saved, ckpt)
            args = train_lm.parse_args(WORLD_ARGS + ["--device", dev])
            _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device(dev), str(ckpt))
            inner, losses = trainer.loss_fn, []

            def recording(*a, inner=inner, losses=losses):
                loss, aux = inner(*a)
                losses.append(loss.detach())
                return loss, aux

            trainer.loss_fn = recording
            state, meta = trainer.restore_or_create(init_fn, tx)
            restored = {"step": state.step, "next_epoch": meta.next_epoch,
                        "lr_scale": lr_mod.lr_scale(state),
                        "param_device": str(next(state.model.parameters()).device)}

            def data_fn(epoch, args=args):
                gen = train_lm.markov_corpus(args, 1000 * (epoch + 1))
                for _ in range(args.steps_per_epoch):
                    yield next(gen)

            state, meta = trainer.fit(state, meta, data_fn, epochs=2)
            out[dev] = {**restored, "losses": [float(x) for x in losses],
                        "epoch_worlds": [e.world_size for e in meta.epochs],
                        "final_lr_scale": lr_mod.lr_scale(state)}
            del trainer, state
    finally:
        del os.environ["EDL_TPU_LR_RESCALE"]
    torch.cuda.empty_cache()
    card, cpu = out["cuda"], out["cpu"]
    rel = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    log("elastic", world_change=out, next_loss_rel=rel, rtol=PARITY_LOSS_RTOL)
    for dev, r in out.items():
        if (r["step"], r["next_epoch"], r["lr_scale"], r["epoch_worlds"]) != (2, 1, 0.5, [2, 1]):
            raise AssertionError(f"the {dev} restore of the 2-rank checkpoint: {r}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"non-finite loss on {dev}: {r['losses']}")
    if card["param_device"] != "cuda:0" or rel > PARITY_LOSS_RTOL:
        raise AssertionError(f"the card's continuation is not the CPU's: rel {rel}")
    return out


def phase_elastic(ctx) -> None:
    """The distributed trainer: an NCCL group of one, the entry point under a
    launcher-shaped env, and a restore across a world change."""
    import shutil
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ctx["launches_elastic"] = _elastic_group_of_one()
        _elastic_entry_point(root / "entry")
        _elastic_world_change(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 13 --------------------------------------------------------------------

SERVE_ARGS = ["--layers", "12", "--embed", "768", "--heads", "6", "--mlp", "3072",
              "--vocab", "32000", "--max_len", "1024"]
SERVE_SLOTS = 16
SERVE_REQUESTS = 32              # kept to 32 for the script's time
SERVE_NEW = 32
# a token is held to the full-prefix forward's argmax where that forward's
# top-2 margin exceeds this (in logits, of unit scale at seed-0 weights: 8
# bf16 ulps at 4); the decode path's logits must lie within half of it of the
# full-prefix forward's, so a margin above it cannot flip
SERVE_MARGIN = 0.25


def _serve_model():
    """The flagship LM at seed-0 weights on the card, bf16, dense attention
    (serve_lm builds the same from the same seed)."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, embed_dim=768, num_heads=6,
                            mlp_dim=3072, max_len=1024, remat=False, attention_impl="dense",
                            dtype=torch.bfloat16)
    model = TransformerLM(cfg, torch.Generator().manual_seed(0)).to("cuda")
    return model.requires_grad_(False).eval()


def _argmax_check(model, prompts, outs) -> dict:
    """Each emitted token against the argmax of the full-prefix dense
    forward (no cache) on prompt + the tokens emitted before it, where that
    forward's top-2 margin exceeds SERVE_MARGIN."""
    import numpy as np
    import torch
    checked = wrong = 0
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = model(torch.from_numpy(seq[None]).cuda())[0, len(prompt) - 1:]
        top = logits.topk(2, dim=-1)
        sure = (top.values[:, 0] - top.values[:, 1] > SERVE_MARGIN).cpu().numpy()
        checked += int(sure.sum())
        wrong += int((sure & (top.indices[:, 0].cpu().numpy() != out)).sum())
    return {"tokens": int(sum(len(o) for o in outs)), "checked": checked, "mismatched": wrong}


def _serve_generate(model) -> dict:
    """(a) generate greedy on [8, 128] prompts, 64 new tokens; its decode
    logits teacher-forced on the emitted tokens against the full forward's."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.generate import generate
    from edl_tpu_torch.models.transformer import KVCache, decode_model
    B, P, N = 8, 128, 64
    prompt = torch.from_numpy(np.random.default_rng(10).integers(0, 32000, (B, P))).cuda()
    dm = decode_model(model)
    generate(dm, prompt, 4, temperature=0)             # first calls: cuBLAS handles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(dm, prompt, N, temperature=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if toks.shape != (B, N):
        raise AssertionError(f"generate returned {tuple(toks.shape)}, want {(B, N)}")
    seq = torch.cat([prompt, toks[:, :-1].long()], dim=1)
    with torch.inference_mode():
        full = model(seq)[:, P - 1:]
        cache = KVCache.zeros(dm.cfg, B, 256, "cuda")
        rows = [dm.head(dm(prompt, cache=cache, return_hidden=True)[:, -1])]
        for t in range(N - 1):
            rows.append(dm.head(dm(toks[:, t:t + 1], positions=cache.index[:, None],
                                   cache=cache, return_hidden=True)[:, 0]))
    dev = float((torch.stack(rows, 1) - full).abs().max())
    check = _argmax_check(model, list(prompt.cpu().numpy()), list(toks.cpu().numpy()))
    out = {"batch": B, "prompt": P, "new": N, "seconds": dt, "tokens_per_s": B * N / dt,
           "decode_vs_full_max_abs_logit": dev, "argmax": check}
    log("serve_generate", **out)
    if dev > SERVE_MARGIN / 2:
        raise AssertionError(f"the decode path's logits are {dev} from the full forward's "
                             f"(allowed {SERVE_MARGIN / 2})")
    return check


def _kernel_ms(fn, reps: int) -> tuple[float, float]:
    """Summed device time (ms) of the kernels one call of ``fn()`` launches,
    and their number, over ``reps`` profiled calls (cuBLAS may pick a kernel
    per call, so per-kernel counts need not divide by ``reps`` as
    ``device_ms`` asks)."""
    rows = kernel_times(fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3, sum(r[2] for r in rows) / reps


def _serve_prompts():
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, 32000, int(n)).astype(np.int32)
            for n in rng.integers(16, 901, SERVE_REQUESTS)]


def _start_server(log_path, extra=()):
    """serve_lm --continuous 16 at full width on the card (and ``extra``
    flags), output to a file."""
    import os
    import subprocess
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.serve_lm", *SERVE_ARGS, "--continuous",
             str(SERVE_SLOTS), "--max_new_tokens", str(SERVE_NEW), "--temperature", "0",
             "--port", "0", *extra],
            cwd=Path(__file__).resolve().parent, env=env, stdout=f, stderr=subprocess.STDOUT)


def _serve_wire(proc, log_path, prompts) -> tuple[list, dict]:
    """(b) 64 greedy requests over the wire from 16 client threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from edl_tpu_torch.rpc.client import RpcClient
    from edl_tpu_torch.serve_lm import request
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT
    while True:
        text = log_path.read_text()
        first = text.splitlines()[0] if text else ""
        if "[serve_lm] serving on" in first:
            endpoint = first.split("serving on")[1].split()[0]
            break
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"serve_lm never announced its endpoint: {text[-3000:]}")
        time.sleep(0.2)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_SLOTS) as pool:
        outs = list(pool.map(lambda p: request(endpoint, p[None], timeout=SUBPROCESS_TIMEOUT),
                             prompts))
    dt = time.perf_counter() - t0
    client = RpcClient(endpoint, 30)
    stats = client.call("stats")
    client.close()
    bad = [i for i, o in enumerate(outs) if o.shape != (1, SERVE_NEW)]
    if bad:
        raise AssertionError(f"requests {bad} returned the wrong length")
    out = {"endpoint": endpoint, "requests": len(prompts), "seconds": dt,
           "tokens_per_s": len(prompts) * SERVE_NEW / dt, "engine_stats": stats}
    log("serve_wire", **out)
    if stats["chunked_admissions"] < 1 or stats["requests_done"] != len(prompts):
        raise AssertionError(f"the server's stats show no chunked admission or lost "
                             f"requests: {stats}")
    return [np.asarray(o[0]) for o in outs], out


def _serve_engine(model, prompts) -> dict:
    """(c) an in-process engine on the same requests, and its pieces timed."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import KVCache
    from edl_tpu_torch.serving import ContinuousBatcher
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    engine = ContinuousBatcher(model, slots=SERVE_SLOTS, temperature=0.0)
    try:
        engine.warm(128)
        engine.warm(900)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        futs = [engine.submit(p, SERVE_NEW) for p in prompts]
        outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
        dt = time.perf_counter() - t0
        if any(len(o) != SERVE_NEW for o in outs):
            raise AssertionError(f"engine outputs of lengths {[len(o) for o in outs]}")
        stats = engine.stats()
        peak = torch.cuda.max_memory_allocated()
        # the decode loop at 16 live slots, at position 512 of a 1024 cache:
        # one dispatch is steps_per_sync steps, the engine's own _step
        T = engine._T
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.inference_mode():
            cache = KVCache.zeros(engine._mcfg, SERVE_SLOTS, 1024, "cuda")
            cache.index.fill_(512)
            toks = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")

            def dispatch():
                engine._step(cache, toks, gen)

            dispatch()
            torch.cuda.synchronize()
            reps = 4
            t1 = time.perf_counter()
            for _ in range(reps):
                dispatch()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) / reps / T * 1e3
            busy_ms, launches = _kernel_ms(dispatch, reps=2)
            busy_ms, launches = busy_ms / T, launches / T
            prefill = {}
            for P in engine._buckets:
                ids, lens = np.zeros((1, P), np.int32), np.full(1, P, np.int32)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                engine._prefill(ids, lens, gen)
                torch.cuda.synchronize()
                prefill[P] = {"wall_ms": (time.perf_counter() - t1) * 1e3,
                              "device_ms": _kernel_ms(lambda: engine._prefill(ids, lens, gen),
                                                      reps=2)[0]}
    finally:
        engine.stop()
    out = {"nvidia_smi": smi_name_and_power_limit(), "requests": len(prompts),
           "seconds": dt, "engine_tokens_per_s": len(prompts) * SERVE_NEW / dt,
           "decode_ms_per_step_16_slots": wall_ms, "decode_device_ms_per_step_16_slots": busy_ms,
           "decode_device_busy_share": busy_ms / wall_ms,
           "decode_kernels_per_step": launches, "prefill_ms_by_bucket_k1": prefill,
           "max_memory_allocated": peak, "steps_per_sync": T,
           "cache_bytes": KVCache.zeros(engine._mcfg, 1, 1, "meta").nbytes() * SERVE_SLOTS * 1024,
           "engine_stats": stats}
    log("serve_engine", **out)
    return {"outs": outs, **out}


def phase_serve(ctx) -> None:
    """Generation and serving at the flagship's width: generate, the entry
    point over the wire, an in-process engine; every token held to the
    full-prefix forward's argmax where its margin allows."""
    import shutil
    import signal

    import numpy as np
    import torch

    from edl_tpu_torch.models.generate import generate
    from edl_tpu_torch.models.transformer import decode_model
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log_path = root / "serve_lm.log"
    proc = _start_server(log_path)        # it loads while (a) runs
    try:
        A.reset_launch_counts()
        model = _serve_model()
        check_a = _serve_generate(model)
        prompts = _serve_prompts()
        wire_outs, wire = _serve_wire(proc, log_path, prompts)
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=60) != 0:
            raise AssertionError(f"serve_lm exited {proc.returncode}: "
                                 f"{log_path.read_text()[-3000:]}")
        eng = _serve_engine(model, prompts)
        launches = A.launch_counts()
        dm = decode_model(model)
        alone = [generate(dm, torch.from_numpy(p[None]), SERVE_NEW,
                          temperature=0).cpu().numpy()[0] for p in prompts]
        checks = {"generate": check_a, "wire": _argmax_check(model, prompts, wire_outs),
                  "engine": _argmax_check(model, prompts, eng["outs"])}
        equal = {"wire": sum(bool(np.array_equal(a, b)) for a, b in zip(wire_outs, alone)),
                 "engine": sum(bool(np.array_equal(a, b)) for a, b in zip(eng["outs"], alone))}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("serve", nvidia_smi=smi_name_and_power_limit(), argmax=checks,
        requests_equal_to_isolated_generate=equal, of=len(prompts), margin=SERVE_MARGIN,
        attention_kernel_launches=launches,
        wire_tokens_per_s=wire["tokens_per_s"], engine_tokens_per_s=eng["engine_tokens_per_s"],
        decode_ms_per_step_16_slots=eng["decode_ms_per_step_16_slots"],
        decode_device_busy_share=eng["decode_device_busy_share"],
        decode_kernels_per_step=eng["decode_kernels_per_step"],
        prefill_ms_by_bucket_k1=eng["prefill_ms_by_bucket_k1"],
        max_memory_allocated=eng["max_memory_allocated"])
    shutil.rmtree(root, ignore_errors=True)
    if any(c["mismatched"] for c in checks.values()):
        raise AssertionError(f"emitted tokens differ from the full-prefix argmax: {checks}")
    if any(c["checked"] < 0.1 * c["tokens"] for c in checks.values()):
        raise AssertionError(f"too few tokens clear the margin to be checked: {checks}")
    if any(launches.values()):
        raise AssertionError(f"the serving path launched attention kernels: {launches}")


# -- phase 14 --------------------------------------------------------------------

FLEET_SLOTS = 16
FLEET_BLOCK = 16
FLEET_SYSTEM = 512               # the shared system prompt, tokens (seed 21)
FLEET_NEW = 32
FLEET_REQUESTS = 16              # (a): one shared prompt + a 16-256 token suffix each
FLEET_SESSIONS, FLEET_TURNS = 8, 3
FLEET_ONE_SHOTS = 16             # (b): beside the sessions, half with each of turns 1 and 2
# (the two above kept to 16 for the script's time)
SPEC_PROMPTS, SPEC_NEW, SPEC_K = 16, 64, 3
SPEC_REPS = 3                    # timed dispatches of a speculative round


def _fleet_engine(model, **kw):
    from edl_tpu_torch.serving import ContinuousBatcher
    return ContinuousBatcher(model, slots=FLEET_SLOTS, temperature=0.0, **kw)


def _wall_and_device_ms(fn, reps: int = 5) -> dict:
    """Mean wall ms of ``reps`` back-to-back calls of ``fn()`` after a first
    one, and the device ms and the number of the kernels one call launches
    (``torch.profiler``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    device, launches = _kernel_ms(fn, reps=2)
    return {"wall": wall, "device": device, "launches": launches}


def _fleet_paged(model, system) -> dict:
    """(a) The shared-prompt traffic through a paged and an unpaged engine:
    one request alone (it commits the system prompt), then the other 31 at
    once."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import KVCache
    rng = np.random.default_rng(22)
    prompts = [np.concatenate([system, rng.integers(0, 32000, int(n)).astype(np.int32)])
               for n in rng.integers(16, 257, FLEET_REQUESTS)]
    out = {}
    for name, kw in (("paged", {"kv_block": FLEET_BLOCK}), ("unpaged", {})):
        engine = _fleet_engine(model, **kw)
        try:
            engine.warm(FLEET_SYSTEM + 256)
            engine.warm(256)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [engine.generate(prompts[0], FLEET_NEW, timeout=SUBPROCESS_TIMEOUT)]
            futs = [engine.submit(p, FLEET_NEW) for p in prompts[1:]]
            outs += [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
            dt = time.perf_counter() - t0
            stats = engine.stats()
            res = {"seconds": dt, "tokens_per_s": sum(len(o) for o in outs) / dt,
                   "engine_stats": stats, "outs": outs}
            if name == "paged":
                res["skipped_share"] = (stats["kv_prefill_tokens_skipped"]
                                        / stats["kv_prefill_tokens"])
                # one admission of a 640-token prompt: cold (a 512 chunk, then
                # the 128 suffix at its bucket), and from the committed system
                # prompt (its 32 blocks gathered, then the same suffix)
                gen = torch.Generator(device="cuda").manual_seed(0)
                suffix = np.ones(128, np.int32)
                kv = engine._kv
                chain = kv.match(np.concatenate([system, suffix]))
                if len(chain) * FLEET_BLOCK != FLEET_SYSTEM:
                    raise AssertionError(f"the system prompt matched {len(chain)} blocks")
                ids = [nd.block_id for nd in chain]

                def cold():
                    slab = KVCache.zeros(engine._mcfg, 1, engine._cache_len, "cuda")
                    engine._chunk_mid(slab, system, 0)
                    engine._chunk_final(slab, suffix, FLEET_SYSTEM, gen)

                def hit():
                    slab = KVCache.zeros(engine._mcfg, 1, engine._cache_len, "cuda")
                    kv.load_prefix_into(slab, ids, FLEET_SYSTEM)
                    engine._chunk_final(slab, suffix, FLEET_SYSTEM, gen)

                slab = KVCache.zeros(engine._mcfg, 1, engine._cache_len, "cuda")
                with torch.inference_mode():
                    res["admission_ms"] = {
                        "cold": _wall_and_device_ms(cold), "hit": _wall_and_device_ms(hit),
                        "gather": _wall_and_device_ms(
                            lambda: kv.load_prefix_into(slab, ids, FLEET_SYSTEM))}
        finally:
            engine.stop()
        out[name] = res
    stats = out["paged"]["engine_stats"]
    if stats["kv_prefix_hits"] < FLEET_REQUESTS // 2 or stats["kv_prefill_tokens_skipped"] <= 0:
        raise AssertionError(f"the paged engine reused too little: {stats}")
    if any(len(o) != FLEET_NEW for r in out.values() for o in r["outs"]):
        raise AssertionError("an engine returned the wrong length")
    out["equal_paged_unpaged"] = sum(bool(np.array_equal(a, b)) for a, b in
                                     zip(out["paged"]["outs"], out["unpaged"]["outs"]))
    out["prompts"] = prompts
    return out


def _fleet_replicas(model, system) -> dict:
    """(b) Two ReplicaServers on the card behind one Gateway over loopback
    RPC, on a MemoryKV: 8 sessions of 3 turns and 32 one-shot requests;
    after turn 2 the replica pinning the most sessions drains, migrating
    them to the survivor, which takes turn 3 from the migrated chains."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.gateway import Gateway, GatewayConfig, fleet
    from edl_tpu_torch.serving import ReplicaServer
    rng = np.random.default_rng(23)
    store = MemoryKV(sweep_period=0.1)
    servers = {}
    for rid in ("replica-a", "replica-b"):
        engine = _fleet_engine(model, kv_block=FLEET_BLOCK)
        engine.warm(FLEET_SYSTEM + 128)
        servers[rid] = ReplicaServer(store, "fleet", engine, replica_id=rid, host="127.0.0.1",
                                     ttl=10.0, advert_period=0.2)
    gw = Gateway(store, "fleet", GatewayConfig(max_inflight=64, max_queue=64,
                                               request_timeout_s=SUBPROCESS_TIMEOUT,
                                               hedge_after_s=10.0, poll_period_s=0.05,
                                               wait_slice_s=0.05))
    sessions = [f"conversation-{i}" for i in range(FLEET_SESSIONS)]
    prompts = {s: np.concatenate([system, rng.integers(0, 32000, int(rng.integers(32, 129)))
                                  .astype(np.int32)]) for s in sessions}
    held, done = [], []                # (prompt, out) pairs for the margin rule
    try:
        if not gw.wait_for_replicas(2, 30):
            raise AssertionError("the gateway never saw both replicas")

        def turn(shots):
            futs = {s: gw.submit(prompts[s], FLEET_NEW, session=s) for s in sessions}
            one = [np.concatenate([system, rng.integers(0, 32000, int(rng.integers(16, 257)))
                                   .astype(np.int32)]) for _ in range(shots)]
            ofuts = [gw.submit(p, FLEET_NEW) for p in one]
            outs = {s: f.result(timeout=SUBPROCESS_TIMEOUT) for s, f in futs.items()}
            done.extend(zip(one, [f.result(timeout=SUBPROCESS_TIMEOUT) for f in ofuts]))
            return outs

        t0 = time.perf_counter()
        for _ in range(2):
            outs = turn(FLEET_ONE_SHOTS // 2)
            for s in sessions:
                held.append((prompts[s], outs[s]))
                prompts[s] = np.concatenate([prompts[s], outs[s], rng.integers(
                    0, 32000, int(rng.integers(32, 129))).astype(np.int32)])
        def pins():
            out = {}
            for rid, srv in servers.items():
                while (sessions_now := srv._engine.kv_pinned_sessions()) is None:
                    time.sleep(0.01)    # an engine-thread pin raced the read
                out[rid] = set(sessions_now)
            return out

        # an engine pins a session before it answers, so every answered
        # turn is pinned by now; a request still running (a hedge's losing
        # leg) pins its session where it finishes: read the pins once both
        # engines are idle, and log what came in while they were not
        t_read = time.perf_counter()
        early = pins()
        after_turn2 = {"hedges": gw.stats()["counts"].get("hedges", 0),
                       "busy": {rid: [st["active_slots"], st["queue_depth"]] for rid, st in
                                ((r, srv._engine.stats()) for r, srv in servers.items())}}
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        while any(st["active_slots"] or st["queue_depth"]
                  for st in (srv._engine.stats() for srv in servers.values())):
            if time.monotonic() > deadline:
                raise AssertionError("the replicas did not go idle after turn 2")
            time.sleep(0.05)
        pinned = pins()
        after_turn2.update(idle_after_s=time.perf_counter() - t_read,
                           late_pins={rid: sorted(pinned[rid] - early[rid]) for rid in servers})
        victim = max(pinned, key=lambda r: (len(pinned[r]), r))
        survivor = next(r for r in servers if r != victim)
        t1 = time.perf_counter()
        if not servers[victim].drain(timeout=SUBPROCESS_TIMEOUT):
            raise AssertionError(f"{victim} did not drain")
        migration_s = time.perf_counter() - t1
        pins = fleet.list_session_pins(store, "fleet")
        moved = sorted(pinned[victim])
        if not moved or any(pins.get(s) != survivor for s in moved):
            raise AssertionError(f"the drained sessions {moved} are not pinned to {survivor}: "
                                 f"{pins}")
        gw._fleet.refresh()
        seng = servers[survivor]._engine
        skips = {}
        for s in moved:                # turn 3 of each migrated session, alone
            before = seng.stats()["kv_prefill_tokens_skipped"]
            out = gw.generate(prompts[s], FLEET_NEW, session=s, timeout=SUBPROCESS_TIMEOUT)
            skips[s] = seng.stats()["kv_prefill_tokens_skipped"] - before
            held.append((prompts[s], out))
        if any(v <= FLEET_SYSTEM for v in skips.values()):
            raise AssertionError(f"a migrated session's turn 3 skipped no more than the "
                                 f"system prompt: {skips}")
        with ThreadPoolExecutor(FLEET_SESSIONS) as pool:
            rest = [s for s in sessions if s not in moved]
            held.extend(zip([prompts[s] for s in rest], pool.map(
                lambda s: gw.generate(prompts[s], FLEET_NEW, session=s,
                                      timeout=SUBPROCESS_TIMEOUT), rest)))
        seconds = time.perf_counter() - t0
        stats = gw.stats()
        lat = np.asarray(gw.latencies())
        mig_out = servers[victim].serve_stats()["migration"]
        mig_in = servers[survivor].serve_stats()["migration"]
        engine_stats = {rid: srv._engine.stats() for rid, srv in servers.items()}
    finally:
        gw.close()
        for srv in servers.values():
            srv.close()
        store.close()
    every = held + done
    lost = FLEET_SESSIONS * FLEET_TURNS + FLEET_ONE_SHOTS - len(every)
    counts = stats["counts"]
    if lost or counts.get("requests_error", 0) or any(len(o) != FLEET_NEW for _, o in every):
        raise AssertionError(f"requests lost or short: {lost} missing, counts {counts}")
    if mig_in["sessions_in"] != len(moved) or mig_out["sessions_out"] != len(moved):
        raise AssertionError(f"migration counts {mig_out} / {mig_in} for {len(moved)} sessions "
                             f"(after turn 2: {after_turn2})")
    return {"pairs": every, "seconds": seconds, "requests": len(every),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "hedges": counts.get("hedges", 0), "failovers": counts.get("retries", 0),
            "drained": victim, "migrated_sessions": len(moved), "migration_seconds": migration_s,
            "pins_after_turn2": after_turn2,
            "migration": {"out": mig_out, "in": mig_in}, "turn3_skipped_tokens": skips,
            "engine_stats": engine_stats}


def _scatter_check(vmodel, M: int) -> dict:
    """The verify model's ``decode_scatter`` write on the card at its rows'
    edge: one verify call of L = SPEC_K + 1 tokens from a lane at M-2 (two
    rows kept, the last at M-1, two dropped) and a lane past M (all
    dropped), over a seeded cache, against the same call on a CPU copy of
    the model.  Every column not written must keep its bits, on the card
    and on the CPU, and the written ones must agree with the CPU's."""
    import copy

    import torch

    from edl_tpu_torch.models.transformer import KVCache
    L = SPEC_K + 1
    g = torch.Generator().manual_seed(25)
    idx = torch.tensor([M - 2, M + 3], dtype=torch.int32)
    ids = torch.randint(0, vmodel.cfg.vocab_size, (2, L), generator=g, dtype=torch.int32)
    pos = idx[:, None] + torch.arange(L)
    init = KVCache.zeros(vmodel.cfg, 2, M)
    for t in init.keys + init.values:
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))

    def run(model, device):
        cache = KVCache([t.to(device, copy=True) for t in init.keys],
                        [t.to(device, copy=True) for t in init.values], idx.to(device, copy=True))
        with torch.inference_mode():
            model(ids.to(device), positions=pos.to(device), cache=cache, return_hidden=True)
        return cache

    card = run(vmodel, "cuda")
    torch.cuda.synchronize()
    host = run(copy.deepcopy(vmodel).to("cpu"), "cpu")
    written = torch.zeros(2, M, dtype=torch.bool)
    written[0, M - 2:] = True
    moved = {"card": 0, "cpu": 0}
    for where, got in (("card", card), ("cpu", host)):
        for a, i in zip(got.keys + got.values, init.keys + init.values):
            cols = written[:, None, None, :] if a.shape[-1] == M else written[:, None, :, None]
            moved[where] += int(((a.cpu() != i) & ~cols).sum())
    # layer 0's rows are one projection of the embedding, so the card and
    # the CPU differ there by bf16 rounding alone; deeper layers also carry
    # the two attentions' rounding and are held to the bit rule only
    a, b = card.keys[0][0, :, :, M - 2:].cpu().float(), host.keys[0][0, :, :, M - 2:].float()
    rel = float((a - b).abs().max() / b.abs().max())
    res = {"idx": idx.tolist(), "L": L, "cache_len": M, "unwritten_changed": moved,
           "layer0_written_rel_err_vs_cpu": rel, "kept_at_end_changed": bool(
               (card.keys[0][0, :, :, M - 1].cpu() != init.keys[0][0, :, :, M - 1]).any()),
           "index": card.index.tolist()}
    if any(moved.values()) or not res["kept_at_end_changed"] or res["index"] != (
            idx + L).tolist():
        raise AssertionError(f"decode_scatter wrote outside its kept rows: {res}")
    if rel > 0.02:
        raise AssertionError(f"decode_scatter on the card disagrees with the CPU: {res}")
    return res


def _fleet_spec(model) -> dict:
    """(c) Speculative decoding with a self-draft and an adversarial 2-layer
    draft (seed 1), against the plain engine on the same prompts."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import KVCache, TransformerLM
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 32000, int(n)).astype(np.int32)
               for n in rng.integers(16, 257, SPEC_PROMPTS)]
    bad = TransformerLM(dataclasses.replace(model.cfg, num_layers=2),
                        torch.Generator().manual_seed(1)).to("cuda").requires_grad_(False).eval()
    out = {}
    for name, kw in (("plain", {}), ("self_draft", {"spec_k": SPEC_K, "draft_model": model}),
                     ("adversarial", {"spec_k": SPEC_K, "draft_model": bad})):
        engine = _fleet_engine(model, **kw)
        try:
            engine.warm(256)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = [engine.submit(p, SPEC_NEW) for p in prompts]
            outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
            dt = time.perf_counter() - t0
            res = {"seconds": dt, "tokens_per_s": sum(len(o) for o in outs) / dt,
                   "engine_stats": engine.stats(), "outs": outs}
            if name != "plain":
                B, R = FLEET_SLOTS, engine._spec_rounds
                with torch.inference_mode():
                    cache = KVCache.zeros(engine._mcfg, B, engine._cache_len, "cuda")
                    dcache = KVCache.zeros(engine._dcfg, B, engine._cache_len, "cuda")
                    toks = torch.zeros(B, dtype=torch.int32, device="cuda")

                    def dispatch():
                        cache.index.fill_(512)
                        engine._spec(cache, dcache, toks)

                    j = torch.arange(SPEC_K + 1, device="cuda")
                    feed = torch.zeros(B, SPEC_K + 1, dtype=torch.int32, device="cuda")

                    def verify():
                        cache.index.fill_(512)
                        engine._vmodel.head(engine._vmodel(
                            feed, positions=cache.index[:, None] + j, cache=cache,
                            return_hidden=True)).argmax(-1)

                    rnd, ver = _wall_and_device_ms(dispatch), _wall_and_device_ms(verify)
                res.update(round_wall_ms=rnd["wall"] / R, round_device_ms=rnd["device"] / R,
                           round_launches=rnd["launches"] / R, rounds_a_dispatch=R,
                           verify_wall_ms=ver["wall"], verify_device_ms=ver["device"],
                           verify_launches=ver["launches"],
                           accept_rate=res["engine_stats"]["spec_accept_rate"])
                if name == "self_draft":
                    res["scatter_edge"] = _scatter_check(engine._vmodel, engine._cache_len)
        finally:
            engine.stop()
        out[name] = res
    for name in ("self_draft", "adversarial"):
        out[name]["equal_to_plain"] = sum(bool(np.array_equal(a, b)) for a, b in
                                          zip(out[name]["outs"], out["plain"]["outs"]))
        if any(len(o) != SPEC_NEW for o in out[name]["outs"]):
            raise AssertionError(f"{name} returned the wrong length")
    if out["self_draft"]["accept_rate"] < 0.5:
        raise AssertionError(f"the self-draft accepted {out['self_draft']['accept_rate']}")
    out["prompts"] = prompts
    return out


def phase_fleet(ctx) -> None:
    """The LM serving fleet at the flagship's width: the paged pool against
    the unpaged engine, two replicas behind the gateway with a drain that
    migrates sessions, and speculative decoding; every token held to the
    full-prefix argmax where its margin allows."""
    import numpy as np
    import torch

    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    model = _serve_model()
    system = np.random.default_rng(21).integers(0, 32000, FLEET_SYSTEM).astype(np.int32)
    paged = _fleet_paged(model, system)
    reps = _fleet_replicas(model, system)
    spec = _fleet_spec(model)
    launches = A.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    checks = {"paged": _argmax_check(model, paged["prompts"], paged["paged"]["outs"]),
              "unpaged": _argmax_check(model, paged["prompts"], paged["unpaged"]["outs"]),
              "fleet": _argmax_check(model, *zip(*reps["pairs"])),
              "plain": _argmax_check(model, spec["prompts"], spec["plain"]["outs"]),
              "self_draft": _argmax_check(model, spec["prompts"], spec["self_draft"]["outs"]),
              "adversarial": _argmax_check(model, spec["prompts"], spec["adversarial"]["outs"])}
    drop = ("outs", "engine_stats")
    log("fleet_paged", **{k: ({kk: vv for kk, vv in v.items() if kk != "outs"}
                              if isinstance(v, dict) else v)
                          for k, v in paged.items() if k != "prompts"})
    log("fleet_replicas", **{k: v for k, v in reps.items() if k != "pairs"})
    log("fleet_spec", **{k: ({kk: vv for kk, vv in v.items() if kk != "outs"}
                             if isinstance(v, dict) else v)
                         for k, v in spec.items() if k != "prompts"})
    pstats = paged["paged"]["engine_stats"]
    log("fleet", nvidia_smi=smi_name_and_power_limit(), argmax=checks, margin=SERVE_MARGIN,
        attention_kernel_launches=launches,
        paged_tokens_per_s=paged["paged"]["tokens_per_s"],
        unpaged_tokens_per_s=paged["unpaged"]["tokens_per_s"],
        prefill_skipped_share=paged["paged"]["skipped_share"],
        kv_prefix_hits=pstats["kv_prefix_hits"], kv_prefix_misses=pstats["kv_prefix_misses"],
        admission_ms=paged["paged"]["admission_ms"],
        equal_paged_unpaged=paged["equal_paged_unpaged"], of=FLEET_REQUESTS,
        gateway_p50_s=reps["latency_p50_s"], gateway_p99_s=reps["latency_p99_s"],
        hedges=reps["hedges"], failovers=reps["failovers"],
        migrated_sessions=reps["migrated_sessions"], migration_seconds=reps["migration_seconds"],
        blocks_migrated=reps["migration"]["out"]["blocks_out"],
        spec={n: {k: v for k, v in spec[n].items() if k not in drop}
              for n in ("plain", "self_draft", "adversarial")},
        max_memory_allocated=peak)
    if any(c["mismatched"] for c in checks.values()):
        raise AssertionError(f"emitted tokens differ from the full-prefix argmax: {checks}")
    if any(c["checked"] < 0.1 * c["tokens"] for c in checks.values()):
        raise AssertionError(f"too few tokens clear the margin to be checked: {checks}")
    if any(launches.values()):
        raise AssertionError(f"the serving path launched attention kernels: {launches}")


# -- phase 15 --------------------------------------------------------------------

# the teacher (ResNet152) and the student (ResNet50vd), width 64, 1,000
# classes, 224², bf16 over f32 weights; a student batch of 128, a teacher
# batch of 16 (the reader's default)
DISTILL_ARGV = ["--device", "cuda", "--teacher_model", "resnet152", "--student_model",
                "resnet50vd", "--width", "64", "--classes", "1000", "--image_size", "224",
                "--batch_size", "128", "--teacher_batch_size", "16", "--teacher_epochs", "1",
                "--student_epochs", "1", "--service", "image-teacher"]
DISTILL_BATCHES = 4              # distinct pre-decoded host batches, cycled
DISTILL_TEACHER_STEPS = 20
DISTILL_WARMUP, DISTILL_TIMED = 2, 16
DISTILL_LEAVE, DISTILL_JOIN = 4, 8   # timed steps after which A stops and C starts
DISTILL_JOIN_BOUND_S = 30.0      # C must serve rows within this of its start
DISTILL_PAIR_TOL = 1e-2          # relative max error of the logits that came back
DISTILL_LOSS_RTOL = 1e-3         # the card's loss against float64 on the same logits
DISTILL_ROW_BYTES = 224 * 224 * 3 * 4 + 1000 * 4   # one row over the wire, in and out


def _distill_batches():
    """Four distinct pre-decoded f32 NHWC batches [128, 224, 224, 3] (standard
    normal, as the normalised output of ``images.py`` is) and 1,000-class
    labels, from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(13)
    return [{"image": rng.standard_normal((128, 224, 224, 3), dtype=np.float32),
             "label": rng.integers(0, 1000, 128).astype(np.int32)}
            for _ in range(DISTILL_BATCHES)]


def _rel(got, want) -> float:
    import numpy as np
    return float(np.abs(got - want).max() / np.abs(want).max())


def _float64_loss(logits, labels, teacher, alpha, T) -> float:
    """The student loss, ``alpha * CE + (1 - alpha) * T² * CE(logits / T,
    softmax(teacher / T))``, in float64 on the host."""
    import torch
    lg = logits.double().cpu()
    hard = torch.nn.functional.cross_entropy(lg, labels.long().cpu())
    if teacher is None:
        return float(hard)
    p = torch.softmax(teacher.double().cpu() / T, -1)
    soft = -(p * torch.log_softmax(lg / T, -1)).sum(-1).mean() * T * T
    return float(alpha * hard + (1 - alpha) * soft)


class _CountRecords:
    """A logging handler that counts the records of some loggers."""

    def __init__(self, names):
        import logging
        self.counts = dict.fromkeys(names, 0)
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda rec: self.counts.__setitem__(
            rec.name, self.counts.get(rec.name, 0) + 1)
        self.loggers = [logging.getLogger(n) for n in names]

    def __enter__(self):
        for lg in self.loggers:
            lg.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for lg in self.loggers:
            lg.removeHandler(self.handler)


def phase_distill(ctx) -> None:
    """Image distillation on one card: a ResNet152 teacher (20 SGD steps
    through ``train_teacher``) served by two ``TeacherServer``s behind a
    ``DiscoveryServer``; a ResNet50vd student through ``train_student`` with
    ``make_distill_source`` (2 warm-up and at least 16 timed steps); server A
    stops after timed step 4 and server C starts after step 8, and the
    student keeps stepping until C has served rows (30 s at most); then the
    same student step without the teacher.  Checks: pairing (with its
    control), order, rows served, the leave and the join, the loss against
    float64, the device."""
    import threading

    import numpy as np
    import torch

    from edl_tpu_torch import train_image_distill as tid
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.distill import teacher as teacher_mod
    from edl_tpu_torch.distill.discovery import DiscoveryServer
    from edl_tpu_torch.distill.predict_pool import PredictPool
    from edl_tpu_torch.distill.qps import run_probe
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    device = torch.device("cuda")
    args = tid.parse_args(DISTILL_ARGV)
    T, alpha = args.temperature, args.alpha
    t_phase = time.perf_counter()
    batches = _distill_batches()
    t0 = time.perf_counter()

    def teacher_data(epoch):
        for i in range(DISTILL_TEACHER_STEPS):
            yield batches[i % DISTILL_BATCHES]

    tmodel, tstate = tid.train_teacher(args, [], device, data_fn=teacher_data)
    torch.cuda.synchronize()
    teacher_train_s = time.perf_counter() - t0
    del tstate
    torch.cuda.empty_cache()

    # the teacher's own forward at the served bucket (16 rows), which is
    # also each bucket's first call on the card
    own = teacher_mod.module_teacher(tmodel, device=device)
    ref = [np.concatenate([own({"image": b["image"][r:r + 16]})["logits"]
                           for r in range(0, 128, 16)]) for b in batches]
    x16 = torch.from_numpy(batches[0]["image"][:16]).to(device)
    with torch.inference_mode():
        forward16_ms = event_ms(lambda: tmodel(x16), reps=10)
        # its device time and launches, against the events' wall (host launches)
        forward16_device_ms, forward16_launches = _kernel_ms(lambda: tmodel(x16), reps=3)
    del x16

    # every predict the servers run: (server, rows, start, wall ms, event ms,
    # current device, inference mode)
    records, made = [], [0]
    module_teacher = teacher_mod.module_teacher

    def timed_module_teacher(module, fetch_name="logits", device=None, mesh=None):
        inner, index = module_teacher(module, fetch_name, device, mesh), made[0]
        made[0] += 1

        def predict(feed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = inner(feed)
            end.record()
            end.synchronize()
            records.append((index, len(feed["image"]), t, (time.perf_counter() - t) * 1e3,
                            start.elapsed_time(end), torch.cuda.current_device(),
                            torch.is_inference_mode_enabled()))
            return out
        return predict

    requeues = [0]
    requeue = PredictPool._requeue

    def counting_requeue(self, task):
        requeues[0] += 1
        return requeue(self, task)

    # the student: every loss call's host time and its inputs
    steps = []
    distill_loss = tid.distill_loss

    def recording_loss(logits, labels, teacher_logits, alpha_, temperature):
        loss = distill_loss(logits, labels, teacher_logits, alpha_, temperature)
        steps.append((time.perf_counter(), logits.detach().clone(), labels.clone(),
                      None if teacher_logits is None else teacher_logits.clone(),
                      loss.detach()))
        return loss

    store = MemoryKV(sweep_period=0.2)
    disc = DiscoveryServer(store, host="127.0.0.1")
    servers, stoppers = [], []
    fed, got, wait_s = [0], [], [0.0]
    done = threading.Event()
    churn = {}

    def feed(epoch):
        # read by the pool's reader thread, ahead of the trainer
        while not done.is_set() and fed[0] < 200:
            b = batches[fed[0] % DISTILL_BATCHES]
            fed[0] += 1
            yield b

    build = tid.make_distill_source(args, [], source=feed)

    def distill_source(epoch):
        it = build(epoch)
        i = 0
        while True:
            t = time.perf_counter()
            b = next(it, None)
            wait_s[0] += time.perf_counter() - t
            if b is None:
                return
            k = i % DISTILL_BATCHES
            got.append({"order": bool(np.array_equal(b["label"], batches[k]["label"])
                                      and np.array_equal(b["image"][:, ::16, ::16],
                                                         batches[k]["image"][:, ::16, ::16])),
                        "pair": _rel(b["teacher_logits"], ref[k]),
                        "control": _rel(b["teacher_logits"], ref[(k + 1) % DISTILL_BATCHES])})
            timed = i - DISTILL_WARMUP + 1
            if timed == DISTILL_LEAVE and "leave" not in churn:
                churn["leave"] = (i, time.perf_counter())
                stopper = threading.Thread(target=servers[0].stop, name="stop-A")
                stopper.start()
                stoppers.append(stopper)
            if timed == DISTILL_JOIN and "join" not in churn:
                servers.append(tid.serve_teacher(args, store, device, model=tmodel, block=False))
                churn["join"] = (i, time.perf_counter())
            if timed >= DISTILL_TIMED and "join" in churn:
                if servers[2].stats()["rows"] > 0:
                    done.set()
                elif time.perf_counter() - churn["join"][1] > DISTILL_JOIN_BOUND_S:
                    done.set()
            i += 1
            yield b

    teacher_mod.module_teacher = timed_module_teacher
    tid.distill_loss = recording_loss
    PredictPool._requeue = counting_requeue
    A.reset_launch_counts()
    try:
        servers += [tid.serve_teacher(args, store, device, model=tmodel, block=False)
                    for _ in range(2)]
        args.discovery = disc.endpoint
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _CountRecords(["edl_tpu_torch.distill.predict_client",
                            "edl_tpu_torch.distill.predict_pool"]) as warnings_:
            t0 = time.perf_counter()
            sstate, _, _ = tid.train_student(args, [], [], device, distill_source=distill_source)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        for s in stoppers:
            s.join(timeout=30)
        stats = [s.stats() for s in servers]
        distill_steps = list(steps)
        steps.clear()
        student_params = str(next(sstate.model.parameters()).device)
        del sstate
        torch.cuda.empty_cache()

        # the same student step without the teacher, on the same batches
        def plain_source(epoch):
            for i in range(DISTILL_WARMUP + DISTILL_TIMED):
                yield batches[i % DISTILL_BATCHES]

        t0_alone = time.perf_counter()
        astate, _, _ = tid.train_student(args, [], [], device, distill_source=plain_source)
        torch.cuda.synchronize()
        t_end_alone = time.perf_counter()
        alone_steps = list(steps)
        del astate
    finally:
        teacher_mod.module_teacher = module_teacher
        tid.distill_loss = distill_loss
        PredictPool._requeue = requeue
        done.set()
        for s in servers[1:] if stoppers else servers:
            s.stop()
        disc.stop()
    launches = A.launch_counts()
    torch.cuda.empty_cache()
    nop = run_probe(nop=True, batches=12, batch_size=128, sample_shape=(224, 224, 3),
                    teacher_batch_size=16, warmup=2)

    # the numbers
    n = len(distill_steps)
    starts = [s[0] for s in distill_steps]
    t_timed = starts[DISTILL_WARMUP]
    img_s = (n - DISTILL_WARMUP) * 128 / (t_end - t_timed)
    alone_starts = [s[0] for s in alone_steps]
    img_s_alone = DISTILL_TIMED * 128 / (t_end_alone - alone_starts[DISTILL_WARMUP])
    intervals = [(b - a) * 1e3 for a, b in zip(starts[:-1], starts[1:])]
    leave_i = churn["leave"][0]
    around_leave = intervals[max(0, leave_i - 1):leave_i + 6]
    in_window = [r for r in records if t_timed <= r[2] <= t_end]
    window_rows = sum(r[1] for r in in_window)
    by_bucket: dict[int, list] = {}
    for r in records:
        by_bucket.setdefault(r[1], []).append(r)
    c_rows = [r[2] for r in records if r[0] == 2]
    c_first_row_s = (min(c_rows) - churn["join"][1]) if c_rows else None
    pairs = [g["pair"] for g in got]
    controls = [g["control"] for g in got]
    loss_errs = []
    for _, lg, lb, tl, loss in distill_steps + alone_steps:
        want = _float64_loss(lg, lb, tl, alpha, T)
        loss_errs.append(abs(float(loss) - want) / abs(want))
    losses = [float(s[4]) for s in distill_steps]
    alone_losses = [float(s[4]) for s in alone_steps]
    rows_served = sum(s["rows"] for s in stats)
    out = {
        "nvidia_smi": smi_name_and_power_limit(),
        "teacher": "resnet152", "student": "resnet50vd", "batch": 128, "teacher_batch": 16,
        "image_size": 224, "dtype": "bfloat16",
        "teacher_train_steps": DISTILL_TEACHER_STEPS, "teacher_train_s": teacher_train_s,
        "steps": n, "timed_steps": n - DISTILL_WARMUP,
        "student_img_s_with_teacher": img_s, "student_img_s_alone": img_s_alone,
        "blocked_on_reader_ms_per_step": wait_s[0] / n * 1e3,
        "teacher_rows_per_s_timed": window_rows / (t_end - t_timed),
        "teacher_forward_passes": sum(s["forward_passes"] for s in stats),
        "teacher_rows": rows_served,
        "mean_rows_a_pass": rows_served / max(1, sum(s["forward_passes"] for s in stats)),
        "teacher_forward_ms_by_bucket": {
            b: {"passes": len(rs), "wall_ms_mean": float(np.mean([r[3] for r in rs])),
                "event_ms_mean": float(np.mean([r[4] for r in rs]))}
            for b, rs in sorted(by_bucket.items())},
        "teacher_forward16_event_ms_alone": forward16_ms,
        "teacher_forward16_device_ms_alone": forward16_device_ms,
        "teacher_forward16_launches": forward16_launches,
        "wire_mb_s": window_rows * DISTILL_ROW_BYTES / (t_end - t_timed) / 1e6,
        "nop_reader_qps": nop["value"],
        "max_memory_allocated_both_models": peak,
        "longest_step_interval_ms_around_leave": max(around_leave),
        "step_intervals_ms": intervals,
        "c_registration_to_first_row_s": c_first_row_s,
        "server_stats": stats, "predict_retries_logged": warnings_.counts,
        "requeues": requeues[0],
        "pairing_rel_max": max(pairs), "control_rel_min": min(controls),
        "order_ok": all(g["order"] for g in got), "batches_fed": fed[0],
        "batches_trained": n, "loss_rel_err_max": max(loss_errs), "losses": losses,
        "alone_losses": alone_losses, "attention_launches": launches,
        "teacher_param_device": str(next(tmodel.parameters()).device),
        "student_param_device": student_params,
        "teacher_predict_devices": sorted({r[5] for r in records}),
        "teacher_inference_mode": all(r[6] for r in records),
        "phase_s": time.perf_counter() - t_phase}
    log("distill", **out)
    del own
    torch.cuda.empty_cache()
    if len(got) != n or fed[0] != n or not out["order_ok"]:
        raise AssertionError(f"order: {n} trained, {len(got)} read, {fed[0]} fed, "
                             f"in order {out['order_ok']}")
    if max(pairs) > DISTILL_PAIR_TOL or min(controls) < 10 * DISTILL_PAIR_TOL:
        raise AssertionError(f"pairing: {max(pairs)} (limit {DISTILL_PAIR_TOL}), control "
                             f"{min(controls)} (at least {10 * DISTILL_PAIR_TOL})")
    if rows_served < n * 128:
        raise AssertionError(f"rows served {rows_served} < {n} x 128")
    if n - DISTILL_WARMUP < DISTILL_TIMED or not c_rows or stats[0]["rows"] == 0:
        raise AssertionError(f"churn: {n} steps, C's rows {len(c_rows)}, A's {stats[0]['rows']}")
    if max(loss_errs) > DISTILL_LOSS_RTOL or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"loss against float64: {max(loss_errs)}; losses {losses}")
    if not np.mean(losses[-4:]) < losses[0]:
        raise AssertionError(f"the distillation loss did not fall: {losses}")
    if (out["teacher_param_device"], out["student_param_device"]) != ("cuda:0", "cuda:0") \
            or out["teacher_predict_devices"] != [0] or not out["teacher_inference_mode"] \
            or not all(r[4] > 0 for r in records):
        raise AssertionError(f"device: {out['teacher_param_device']}, "
                             f"{out['student_param_device']}, {out['teacher_predict_devices']}")
    if any(launches.values()):
        raise AssertionError(f"the distillation path launched attention kernels: {launches}")
    try:
        _distill_fleet(args, store, tmodel, batches, ref, device, img_s)
    finally:
        store.close()
        del tmodel, batches
        torch.cuda.empty_cache()


DISTILL_FLEET_JOB = "chip-smoke-teachers"
DISTILL_FLEET_STUDENT = "chip-smoke-student"
DISTILL_FLEET_TIMED, DISTILL_FLEET_STOP = 10, 4   # timed steps; the one after which a replica stops


def _distill_fleet(args, store, tmodel, batches, ref, device, discovery_img_s) -> dict:
    """(d) The teacher fleet on the phase's store and teacher: two
    ``TeacherReplica``s of one job behind a ``DistillFleet``; a third server's
    balance advert and a ``DiscoveryServer`` on one shared ``CoordSession``
    (one lease for both); one routed, hedged predict of 16 rows; then the
    student through ``make_distill_source`` with the fleet's
    ``endpoints_fn()`` and a ``StudentFeed`` (2 warm-up and 10 timed steps,
    replica 0 stopping after timed step 4).  Checks: no batch lost,
    reordered or mispaired (the pairing audit and its control), the
    survivor serves after the stop, the backlog record is read while the
    student runs and is gone after, the routed predict's logits pair."""
    import threading

    import numpy as np
    import torch

    from edl_tpu_torch import train_image_distill as tid
    from edl_tpu_torch.cluster import scale
    from edl_tpu_torch.coord.session import CoordSession
    from edl_tpu_torch.distill import teacher as teacher_mod
    from edl_tpu_torch.distill.backlog import StudentFeed
    from edl_tpu_torch.distill.balance import BALANCE_SERVICE, server_key
    from edl_tpu_torch.distill.discovery import DiscoveryServer
    from edl_tpu_torch.distill.fleet import DistillFleet, TeacherReplica
    from edl_tpu_torch.distill.predict_pool import PredictPool
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    t_part = time.perf_counter()
    service = args.service + "-fleet"

    def new_server():
        return teacher_mod.TeacherServer(
            teacher_mod.module_teacher(tmodel, fetch_name="logits", device=device),
            host="127.0.0.1", device=device)

    # one shared lease: a teacher's balance advert and a discovery server
    session = CoordSession(store, name="teacher-and-discovery")
    third = new_server().register(store, service + "-shared", session=session)
    disc = DiscoveryServer(store, host="127.0.0.1", session=session)
    leases = {store.get(server_key(service + "-shared", third.endpoint)).lease_id,
              store.get(server_key(BALANCE_SERVICE, disc.endpoint)).lease_id}
    one_lease = leases == {session.lease_id}
    disc.stop()
    third.stop()
    session.close()

    replicas = [TeacherReplica(store, DISTILL_FLEET_JOB, new_server(), service,
                               replica_id=f"teacher-{i}") for i in range(2)]
    probe = fleet = None
    stoppers, feeds, got, starts, backlog = [], [], [], [], []
    fed, requeues = [0], [0]
    done = threading.Event()
    requeue = PredictPool._requeue

    def counting_requeue(self, task):
        requeues[0] += 1
        return requeue(self, task)

    def source(epoch):
        while not done.is_set() and fed[0] < 200:
            fed[0] += 1
            yield batches[(fed[0] - 1) % DISTILL_BATCHES]

    def wrap(reader):
        feeds.append(StudentFeed(store, DISTILL_FLEET_JOB, reader,
                                 student_id=DISTILL_FLEET_STUDENT, period=0.25))
        return feeds[-1]

    PredictPool._requeue = counting_requeue
    try:
        probe = DistillFleet(store, DISTILL_FLEET_JOB)
        fleet = DistillFleet(store, DISTILL_FLEET_JOB)
        if not (probe.wait_for(2, 10.0) and fleet.wait_for(2, 10.0)):
            raise AssertionError(f"the fleet did not see both replicas: {fleet.teachers()}")
        t0 = time.perf_counter()
        routed = probe.predict({"image": batches[0]["image"][:16]}, ["logits"],
                               hedge_after_s=1.0)["logits"]
        routed_ms = (time.perf_counter() - t0) * 1e3
        build = tid.make_distill_source(args, [], source=source, servers_fn=fleet.endpoints_fn(),
                                        wrap_reader=wrap)

        def distill_source(epoch):
            for i, b in enumerate(build(epoch)):
                starts.append(time.perf_counter())
                k = i % DISTILL_BATCHES
                got.append({"order": bool(np.array_equal(b["label"], batches[k]["label"])),
                            "pair": _rel(b["teacher_logits"], ref[k]),
                            "control": _rel(b["teacher_logits"], ref[(k + 1) % DISTILL_BATCHES])})
                rec = scale.load_backlogs(store, DISTILL_FLEET_JOB).get(DISTILL_FLEET_STUDENT)
                backlog.append((feeds[0].backlog_rows(), rec and rec["queued_rows"]))
                timed = i - DISTILL_WARMUP + 1
                if timed == DISTILL_FLEET_STOP:
                    stoppers.append(threading.Thread(target=replicas[0].stop, name="stop-0"))
                    stoppers[-1].start()
                if timed >= DISTILL_FLEET_TIMED:
                    done.set()
                yield b

        stats_before = [r.server.stats()["rows"] for r in replicas]
        sstate, _, _ = tid.train_student(args, [], [], device, distill_source=distill_source)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        for s in stoppers:
            s.join(timeout=30)
        record_after = scale.load_backlogs(store, DISTILL_FLEET_JOB)
        stats = [r.server.stats() for r in replicas]
        del sstate
        torch.cuda.empty_cache()
    finally:
        PredictPool._requeue = requeue
        done.set()
        for r in replicas[1:] if stoppers else replicas:
            r.stop()
        for f in (probe, fleet):
            if f is not None:
                f.stop()
    n = len(got)
    intervals = [(b - a) * 1e3 for a, b in zip(starts[:-1], starts[1:])]
    stop_i = DISTILL_WARMUP + DISTILL_FLEET_STOP - 1
    pairs, controls = [g["pair"] for g in got], [g["control"] for g in got]
    out = {"nvidia_smi": smi_name_and_power_limit(), "replicas": 2, "steps": n,
           "batches_fed": fed[0],
           "student_img_s_through_fleet": (n - DISTILL_WARMUP) * 128
           / (t_end - starts[DISTILL_WARMUP]),
           "student_img_s_through_discovery": discovery_img_s,
           "replica_stop_stall_ms": max(intervals[stop_i:stop_i + 6]),
           "median_step_interval_ms": float(np.median(intervals)),
           "step_intervals_ms": intervals, "requeues": requeues[0],
           "fleet_counts": dict(fleet.counts), "routed_predict_counts": dict(probe.counts),
           "routed_predict_ms": routed_ms, "routed_predict_pair": _rel(routed, ref[0][:16]),
           "rows_by_replica": [s["rows"] - b for s, b in zip(stats, stats_before)],
           "backlog_rows_max": max(b for b, _ in backlog),
           "backlog_record_rows": [r for _, r in backlog],
           "backlog_record_seen": any(r is not None for _, r in backlog),
           "backlog_record_after_stop": record_after, "one_lease_teacher_and_discovery": one_lease,
           "pairing_rel_max": max(pairs), "control_rel_min": min(controls),
           "order_ok": all(g["order"] for g in got), "part_s": time.perf_counter() - t_part}
    log("distill", fleet=out)
    if n != fed[0] or n < DISTILL_WARMUP + DISTILL_FLEET_TIMED or not out["order_ok"]:
        raise AssertionError(f"(d) {n} trained, {fed[0]} fed, in order {out['order_ok']}")
    if max(pairs) > DISTILL_PAIR_TOL or min(controls) < 10 * DISTILL_PAIR_TOL \
            or out["routed_predict_pair"] > DISTILL_PAIR_TOL:
        raise AssertionError(f"(d) pairing {max(pairs)}, control {min(controls)}, routed "
                             f"{out['routed_predict_pair']} (limit {DISTILL_PAIR_TOL})")
    if not one_lease:
        raise AssertionError(f"(d) the shared session's adverts ride leases {leases}")
    if not out["backlog_record_seen"] or DISTILL_FLEET_STUDENT in record_after:
        raise AssertionError(f"(d) the backlog record: seen {out['backlog_record_seen']}, "
                             f"after the stop {record_after}")
    if min(out["rows_by_replica"]) <= 0 or stats[1]["rows"] <= stats_before[1]:
        raise AssertionError(f"(d) rows by replica {out['rows_by_replica']}")
    return out


# -- main ------------------------------------------------------------------------

# -- phase 16 --------------------------------------------------------------------

RESHARD_JOB = "chip-smoke-reshard"
RESHARD_STEPS = 14        # the uninterrupted run: the longest any check reads


class _StopAt(Exception):
    pass


def _reshard_stand_in():
    """The launcher's part: a store, the port's cache service on its RPC
    server, advertised, and a one-pod cluster record at stage ``st-1``."""
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.memstate import advert
    from edl_tpu_torch.memstate.service import StateCacheService
    from edl_tpu_torch.rpc.server import RpcServer

    store = MemoryKV()
    service = StateCacheService(store, RESHARD_JOB, "pod-0")
    server = RpcServer("127.0.0.1", 0)
    server.register_instance(service)
    server.start()
    reg = advert.advertise(store, RESHARD_JOB, "pod-0", f"127.0.0.1:{server.port}", ttl=60)
    _save_cluster(store, "st-1")
    return store, service, server, reg


def _save_cluster(store, stage):
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.paths import key
    from edl_tpu_torch.cluster.pod import Pod, Trainer

    pod = Pod(pod_id="pod-0")
    pod.trainers = [Trainer(endpoint="127.0.0.1:1")]
    cluster = Cluster.from_pods([pod])
    cluster.stage = stage
    store.put(key(RESHARD_JOB, "cluster", "cluster"), cluster.to_json().encode())


def _reshard_trainer(args, device, ckpt_dir, store, stop_at=None):
    """train_lm's trainer under the stand-in (pod-0 at stage st-1), its
    loss_fn recording each loss; it raises ``_StopAt`` when asked for its
    ``stop_at``-th loss (every earlier step's hooks have run)."""
    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster.env import TrainerEnv

    tenv = TrainerEnv({"EDL_TPU_JOB_ID": RESHARD_JOB, "EDL_TPU_POD_ID": "pod-0",
                       "EDL_TPU_CLUSTER_STAGE": "st-1", "EDL_TPU_COORD_ENDPOINTS": "memory"})
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device, str(ckpt_dir), store, tenv)
    inner, losses = trainer.loss_fn, []

    def recording(*a):
        if stop_at is not None and len(losses) + 1 >= stop_at:
            raise _StopAt(stop_at)
        loss, aux = inner(*a)
        losses.append(loss.detach())
        return loss, aux

    trainer.loss_fn = recording
    return trainer, init_fn, tx, losses


def _fixed_data(args, steps: int):
    """``steps`` batches an epoch, each the fixed batch (the flagship
    phase's)."""
    import numpy as np

    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size, args.seq_len + 1)
                                            ).astype(np.int32)

    def data_fn(_epoch):
        for _ in range(steps):
            yield {"ids": ids}
    return data_fn


def _delta_tokens_per_s(trainer, state, meta, batch, steps: int) -> dict:
    """tokens/s of ``steps`` steps with the delta plane off and on, in turns
    (off, on, on, off), through the trainer's step and its delta hook (the
    epoch loop's: ``want`` then ``stage``, every ``EDL_TPU_DELTA_EVERY``
    steps); the replicator drains between turns."""
    import torch

    rep = trainer._delta_rep
    gen = torch.Generator(device=trainer.device).manual_seed(3)
    out: dict = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer.step_fn(state, batch, gen)
            if mode == "on" and rep.want(state.step):
                meta.step = state.step
                rep.stage(state.step, state, meta)
        torch.cuda.synchronize()
        out[mode].append(steps * batch["ids"].shape[0] * (batch["ids"].shape[1] - 1)
                         / (time.perf_counter() - t0))
        if not rep.flush(timeout=120):
            raise AssertionError("the delta replicator did not drain")
    return out


def phase_reshard(ctx) -> None:
    """The resizable world on the card: the cache restore, the delta chain,
    a live grow at world 1 and the store rendezvous of an NCCL group."""
    import os
    import shutil

    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster import recovery, resize
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.memstate import advert
    from edl_tpu_torch.memstate import restore as ms_restore
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train import distributed
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    card = smi_name_and_power_limit()
    device = torch.device("cuda")
    args = train_lm.parse_args(FLAGSHIP_ARGS + ["--steps_per_epoch", "4"])
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_reshard"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    data_fn = _fixed_data(args, 4)
    store, service, server, reg = _reshard_stand_in()
    saved_env = {k: os.environ.get(k) for k in ("EDL_TPU_DELTA_EVERY",)}

    def free(*trainers):
        for tr in trainers:
            if tr._delta_rep is not None:
                tr._delta_rep.close()
            if tr.ckpt is not None:
                tr.ckpt.close()
        torch.cuda.empty_cache()

    def rel(got, want):
        return max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, want))

    try:
        # the uninterrupted run: seed-0 weights, the fixed batch
        _, straight, init_fn, tx = train_lm.build_trainer(args, device)
        state = straight.create_state(init_fn, tx)
        gen = torch.Generator(device=device).manual_seed(0)
        batch = {"ids": torch.from_numpy(next(data_fn(0))["ids"]).to(device)}
        ref = []
        for _ in range(RESHARD_STEPS):
            state, metrics = straight.step_fn(state, batch, gen)
            ref.append(metrics["loss"])
        ref = [float(x) for x in ref]
        del straight, state
        torch.cuda.empty_cache()

        # (a) 4 steps and the epoch's save at step 4, teed and sealed
        tr_a, init_fn, tx, losses_a = _reshard_trainer(args, device, ckpt_dir, store)
        st, meta = tr_a.restore_or_create(init_fn, tx)
        st, meta = tr_a.fit(st, meta, data_fn, epochs=1)
        tee_a = dict(tr_a.ckpt._tee.stats)
        committed = advert.read_committed_step(store, RESHARD_JOB)
        del st
        free(tr_a)
        # a fresh trainer restores cache-first, then the same state from storage
        os.environ["EDL_TPU_DELTA_EVERY"] = "2"
        tr_b, init_fn, tx, losses_b = _reshard_trainer(args, device, ckpt_dir, store, stop_at=5)
        st_b, meta_b = tr_b.restore_or_create(init_fn, tx)
        peer = tr_b.restores[-1]
        t0 = time.perf_counter()
        stored, _ = tr_b.ckpt.restore(tr_b.create_state(init_fn, tx), step=4)
        storage_s = time.perf_counter() - t0
        ms_restore.assert_bit_identical(st_b, stored)
        del stored
        torch.cuda.empty_cache()
        # (b) on to step 8 with a delta record every 2 steps, then stop
        try:
            tr_b.fit(st_b, meta_b, _fixed_data(args, 8), epochs=2)
        except _StopAt:
            pass
        if not tr_b._delta_rep.flush(timeout=120):
            raise AssertionError("the delta replicator did not drain")
        delta_b = dict(tr_b._delta_rep.stats)
        chains = service.cache_delta_manifest()
        del st_b
        free(tr_b)
        log("reshard", nvidia_smi=card, part="a", committed_step=committed,
            tee_stage_ms=tee_a["stage_s"] * 1e3, tee_push_s=tee_a["push_s"],
            tee_pushed_bytes=tee_a["pushed_bytes"], restore_source=peer["source"],
            restore_s=peer["seconds"], restore_bytes=peer["bytes"],
            storage_restore_s=storage_s, losses_after_restore=[float(x) for x in losses_b],
            uninterrupted=ref[4:8], rel_diff=rel(losses_b, ref[4:8]), rtol=RESUME_RTOL)
        if rel(losses_a, ref[:4]) > RESUME_RTOL:
            raise AssertionError("(a) the first 4 steps do not match the uninterrupted run")
        if committed != 4 or peer["source"] != "peer" or peer["step"] != 4:
            raise AssertionError(f"(a) cache restore: committed {committed}, {peer}")
        if len(losses_b) != 4 or rel(losses_b, ref[4:8]) > RESUME_RTOL:
            raise AssertionError("(a) the restored run does not continue the uninterrupted one")

        # (b) a fresh trainer rolls forward over the chain to step 8; after
        # the reshard it streams no records ((c) ends without a save)
        tr_c, init_fn, tx, losses_c = _reshard_trainer(args, device, ckpt_dir, store,
                                                       stop_at=6)
        st_c, meta_c = tr_c.restore_or_create(init_fn, tx)
        os.environ["EDL_TPU_DELTA_EVERY"] = "0"
        delta = tr_c.restores[-1]
        log("reshard", nvidia_smi=card, part="b", chain_steps=[
                [r["step"] for r in ch["records"]] for ch in chains.values()],
            delta_records=delta_b["records"], delta_bytes=delta_b["bytes"],
            delta_coalesced=delta_b["coalesced"], delta_stage_ms=delta_b["stage_s"] * 1e3,
            delta_push_s=delta_b["push_s"], restore_source=delta["source"],
            restore_step=delta["step"], restore_s=delta["seconds"], restore_bytes=delta["bytes"])
        if delta["source"] != "delta" or st_c.step != 8 or delta_b["failed"]:
            raise AssertionError(f"(b) delta restore: {delta}, step {st_c.step}, {delta_b}")

        # (c) a live grow at world 1: flag, then go to st-2 with its record
        resize.flag_resize(store, RESHARD_JOB, "st-1", "grow", "st-2", "pod-0")
        resize.write_go(store, RESHARD_JOB, "st-1", "st-2", "grow")
        _save_cluster(store, "st-2")
        live = tr_c._live_reshard
        tr_c_state = (st_c, meta_c)

        def counted(*a):
            out = live(*a)
            A.reset_launch_counts()     # the path after the reshard
            return out

        tr_c._live_reshard = counted
        del st_c      # the trainer frees the old state's tensors at the reshard
        try:          # step 9, the pause, steps 10-13; stopped before step 14
            tr_c.fit(*tr_c_state, _fixed_data(args, 8), epochs=2)
        except _StopAt:
            pass
        launches = A.launch_counts()
        A.reset_launch_counts()
        reshard = tr_c.reshards[-1] if tr_c.reshards else {}
        steps_after = len(losses_c) - 1
        done = resize.load_done(store, RESHARD_JOB, "st-2")
        half = recovery.load_recovery_records(store, RESHARD_JOB).get("st-2", {}).get(
            "trainer", {}).get("pod-0")
        detect_to_first = (half["first_step"] - half["restored"]) if half else None
        got = [float(x) for x in losses_c]
        want = ref[8:8 + len(got)]
        per_step = args.layers * steps_after
        log("reshard", nvidia_smi=card, part="c", reshard=reshard, done=done,
            restore_fallbacks=tr_c.restore_fallbacks,
            tenv_stage=tr_c.tenv.cluster_stage, detect_to_first_step_s=detect_to_first,
            losses=got, uninterrupted=want, rel_diff=rel(got, want), launches=launches,
            steps_after_reshard=steps_after)
        if (reshard.get("mode") != "grow" or reshard.get("source") != "delta"
                or tr_c.restore_fallbacks
                or reshard.get("wire_bytes") != 0 or "pod-0" not in done
                or tr_c.tenv.cluster_stage != "st-2" or detect_to_first is None):
            raise AssertionError(f"(c) live grow: {reshard}, {done}")
        if rel(got, want) > RESUME_RTOL or len(got) < 3:
            raise AssertionError("(c) the resharded run does not continue the uninterrupted one")
        want_launches = {n: per_step if n in SPLASH_WRAPPERS else 0 for n in launches}
        if steps_after < 1 or launches != want_launches:
            raise AssertionError(f"(c) launches after the reshard {launches} != {want_launches}")
        ctx["launches_reshard"] = launches

        # tokens/s with the delta plane off and on, from the committed state
        os.environ["EDL_TPU_DELTA_EVERY"] = "2"
        del tr_c_state
        free(tr_c)
        tr_d, init_fn, tx, _ = _reshard_trainer(args, device, ckpt_dir, store)
        st_d, meta_d = tr_d.restore_or_create(init_fn, tx)
        rates = _delta_tokens_per_s(tr_d, st_d, meta_d, batch, 8)
        stats_d = dict(tr_d._delta_rep.stats)
        del st_d
        free(tr_d)
        log("reshard", nvidia_smi=card, part="b_tokens_per_s", delta_every=2,
            tokens_per_s_off=rates["off"], tokens_per_s_on=rates["on"],
            on_over_off=sum(rates["on"]) / sum(rates["off"]), delta=stats_d)

        # (d) an NCCL group of one through the store rendezvous, twice
        formed = []
        for n in range(2):
            t_pub = time.time()
            resize.publish_world_service(store, RESHARD_JOB, "rdzv", f"127.0.0.1:{n + 1}", 1)
            tenv = TrainerEnv({"EDL_TPU_JOB_ID": RESHARD_JOB, "EDL_TPU_CLUSTER_STAGE": "rdzv",
                               "EDL_TPU_TRAINERS_NUM": "1", "EDL_TPU_TRAINER_ID": "0"})
            seconds = distributed.form_world(tenv, store, "cuda", timeout=60.0,
                                             min_ts=t_pub - 1.0)
            x = torch.ones(1024, device=device)
            torch.distributed.all_reduce(x)
            torch.cuda.synchronize()
            ok = bool(torch.all(x == 1).item())
            gate = json.loads(store.get(f"/edl_tpu/{RESHARD_JOB}/torchworld/rdzv/gate").value)
            backend = torch.distributed.get_backend()
            distributed.leak_world()
            formed.append({"ms": seconds * 1e3, "nonce": gate["nonce"], "backend": backend,
                           "all_reduce_ok": ok})
        log("reshard", nvidia_smi=card, part="d", formations=formed)
        if (not all(f["all_reduce_ok"] and f["backend"] == "nccl" for f in formed)
                or formed[0]["nonce"] == formed[1]["nonce"]
                or torch.distributed.is_initialized()):
            raise AssertionError(f"(d) the store rendezvous: {formed}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reg.stop()
        server.stop()
        store.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- phase 17 --------------------------------------------------------------------

MESH_STEPS = 3
# tp = 2 against one process, both bf16 on the card: a row-parallel layer's
# two partial products are each rounded to bf16 before the all-reduce adds
# them, where one process rounds their sum once; the loss to 1e-2 of
# itself, each parameter's step-1 gradient to 5e-2 in relative norm
MESH_LOSS_RTOL = 1e-2
MESH_GRAD_RTOL = 5e-2
MESH_RESUME_ATOL = 1e-2     # (c): the next loss at tp = 1 against tp = 2's


def _mesh_batch(args):
    import numpy as np
    return np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                             args.seq_len + 1)).astype(np.int32)


def _mesh_tp_rank(rank: int, port: int, root: str) -> None:
    """One rank of (a), in its own process: tp = 2 over gloo on cuda:0.
    Writes ``root/tp<rank>.json``."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.models.transformer import LOGICAL_RULES
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.parallel.sharding import to_full
    from edl_tpu_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    probe = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(probe)      # gloo on CUDA tensors, or the phase fails here
    if probe.device.type != "cuda" or probe.tolist() != [3.0] * 4:
        raise AssertionError(f"gloo all-reduced a CUDA tensor to {probe}")
    args = train_lm.parse_args(FLAGSHIP_ARGS + ["--tp", "2"])
    # what one tp all-reduce of the residual stream costs here: f32
    # [batch, seq, embed], as parallel/tp.py reduces it
    act = torch.ones(args.batch_size, args.seq_len, args.embed, device=device)
    for _ in range(2):
        dist.all_reduce(act)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(act)
    torch.cuda.synchronize()
    gloo_ms = (time.perf_counter() - t0) / 5 * 1e3
    del act
    cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx, LOGICAL_RULES)
    batch = {"ids": torch.from_numpy(_mesh_batch(args)).to(device)}
    gen = torch.Generator(device=device).manual_seed(3)
    qkv = state.model.layers[0].attn_qkv.weight
    out = {"rank": rank, "mesh": train_lm._mesh(trainer), "qkv_local": list(qkv.shape),
           "lm_head_local": list(state.model.lm_head.weight.shape),
           "gloo_allreduce_ms_f32_residual": gloo_ms}
    A.reset_launch_counts()
    losses, wall = [], []
    for step in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
        wall.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            layouts = state.model.param_layouts
            grads = {n: to_full(p.grad, layouts[n], state.model.tp).float().cpu()
                     for n, p in state.model.named_parameters()}
            if rank == 0:
                want = torch.load(f"{root}/plain_grads.pt", weights_only=True)
                errs = {n: rel_err(g, want[n]) for n, g in grads.items()}
                out["grad_rel_err_max"] = max(errs.values())
                out["grad_rel_err_worst"] = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            del grads
    out["launches"] = A.launch_counts()
    out["losses"], out["wall_ms_per_step"] = losses, wall
    meta = State(total_batch_size=trainer.cfg.global_batch_size)
    meta.record_epoch(0, trainer.world_size, state.step, 0.0)
    out["saved"] = CheckpointManager(f"{root}/ckpt").save(state.step, state, meta)
    out["loss_4"] = float(trainer.step_fn(state, batch, gen)[1]["loss"])
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=1)
    attn = {k: sum(n for _, key, n in rows if re.search(rf"::{k}[<(]", key))
            for k in A.device_kernels(cfg.head_dim)}
    out["profile_attention_calls_per_step"] = attn
    out["profile_device_busy_ms"] = sum(us for us, _, _ in rows) / 1e3
    with open(f"{root}/tp{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _mesh_step1_grads(extra_args) -> dict:
    """The one-process flagship's step-1 gradients (f32 on the host)."""
    import torch

    from edl_tpu_torch import train_lm

    args = train_lm.parse_args(FLAGSHIP_ARGS + extra_args)
    device = torch.device("cuda", 0)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    trainer.step_fn(state, {"ids": torch.from_numpy(_mesh_batch(args)).to(device)},
                    torch.Generator(device=device).manual_seed(3))
    grads = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()}
    del trainer, state
    torch.cuda.empty_cache()
    return grads


def _mesh_plain(root) -> dict:
    """The one-process flagship step on the card: 3 steps' losses, the
    step-1 gradients (written for (a)), the same gradients on the flash
    path (bf16's floor: one function, other kernels' rounding) and the
    profile of a step."""
    import torch

    from edl_tpu_torch import train_lm

    args = train_lm.parse_args(FLAGSHIP_ARGS)
    device = torch.device("cuda", 0)
    cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    batch = {"ids": torch.from_numpy(_mesh_batch(args)).to(device)}
    gen = torch.Generator(device=device).manual_seed(3)
    losses = []
    for step in range(MESH_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if step == 0:
            grads = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()}
            torch.save(grads, root / "plain_grads.pt")
    params = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    del trainer, state
    torch.cuda.empty_cache()
    flash = _mesh_step1_grads(["--attention", "flash"])
    floor = {n: rel_err(g, grads[n]) for n, g in flash.items()}
    log("mesh", plain_losses=losses, flash_vs_splash_grad_rel_err_max=max(floor.values()),
        flash_vs_splash_grad_rel_err_worst=sorted(floor.items(), key=lambda kv: -kv[1])[:3])
    return {"losses": losses, "params": params, "rows": rows}


def _mesh_tp(root, plain) -> dict:
    """(a): the two tp ranks as processes on the card."""
    import subprocess

    from edl_tpu_torch.utils.network import find_free_port
    port = find_free_port()
    here = Path(__file__).resolve().parent
    files = [open(root / f"tp{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                               "chip_smoke._mesh_tp_rank(int(sys.argv[1]), int(sys.argv[2]), "
                               "sys.argv[3])", str(r), str(port), str(root)],
                              cwd=here, stdout=fh, stderr=subprocess.STDOUT, text=True)
             for r, fh in enumerate(files)]
    try:
        for proc in procs:
            proc.wait(timeout=SUBPROCESS_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in files:
            fh.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise AssertionError(f"tp rank {r} exited {proc.returncode}:\n"
                                 f"{(root / f'tp{r}.log').read_text()[-4000:]}")
    ranks = [json.loads((root / f"tp{r}.json").read_text()) for r in range(2)]
    want = plain["losses"]
    rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], want))
    out = {"ranks": ranks, "plain_losses": want, "loss_rel_err_max": rel,
           "loss_rtol": MESH_LOSS_RTOL, "grad_rtol": MESH_GRAD_RTOL}
    log("mesh", tp=out)
    per_step = 12
    for r in ranks:
        if r["mesh"]["tp"] != 2 or r["qkv_local"] != [3 * 3 * 128, 768] \
                or r["lm_head_local"] != [16000, 768]:
            raise AssertionError(f"rank {r['rank']} is not a tp-2 rank: {r['mesh']}, qkv "
                                 f"{r['qkv_local']}, head {r['lm_head_local']}")
        if r["launches"] != {n: per_step * MESH_STEPS if n in SPLASH_WRAPPERS else 0
                             for n in r["launches"]}:
            raise AssertionError(f"rank {r['rank']} launches {r['launches']}")
        if set(r["profile_attention_calls_per_step"].values()) != {per_step}:
            raise AssertionError(f"rank {r['rank']} profile {r['profile_attention_calls_per_step']}")
        if not r["saved"]:
            raise AssertionError("the tp-2 checkpoint was not written")
    if rel > MESH_LOSS_RTOL or ranks[0]["grad_rel_err_max"] > MESH_GRAD_RTOL:
        raise AssertionError(f"tp 2 is not the one-process step: loss rel {rel}, gradient rel "
                             f"{ranks[0]['grad_rel_err_worst']}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"the tp ranks' losses differ: {ranks[0]['losses']} "
                             f"{ranks[1]['losses']}")
    return out


def _mesh_fsdp(plain) -> dict:
    """(b): FSDP2 forced on an fsdp axis of 1 in an NCCL group of one."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import LOGICAL_RULES
    from edl_tpu_torch.utils.network import find_free_port

    args = train_lm.parse_args(FLAGSHIP_ARGS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", find_free_port(), 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0, device_id=device)
    try:
        cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device, force_fsdp=True)
        state = trainer.create_state(init_fn, tx, LOGICAL_RULES)
        sharded = [n for n, p in state.model.named_parameters() if hasattr(p, "to_local")]
        batch = {"ids": torch.from_numpy(_mesh_batch(args)).to(device)}
        gen = torch.Generator(device=device).manual_seed(3)
        losses = [float(trainer.step_fn(state, batch, gen)[1]["loss"])
                  for _ in range(MESH_STEPS)]
        full = state.full_state_dict()["model"]
        differing = [n for n, t in full.items() if not torch.equal(t, plain["params"][n])]
        rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
        del trainer, state, full
    finally:
        dist.destroy_process_group()
        del store
    torch.cuda.empty_cache()
    nccl = {key[:80]: {"ms_per_step": us / 2 / 1e3, "calls_per_step": n / 2}
            for us, key, n in rows if re.search(r"nccl", key, re.I)}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    out = {"losses": losses, "plain_losses": plain["losses"], "bit_equal_losses":
           losses == plain["losses"], "params_differing": len(differing),
           "loss_rel_err_max": rel, "fsdp2_params": len(sharded),
           "device_busy_ms_per_step": sum(r[0] for r in rows) / 2 / 1e3,
           "device_busy_ms_per_step_plain": sum(r[0] for r in plain["rows"]) / 2 / 1e3,
           "nccl_kernels": nccl,
           "nccl_ms_per_step": sum(v["ms_per_step"] for v in nccl.values())}
    log("mesh", fsdp=out)
    if not sharded or rel > MESH_LOSS_RTOL:
        raise AssertionError(f"FSDP2 of one: {len(sharded)} DTensor parameters, loss rel {rel}")
    return out


def _mesh_resume(root, tp) -> dict:
    """(c): the tp-2 checkpoint restored by one process at tp = 1."""
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import LOGICAL_RULES

    args = train_lm.parse_args(FLAGSHIP_ARGS)
    device = torch.device("cuda", 0)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device, str(root / "ckpt"))
    t0 = time.perf_counter()
    state, meta = trainer.restore_or_create(init_fn, tx, LOGICAL_RULES)
    restore_s = time.perf_counter() - t0
    restored = state.step
    batch = {"ids": torch.from_numpy(_mesh_batch(args)).to(device)}
    gen = torch.Generator(device=device).manual_seed(3)
    loss = float(trainer.step_fn(state, batch, gen)[1]["loss"])
    want = tp["ranks"][0]["loss_4"]
    out = {"step": restored, "sharded": state.sharded, "restore_s": restore_s,
           "loss_4_tp1": loss, "loss_4_tp2": want, "atol": MESH_RESUME_ATOL,
           "epoch_worlds": [e.world_size for e in meta.epochs]}
    log("mesh", resume=out)
    del trainer, state
    torch.cuda.empty_cache()
    if out["step"] != MESH_STEPS or out["sharded"] or abs(loss - want) > MESH_RESUME_ATOL:
        raise AssertionError(f"the tp-2 checkpoint did not resume at tp 1: {out}")
    return out


def phase_mesh(ctx) -> None:
    """The flagship on a mesh: tp = 2 over gloo on the one card, FSDP2 in an
    NCCL group of one, and the tp-2 checkpoint resumed at tp = 1."""
    import shutil

    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        log("mesh", nvidia_smi=smi_name_and_power_limit())
        plain = _mesh_plain(root)
        tp = _mesh_tp(root, plain)
        _mesh_fsdp(plain)
        _mesh_resume(root, tp)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 18 --------------------------------------------------------------------

MESHSERVE_REQUESTS = 16          # (a): the serve phase's first (the script's time)
MESHSERVE_SESSION = 600          # (b): a session's first prompt, tokens (seed 31)
MESHSERVE_SUFFIX = 48            # (b): the next turn's new tokens after prompt + reply
MESHSERVE_SPEC_REQUESTS = 8      # (c): requests of at most 256 prompt tokens
MESHSERVE_REPLICA_REQUESTS = 8   # (e): the same requests through the gateway
MESHSERVE_TEACHER = (8, 1024)    # (d): the teacher's feed, [batch, tokens]
# (d): the tp-2 teacher's logits against one process's, both bf16 through the
# splash kernels: the relative L2 norm of the difference (the row-parallel
# partial sums are each rounded to bf16 before the all-reduce adds them)
MESHSERVE_TEACHER_RTOL = 2e-2
# the residual stream, the head's vocab columns and the sampled tokens of
# one decode step at 16 slots, as parallel/tp.py and the engine move them
MESHSERVE_RESIDUAL = (SERVE_SLOTS, 1, 768)
MESHSERVE_HEAD = (SERVE_SLOTS, 32000)


def _meshserve_draft():
    """The replica's default draft (--draft_layers 1 --draft_embed 16
    --draft_heads 2 --draft_mlp 32) over the flagship's vocabulary, seed 0."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    cfg = TransformerConfig(vocab_size=32000, num_layers=1, embed_dim=16, num_heads=2,
                            mlp_dim=32, max_len=1024, remat=False, dtype=torch.bfloat16)
    return TransformerLM(cfg, torch.Generator().manual_seed(0)).to("cuda").requires_grad_(
        False).eval()


def _meshserve_teacher_model(model):
    """``model`` (the serve phase's) with ``attention_impl="auto"``: the
    splash kernels carry its attention."""
    from edl_tpu_torch.models.transformer import TransformerLM
    teacher = TransformerLM(dataclasses.replace(model.cfg, attention_impl="auto"), init=False)
    teacher.load_state_dict(model.state_dict())
    return teacher.to("cuda").requires_grad_(False).eval()


def _meshserve_collectives(tp) -> dict:
    """A decode step's gloo collectives on the card, each timed alone over
    the tp group: the f32 residual all-reduce (25 a step: 2 a layer and the
    embedding's), the head's f32 vocab-column all-reduce and the sampled
    tokens' broadcast.  What a step spends in them is measured inside the
    step (``_meshserve_decode_ms``)."""
    import torch
    import torch.distributed as dist

    def timed(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    res = torch.ones(MESHSERVE_RESIDUAL, device="cuda")
    head = torch.ones(MESHSERVE_HEAD, device="cuda")
    toks = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    src = dist.get_global_rank(tp.group, 0)
    out = {"residual_allreduce_ms": timed(lambda: dist.all_reduce(res, group=tp.group)),
           "head_allreduce_ms": timed(lambda: dist.all_reduce(head, group=tp.group)),
           "token_broadcast_ms": timed(lambda: dist.broadcast(toks, src, group=tp.group)),
           "residual_bytes": res.numel() * 4, "head_bytes": head.numel() * 4}
    return out


def _meshserve_decode_ms(engine) -> dict:
    """Wall ms of one decode step at 16 live slots, on the engine thread
    (one dispatch is steps_per_sync steps, the engine's own _step).  For a
    tp engine, the same steps once more with every ``all_reduce`` and
    ``broadcast`` the leader enters timed where it is called (the model's
    tp collectives, the sampled tokens, the command's header on the
    control group): the card is synchronised before and after each call,
    so a call's time is the collective's own (its copies through the host
    and the wait for the follower to enter it), not the work queued before
    it.  Those syncs slow the instrumented steps, whose wall ms is kept
    beside the plain one."""
    import torch
    import torch.distributed as dist

    def steps(cache, toks, gen, n=4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine._step(cache, toks, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n / engine._T * 1e3

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        cache = engine._slab(SERVE_SLOTS)
        toks = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
        engine._step(cache, toks, gen)
        out = {"ms_per_step": steps(cache, toks, gen)}
        if engine._chan is None:
            return out
        spent = {name: [0.0, 0] for name in ("all_reduce", "broadcast")}
        plain = {name: getattr(dist, name) for name in spent}

        def timed(name):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = plain[name](*args, **kw)
                torch.cuda.synchronize()
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
                return result
            return call

        for name in spent:
            setattr(dist, name, timed(name))
        try:
            out["instrumented_ms_per_step"] = steps(cache, toks, gen)
        finally:
            for name, fn in plain.items():
                setattr(dist, name, fn)
        n = 4 * engine._T
        out["gloo_ms_per_step"] = sum(t for t, _ in spent.values()) / n * 1e3
        out.update({f"{name}_ms_per_step": t / n * 1e3 for name, (t, _) in spent.items()})
        out.update({f"{name}_calls_per_step": c / n for name, (_, c) in spent.items()})
        return out

    return engine.run_on_engine(run, timeout=None)


def _meshserve_turn(engine, prompt, session):
    """One session turn, then drain; returns the reply and the exports."""
    out = engine.submit(prompt, SERVE_NEW, session=session).result(timeout=SUBPROCESS_TIMEOUT)
    if not engine.drain(timeout=SUBPROCESS_TIMEOUT):
        raise AssertionError("the engine did not drain")
    return out, engine.export_sessions()


def _meshserve_resume(engine, exported, prompt) -> dict:
    """Import a migrated session and run its next turn on ``engine``."""
    (session, tokens, meta, blob), = exported
    blocks = engine.import_session(session, tokens, meta, blob)
    out = engine.generate(prompt, SERVE_NEW, timeout=SUBPROCESS_TIMEOUT)
    stats = engine.stats()
    return {"out": out, "blocks": blocks, "tokens": len(tokens),
            "kv_prefix_hits": stats["kv_prefix_hits"],
            "kv_prefill_tokens_skipped": stats["kv_prefill_tokens_skipped"]}


def _meshserve_leader(mesh) -> dict:
    """Rank 0: (a)-(e), each tp group led here, the references computed
    here on the whole model."""
    import copy

    import numpy as np
    import torch

    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.distill.teacher import module_teacher
    from edl_tpu_torch.gateway import Gateway, GatewayConfig
    from edl_tpu_torch.models.transformer import LOGICAL_RULES, TransformerLM
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.serving import ContinuousBatcher, ReplicaServer

    def engine(model, mesh=mesh, **kw):
        return ContinuousBatcher(model, slots=SERVE_SLOTS, temperature=0.0, mesh=mesh, **kw)

    out = {}
    marks = [("start", time.perf_counter())]
    full = _serve_model()
    every = _serve_prompts()
    prompts = every[:MESHSERVE_REQUESTS]
    rng = np.random.default_rng(31)
    first = {s: rng.integers(0, 32000, MESHSERVE_SESSION).astype(np.int32) for s in "mn"}
    # (a) the paged engine at tp 2 over the serve phase's requests, then
    # (b)'s first turn of session m on it
    eng = engine(full, kv_block=FLEET_BLOCK)
    eng.warm(128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [eng.submit(p, SERVE_NEW) for p in prompts]
    tp_outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
    dt = time.perf_counter() - t0
    marks.append(("a_tp2", time.perf_counter()))
    out["a"] = {"seconds": dt, "tokens_per_s": len(prompts) * SERVE_NEW / dt,
                "decode_16_slots": _meshserve_decode_ms(eng),
                "engine_stats": eng.stats(), "local_kv_heads": eng._cache.keys[0].shape[1],
                "local_qkv_rows": eng._model.layers[0].attn_qkv.weight.shape[0],
                "local_head_rows": eng._model.lm_head.weight.shape[0]}
    # while the tp engine idles: the one-process engine on the same requests,
    # and session n's first turn there
    one = engine(full, mesh=None, kv_block=FLEET_BLOCK)
    one.warm(128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [one.submit(p, SERVE_NEW) for p in prompts]
    one_outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
    dt = time.perf_counter() - t0
    out["a"]["one_process_tokens_per_s"] = len(prompts) * SERVE_NEW / dt
    out["a"]["one_process_decode_16_slots"] = _meshserve_decode_ms(one)
    reply_n, exported_n = _meshserve_turn(one, first["n"], "n")
    reply_m, exported_m = _meshserve_turn(eng, first["m"], "m")
    one.stop()
    eng.stop()
    marks.append(("a_one_process_and_b_first_turns", time.perf_counter()))
    out["a"]["equal_to_one_process"] = sum(bool(np.array_equal(a, b))
                                           for a, b in zip(tp_outs, one_outs))
    out["a"]["tokens_equal_to_one_process"] = sum(int((a == b).sum())
                                                  for a, b in zip(tp_outs, one_outs))
    # (b) session m: tp 2 -> one process; session n: one process -> tp 2
    nxt = {s: np.concatenate([first[s], r, rng.integers(0, 32000, MESHSERVE_SUFFIX)
                              .astype(np.int32)]) for s, r in (("m", reply_m), ("n", reply_n))}
    one = engine(full, mesh=None, kv_block=FLEET_BLOCK)
    try:
        m_res = _meshserve_resume(one, exported_m, nxt["m"])
    finally:
        one.stop()
    eng = engine(full, kv_block=FLEET_BLOCK)
    try:
        n_res = _meshserve_resume(eng, exported_n, nxt["n"])
    finally:
        eng.stop()
    marks.append(("b", time.perf_counter()))
    out["b"] = {"tp2_to_tp1": m_res, "tp1_to_tp2": n_res,
                "blob_bytes": [len(exported_m[0][3]), len(exported_n[0][3])],
                "meta_equal": exported_m[0][2] == exported_n[0][2]}
    # (c) speculative decoding on the tp group, the draft whole on rank 0
    spec_prompts = [p for p in every if len(p) <= 256][:MESHSERVE_SPEC_REQUESTS]
    eng = engine(full, kv_block=FLEET_BLOCK, spec_k=SPEC_K, draft_model=_meshserve_draft())
    try:
        eng.warm(256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [eng.submit(p, SERVE_NEW) for p in spec_prompts]
        spec_outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
        dt = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    marks.append(("c", time.perf_counter()))
    out["c"] = {"requests": len(spec_prompts), "tokens_per_s": len(spec_prompts) * SERVE_NEW / dt,
                "spec_accept_rate": stats["spec_accept_rate"],
                "spec_rounds": stats["spec_rounds"]}
    # (d) the flagship teacher over tp: 3 heads a rank through the kernels
    teacher = _meshserve_teacher_model(full)
    B, L = MESHSERVE_TEACHER
    ids = np.random.default_rng(32).integers(0, 32000, (B, L)).astype(np.int32)
    A.reset_launch_counts()
    predict = module_teacher(copy.deepcopy(teacher), mesh=mesh, logical_rules=LOGICAL_RULES)
    try:
        predict({"ids": ids})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp_logits = predict({"ids": ids})["logits"]
        tp_ms = (time.perf_counter() - t0) * 1e3
    finally:
        predict.close()
    launches = A.launch_counts()
    plain = module_teacher(teacher)
    plain({"ids": ids})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_logits = plain({"ids": ids})["logits"]
    one_ms = (time.perf_counter() - t0) * 1e3
    a, b = torch.from_numpy(tp_logits), torch.from_numpy(one_logits)
    # bf16's floor: each bf16 path against the same weights computed in f32
    # (dense attention)
    ref = TransformerLM(dataclasses.replace(teacher.cfg, dtype=torch.float32),
                        init=False).to("cuda")
    ref.load_state_dict(teacher.state_dict())
    with torch.inference_mode():
        f32 = ref.eval()(torch.from_numpy(ids).cuda().long()).cpu()
    del ref
    out["d"] = {"shape": list(tp_logits.shape), "rel_err": rel_err(a, b),
                "tp2_vs_f32_rel_err": rel_err(a, f32), "one_process_vs_f32_rel_err": rel_err(b, f32),
                "max_abs_err": max_abs(a, b), "finite": bool(torch.isfinite(a).all()),
                "argmax_equal_share": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
                "tp2_ms_per_call": tp_ms, "one_process_ms_per_call": one_ms,
                "launches_per_call": {k: v / 2 for k, v in launches.items()},
                "rtol": MESHSERVE_TEACHER_RTOL}
    del teacher, plain, a, b, f32, tp_logits, one_logits
    torch.cuda.empty_cache()
    marks.append(("d", time.perf_counter()))
    # (e) a ReplicaServer over a tp-2 engine behind the Gateway
    store = MemoryKV(sweep_period=0.1)
    eng = engine(full, kv_block=FLEET_BLOCK)
    srv = ReplicaServer(store, "meshserve", eng, replica_id="tp2", host="127.0.0.1", ttl=10.0,
                        advert_period=0.2)
    gw = Gateway(store, "meshserve", GatewayConfig(max_inflight=16, max_queue=16,
                                                   request_timeout_s=SUBPROCESS_TIMEOUT,
                                                   poll_period_s=0.05, wait_slice_s=0.05))
    replica_prompts = spec_prompts[:MESHSERVE_REPLICA_REQUESTS]
    try:
        if not gw.wait_for_replicas(1, 30):
            raise AssertionError("the gateway never saw the tp-2 replica")
        futs = [gw.submit(p, SERVE_NEW) for p in replica_prompts]
        replica_outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
        out["e"] = {"replicas": sorted(gw.stats()["replicas"]),
                    "requests": len(replica_outs)}
    finally:
        gw.close()
        srv.close()
        store.close()
    marks.append(("e", time.perf_counter()))
    out["argmax"] = {
        "a_tp2": _argmax_check(full, prompts, tp_outs),
        "a_one_process": _argmax_check(full, prompts, one_outs),
        "b_tp2_to_tp1": _argmax_check(full, [nxt["m"]], [m_res.pop("out")]),
        "b_tp1_to_tp2": _argmax_check(full, [nxt["n"]], [n_res.pop("out")]),
        "c_spec": _argmax_check(full, spec_prompts, spec_outs),
        "e_replica": _argmax_check(full, replica_prompts, replica_outs)}
    out["lengths_ok"] = all(len(o) == SERVE_NEW for o in
                            tp_outs + one_outs + spec_outs + replica_outs)
    marks.append(("argmax_checks", time.perf_counter()))
    out["seconds"] = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    return out


def _meshserve_follower(mesh) -> dict:
    """Rank 1: follow each group rank 0 leads, in its order."""
    from edl_tpu_torch.distill.teacher import follow_teacher
    from edl_tpu_torch.models.transformer import LOGICAL_RULES
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.serving import ContinuousBatcher

    model = _serve_model()
    for _ in range(3):                  # (a), (b)'s import at tp 2 and (c)
        ContinuousBatcher.follow(model, mesh=mesh)
    teacher = _meshserve_teacher_model(model)
    A.reset_launch_counts()
    follow_teacher(teacher, mesh=mesh, logical_rules=LOGICAL_RULES)
    launches = A.launch_counts()
    del teacher
    ContinuousBatcher.follow(model, mesh=mesh)        # (e)
    return {"d": {"launches_per_call": {k: v / 2 for k, v in launches.items()}}}


def _meshserve_rank(rank: int, port: int, root: str) -> None:
    """One rank of the phase, in its own process: tp = 2 over gloo on
    cuda:0.  Writes ``root/rank<rank>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from edl_tpu_torch.parallel.tp import TP
    from edl_tpu_torch.serving.spmd import die_with_parent

    die_with_parent()                   # no rank outlives the script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=timedelta(seconds=SUBPROCESS_TIMEOUT))
    mesh = build_mesh(MeshSpec(dp=1, tp=2), pods=[0, 0], device_type="cuda")
    tp = TP.of(mesh)
    out = {"rank": rank, "collectives": _meshserve_collectives(tp)}
    out.update(_meshserve_leader(mesh) if rank == 0 else _meshserve_follower(mesh))
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(out, f, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o))
    dist.destroy_process_group()


def phase_meshserve(ctx) -> None:
    """Tensor-parallel serving at the flagship's width: two processes on the
    one card in a gloo group, rank 0 leading each group; (a) the paged
    engine, (b) sessions migrated across meshes, (c) speculative decoding,
    (d) the tp teacher through the splash kernels, (e) a tp replica behind
    the gateway."""
    import shutil
    import subprocess

    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    from edl_tpu_torch.utils.network import find_free_port
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_meshserve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log("meshserve", nvidia_smi=smi_name_and_power_limit())
    port = find_free_port()
    here = Path(__file__).resolve().parent
    files = [open(root / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                               "chip_smoke._meshserve_rank(int(sys.argv[1]), int(sys.argv[2]), "
                               "sys.argv[3])", str(r), str(port), str(root)],
                              cwd=here, stdout=fh, stderr=subprocess.STDOUT, text=True)
             for r, fh in enumerate(files)]
    try:
        for proc in procs:
            proc.wait(timeout=SUBPROCESS_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in files:
            fh.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise AssertionError(f"meshserve rank {r} exited {proc.returncode}:\n"
                                 f"{(root / f'rank{r}.log').read_text()[-4000:]}")
    r0, r1 = (json.loads((root / f"rank{r}.json").read_text()) for r in range(2))
    # (the kernels phase times the splash forward at TP_SHAPE)
    ctx["launches_meshserve"] = {"attention_fwd": r0["d"]["launches_per_call"]["attention_fwd"]}
    a, b, c, d, e = (r0[k] for k in "abcde")
    log("meshserve", nvidia_smi=smi_name_and_power_limit(), collectives=r0["collectives"],
        a={k: v for k, v in a.items() if k != "engine_stats"}, a_engine_stats=a["engine_stats"],
        b=b, c=c, d=d, d_follower=r1["d"], e=e, argmax=r0["argmax"], margin=SERVE_MARGIN,
        rank0_seconds=r0["seconds"])
    shutil.rmtree(root, ignore_errors=True)
    checks = r0["argmax"]
    if not r0["lengths_ok"]:
        raise AssertionError("a request returned the wrong number of tokens")
    if any(ch["mismatched"] for ch in checks.values()):
        raise AssertionError(f"emitted tokens differ from the full-prefix argmax: {checks}")
    if any(ch["checked"] < 0.1 * ch["tokens"] for ch in checks.values()):
        raise AssertionError(f"too few tokens clear the margin to be checked: {checks}")
    if (a["local_kv_heads"], a["local_qkv_rows"], a["local_head_rows"]) != (3, 9 * 128, 16000):
        raise AssertionError(f"rank 0 does not hold a tp-2 piece: {a}")
    for route in ("tp2_to_tp1", "tp1_to_tp2"):
        res = b[route]
        if res["kv_prefix_hits"] != 1 or res["kv_prefill_tokens_skipped"] != res["tokens"] \
                or res["tokens"] < MESHSERVE_SESSION - FLEET_BLOCK:
            raise AssertionError(f"the migrated session did not resume warm ({route}): {res}")
    if not b["meta_equal"] or b["blob_bytes"][0] != b["blob_bytes"][1]:
        raise AssertionError(f"the blobs of the two meshes differ in layout: {b}")
    if not d["finite"] or d["rel_err"] > MESHSERVE_TEACHER_RTOL:
        raise AssertionError(f"the tp-2 teacher's logits are not one process's: {d}")
    for launches in (d["launches_per_call"], r1["d"]["launches_per_call"]):
        if launches != {n: 12 if n == "attention_fwd" else 0 for n in launches}:
            raise AssertionError(f"the tp teacher's kernel launches a call: {launches}")
    if e["replicas"] != ["tp2"] or e["requests"] != MESHSERVE_REPLICA_REQUESTS:
        raise AssertionError(f"the gateway did not serve through the tp replica: {e}")


# -- phase 19 --------------------------------------------------------------------

MOE_ARGS = FLAGSHIP_ARGS + ["--moe", "8", "--moe_top_k", "2"]
MOE_WARMUP, MOE_STEPS = 2, 20
MOE_E, MOE_K, MOE_CAPACITY = 8, 2, 1.25
# (a): the 2-layer f32 MoE LM's first loss on the card against the CPU's
# (TF32 off; the two sum in other orders)
MOE_CPU_RTOL = 1e-4
# (b) and the ring phase: a run split over two processes (ep 2, sp 2)
# against one process, both bf16, losses to 1e-3 of one process's: on the
# H100 the worst readings were 1.62e-4 (ep 2; the combine's partial sums
# are each rounded to bf16 before the all-reduce adds them), 9.26e-5 (sp 2
# ring) and 1.15e-5 (sp 2 gathered), the same in every run (PERF.md §6);
# 1e-3 is 6x the largest and under bf16's unit roundoff, 2^-8
SPLIT_LOSS_RTOL = 1e-3
MOE_EP_ARGS = ["--layers", "2"] + MOE_ARGS[2:]
MOE_EP_STEPS = 3
# the device kernels of a library attention: none may run on the MoE path
LIBRARY_ATTENTION = ("pytorch_flash", "fmha", "cudnn", "efficient_attention", "sdpa")


def _moe_active_params(cfg) -> int:
    """Parameters a token's forward reads: all but the experts it is not
    routed to (top_k of E experts a layer)."""
    from edl_tpu_torch.models.transformer import param_count
    inactive = (cfg.moe_experts - cfg.moe_top_k) * 2 * cfg.embed_dim * cfg.mlp_dim
    return param_count(cfg) - cfg.num_layers * inactive


def _piece_device_ms(fn, reps: int = 3) -> float:
    """Device ms of one call of ``fn()``: CUDA events around ``reps``
    calls queued behind a spin kernel of ~0.2 s, so the host has queued
    them all before the card reaches the first and no launch gap falls
    between the events (a profiler window lost records of these pieces
    in some runs)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _moe_pieces(cfg, batch: int, seq: int) -> dict:
    """Device ms a step of the MoE layer's parts, each timed alone forward
    and backward at the flagship's shapes (``_piece_device_ms``) and
    multiplied by the layers: the router and routing
    (``compute_routing``), the dispatch and combine einsums, the expert
    products; and the fused CE once."""
    import torch

    from edl_tpu_torch.ops.ce import blockwise_cross_entropy
    from edl_tpu_torch.ops.moe import capacity_of, compute_routing
    g = torch.Generator(device="cuda").manual_seed(19)
    B, S, M, H, E, K = batch, seq, cfg.embed_dim, cfg.mlp_dim, cfg.moe_experts, cfg.moe_top_k
    C = capacity_of(K, S, cfg.moe_capacity, E)
    bf = torch.bfloat16

    def leaf(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype).requires_grad_()

    x, gate = leaf(B, S, M, dtype=bf), leaf(M, E, scale=M ** -0.5)
    w_in, w_out = leaf(E, M, H, scale=M ** -0.5), leaf(E, H, M, scale=H ** -0.5)
    with torch.no_grad():
        probs = torch.softmax(x.float() @ gate, -1)
        dispatch, combine, _, _ = compute_routing(probs, K, C)
    combine = combine.requires_grad_()
    expert_in, out = leaf(E, B, C, M, dtype=bf), leaf(E, B, C, M, dtype=bf)
    hidden, head = leaf(B, S, M), leaf(M, cfg.vocab_size, scale=M ** -0.5)
    targets = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")

    def routing():
        _, c, aux, _ = compute_routing(torch.softmax(x.float() @ gate, -1), K, C)
        (c.sum() + aux).backward()

    def dispatch_combine():
        e = torch.einsum("bsec,bsm->ebcm", dispatch.to(bf), x)
        y = torch.einsum("bsec,ebcm->bsm", combine.to(bf), out)
        (e.float().sum() + y.float().sum()).backward()

    def experts():
        h = torch.nn.functional.silu(torch.einsum("ebcm,emh->ebch", expert_in, w_in.to(bf)))
        torch.einsum("ebch,ehm->ebcm", h, w_out.to(bf)).float().sum().backward()

    def ce():
        blockwise_cross_entropy(hidden, head, targets, block_size=4096).sum().backward()

    L = cfg.num_layers
    out_ms = {}
    for name, fn, times in (("routing", routing, L), ("dispatch_combine", dispatch_combine, L),
                            ("expert_gemms", experts, L), ("ce", ce, 1)):
        out_ms[name] = _piece_device_ms(fn) * times
    out_ms["capacity"] = C
    return out_ms


def _moe_flagship(ctx) -> dict:
    """(a) the MoE flagship through train_lm's trainer on a fixed batch:
    tokens/s, peak memory, the loss falling over 20 steps, the splash
    kernels 12 times a step each and no library attention."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import param_count
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    args = train_lm.parse_args(MOE_ARGS)
    device = torch.device("cuda")
    t_build = time.perf_counter()
    cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    build_s = time.perf_counter() - t_build
    # serve_lm --moe 8 builds these same seed-0 weights: (c)'s reference,
    # kept on the host so the peak below is the training step's
    ctx["moe_seed0"] = {k: v.detach().to("cpu", copy=True)
                        for k, v in state.model.state_dict().items()}
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)
    batch = {"ids": torch.from_numpy(ids).to(device)}
    gen = torch.Generator(device=device).manual_seed(3)
    losses, auxes = [], []
    for _ in range(MOE_WARMUP):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
        auxes.append(metrics["moe_aux"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(MOE_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
        auxes.append(metrics["moe_aux"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = A.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, auxes = [float(x) for x in losses], [float(x) for x in auxes]
    tok_s = args.batch_size * args.seq_len * MOE_STEPS / dt
    device_kernels = A.device_kernels(cfg.head_dim)
    # a profile can lose a kernel's record at a window's edge: one whose
    # attention counts are not 12 a step each is taken again (at most 5)
    for retakes in range(5):
        rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
        attn_rows = [r for r in rows if _kernel_group(r[1]).startswith("attention")]
        if sum(r[2] for r in attn_rows) == 2 * len(device_kernels) * cfg.num_layers:
            break
    busy = sum(r[0] for r in rows) / 2 / 1e3
    library = [r[1][:100] for r in rows if any(t in r[1].lower() for t in LIBRARY_ATTENTION)]
    by_kernel = {k: sum(n for _, key, n in attn_rows if re.search(rf"::{k}[<(]", key)) / 2
                 for k in device_kernels}
    del trainer, state
    torch.cuda.empty_cache()
    groups = {"splash_kernels": sum(r[0] for r in attn_rows) / 2 / 1e3,
              **_moe_pieces(cfg, args.batch_size, args.seq_len)}
    out = {"nvidia_smi": smi_name_and_power_limit(), "params": param_count(cfg),
           "active_params_per_token": _moe_active_params(cfg), "experts": cfg.moe_experts,
           "top_k": cfg.moe_top_k, "capacity_factor": cfg.moe_capacity, "remat": cfg.remat,
           "build_seconds": build_s, "steps": MOE_STEPS, "step_ms": dt / MOE_STEPS * 1e3,
           "tokens_per_s": tok_s, "max_memory_allocated": peak, "losses": losses,
           "moe_aux": auxes, "launches": launches, "device_busy_ms_per_step": busy,
           "ms_per_step_by_group": groups, "profile_attention_calls_per_step": by_kernel,
           "profile_retakes": retakes,
           "library_attention_kernels": library}
    log("moe_flagship", **out)
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"non-finite loss or aux: {losses} {auxes}")
    if not losses[-1] < losses[0] - 0.1:
        raise AssertionError(f"the MoE loss did not fall: {losses}")
    per_step = cfg.num_layers * MOE_STEPS
    want = {n: per_step if n in SPLASH_WRAPPERS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} (12 layers x {MOE_STEPS} "
                             f"steps on the splash kernels)")
    if any(n != cfg.num_layers for n in by_kernel.values()) or \
            sum(r[2] for r in attn_rows) / 2 != len(device_kernels) * cfg.num_layers:
        raise AssertionError(f"the profile's attention kernels a step: {by_kernel}")
    if library:
        raise AssertionError(f"a library attention kernel ran on the MoE path: {library}")
    ctx["moe_first_loss"] = losses[0]
    return out


def _moe_card_vs_cpu() -> dict:
    """(a) the 2-layer MoE LM at full width in f32 from seed-0 weights: its
    first loss (fused CE + 0.01 aux) on the card against the CPU's."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, embed_dim=768, num_heads=6,
                            mlp_dim=3072, max_len=1024, moe_experts=MOE_E, moe_top_k=MOE_K,
                            dtype=torch.float32, remat=False)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 32000, (2, 1025)))
    weights = TransformerLM(cfg, torch.Generator().manual_seed(0)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(cfg, init=False)
        model.load_state_dict(weights)
        model.to(dev)
        x = ids.to(dev)
        with torch.no_grad():
            nll, aux = model(x[:, :-1], targets=x[:, 1:], with_aux=True)
        out[dev] = float(nll.mean() + 0.01 * aux)
        del model
    rel = abs(out["cuda"] - out["cpu"]) / abs(out["cpu"])
    res = {"loss_card": out["cuda"], "loss_cpu": out["cpu"], "rel": rel, "rtol": MOE_CPU_RTOL}
    log("moe_card_vs_cpu", **res)
    if rel > MOE_CPU_RTOL:
        raise AssertionError(f"the card's first MoE loss is not the CPU's: {res}")
    return res


def _timed_collectives(fn, names=("all_reduce",)) -> tuple:
    """``fn()`` with every ``torch.distributed`` call of ``names`` timed
    where it is entered (the card synchronised before and after, so a
    call's time is the collective's own, its copies through the host
    included): ``(fn's result, {name: [seconds, calls]})``."""
    import torch
    import torch.distributed as dist
    spent = {name: [0.0, 0] for name in names}
    plain = {name: getattr(dist, name) for name in names}

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = plain[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += 1
            return result
        return call

    for name in names:
        setattr(dist, name, timed(name))
    try:
        return fn(), spent
    finally:
        for name, f in plain.items():
            setattr(dist, name, f)


def _pair_world(rank: int, port: int):
    """Join a 2-rank gloo world on cuda:0 (one card, two processes); checks
    that gloo all-reduces a CUDA tensor."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from edl_tpu_torch.serving.spmd import die_with_parent
    die_with_parent()                   # no rank outlives the script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=timedelta(seconds=SUBPROCESS_TIMEOUT))
    probe = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(probe)
    if probe.tolist() != [3.0] * 4:
        raise AssertionError(f"gloo all-reduced a CUDA tensor to {probe}")
    return torch.device("cuda", 0)


def _train_steps(args, device, batch, steps, timed_step=None, logical=True,
                 on_grads=None) -> dict:
    """``steps`` steps of train_lm's trainer on a fixed batch: the losses,
    wall ms and launch counts; ``timed_step(step_fn)`` runs one more step
    its own way and its result is kept; ``on_grads(grads)`` is given the
    step-1 gradients of every parameter (f32 on the host, whole: for
    models that no tp, ep or fsdp cuts) and its result kept."""
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import LOGICAL_RULES
    from edl_tpu_torch.ops import attention as A
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx, LOGICAL_RULES if logical else None)
    gen = torch.Generator(device=device).manual_seed(3)
    A.reset_launch_counts()
    losses, wall, step1 = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(float(metrics["loss"]))
        wall.append((time.perf_counter() - t0) * 1e3)
        if step == 0 and on_grads is not None:
            step1 = on_grads({n: p.grad.float().cpu()
                              for n, p in state.model.named_parameters()})
    out = {"losses": losses, "wall_ms": wall, "launches": A.launch_counts(),
           "mesh": train_lm._mesh(trainer), "step1_grads": step1}
    if state.model.layers[0].cfg.moe_experts:
        out["w_in_local"] = list(state.model.layers[0].moe.w_in.shape)
    if timed_step is not None:
        out["timed"] = timed_step(lambda: trainer.step_fn(state, batch, gen))
    del trainer, state
    torch.cuda.empty_cache()
    return out


def _moe_batch(args):
    import numpy as np
    return np.random.default_rng(4).integers(0, args.vocab, (args.batch_size,
                                                            args.seq_len + 1)).astype(np.int32)


def _moe_ep_rank(rank: int, port: int, root: str) -> None:
    """(b) one rank of ep = 2 over gloo on cuda:0, 2 layers at full width:
    3 steps, then one with its gloo calls timed.  Writes
    ``root/ep<rank>.json``."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    device = _pair_world(rank, port)
    args = train_lm.parse_args(MOE_EP_ARGS + ["--ep", "2", "--tp", "1"])
    batch = {"ids": torch.from_numpy(_moe_batch(args)).to(device)}

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, spent = _timed_collectives(step)
        wall = (time.perf_counter() - t0) * 1e3
        return {"wall_ms": wall, "gloo_ms": spent["all_reduce"][0] * 1e3,
                "all_reduces": spent["all_reduce"][1]}

    out = _train_steps(args, device, batch, MOE_EP_STEPS, timed)
    with open(f"{root}/ep{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn_pair(target: str, root: Path) -> None:
    """``chip_smoke.<target>(rank, port, root)`` in two processes on the one
    card; raises with a rank's log when it fails."""
    import subprocess

    from edl_tpu_torch.utils.network import find_free_port
    port = find_free_port()
    here = Path(__file__).resolve().parent
    files = [open(root / f"{target}{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                               f"chip_smoke.{target}(int(sys.argv[1]), int(sys.argv[2]), "
                               "sys.argv[3])", str(r), str(port), str(root)],
                              cwd=here, stdout=fh, stderr=subprocess.STDOUT, text=True)
             for r, fh in enumerate(files)]
    try:
        for proc in procs:
            proc.wait(timeout=SUBPROCESS_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in files:
            fh.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise AssertionError(f"{target} rank {r} exited {proc.returncode}:\n"
                                 f"{(root / f'{target}{r}.log').read_text()[-4000:]}")


def _moe_ep(root: Path) -> dict:
    """(b) ep 2 against ep 1: 3 steps' losses, the experts each rank holds,
    and the gloo ms inside a step."""
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    args = train_lm.parse_args(MOE_EP_ARGS)
    one = _train_steps(args, torch.device("cuda", 0),
                       {"ids": torch.from_numpy(_moe_batch(args)).cuda()}, MOE_EP_STEPS,
                       logical=False)
    _spawn_pair("_moe_ep_rank", root)
    ranks = [json.loads((root / f"ep{r}.json").read_text()) for r in range(2)]
    rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], one["losses"]))
    out = {"nvidia_smi": smi_name_and_power_limit(), "ep1_losses": one["losses"],
           "ep2_losses": [r["losses"] for r in ranks], "loss_rel_max": rel,
           "rtol": SPLIT_LOSS_RTOL, "ep1_wall_ms": one["wall_ms"],
           "ep2_wall_ms": [r["wall_ms"] for r in ranks], "w_in_local": ranks[0]["w_in_local"],
           "mesh": ranks[0]["mesh"], "timed_step": [r["timed"] for r in ranks]}
    log("moe_ep", **out)
    if rel > SPLIT_LOSS_RTOL or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"ep 2's losses are not ep 1's: {out}")
    if ranks[0]["w_in_local"] != [MOE_E // 2, 768, 3072] or ranks[0]["mesh"]["ep"] != 2:
        raise AssertionError(f"a rank does not hold half the experts: {out}")
    return out


def _moe_serve_model(weights):
    """serve_lm --moe 8's model, bf16, over ``weights`` (its seed-0
    weights, which train_lm's model of (a) starts from)."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, embed_dim=768, num_heads=6,
                            mlp_dim=3072, max_len=1024, moe_experts=MOE_E, moe_top_k=MOE_K,
                            remat=False, dtype=torch.bfloat16)
    with torch.device("meta"):
        model = TransformerLM(cfg, init=False)
    model.load_state_dict(weights, assign=True)
    return model.to("cuda").requires_grad_(False).eval()


def _generate_check(model, prompts, outs) -> dict:
    """Each emitted token against ``generate`` teacher-forced on the emitted
    tokens (each prompt's prefill unpadded, as ``generate``'s, then the
    drop-free decode steps of every request at once, each lane at its own
    position): held to its argmax where that step's top-2 margin exceeds
    SERVE_MARGIN (the engine's prefill pads the prompt to its bucket, and
    capacity follows the padded length)."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.generate import cache_length
    from edl_tpu_torch.models.transformer import KVCache, decode_model
    dm = decode_model(model)
    N = len(outs[0])
    length = cache_length(dm.cfg.max_len, max(len(p) for p in prompts), N)
    cache = KVCache.zeros(dm.cfg, len(prompts), length, "cuda")
    with torch.inference_mode():
        rows = []
        for i, prompt in enumerate(prompts):
            slab = KVCache.zeros(dm.cfg, 1, length, "cuda")
            hidden = dm(torch.from_numpy(prompt[None]).cuda(), cache=slab, return_hidden=True)
            rows.append(dm.head(hidden[:, -1]))
            for big, small in zip(cache.keys + cache.values, slab.keys + slab.values):
                big[i] = small[0]
            cache.index[i] = len(prompt)
        steps = [torch.cat(rows)]
        toks = torch.from_numpy(np.stack(outs).astype(np.int64)).cuda()
        for t in range(N - 1):
            hidden = dm(toks[:, t:t + 1], positions=cache.index[:, None], cache=cache,
                        return_hidden=True)
            steps.append(dm.head(hidden[:, 0]))
        top = torch.stack(steps, dim=1).topk(2, dim=-1)             # [B, N, 2]
    sure = (top.values[..., 0] - top.values[..., 1] > SERVE_MARGIN).cpu().numpy()
    wrong = sure & (top.indices[..., 0].cpu().numpy() != np.stack(outs))
    return {"tokens": int(sure.size), "checked": int(sure.sum()), "mismatched": int(wrong.sum())}


def _moe_serve(proc, log_path, weights) -> dict:
    """(c) ``serve_lm --moe 8 --continuous 16`` at the flagship's width
    (``proc``, its output in ``log_path``): 32 requests over the wire,
    tokens/s, ``moe_prefill_drops``, and the tokens against ``generate``
    under the margin rule; the server is stopped."""
    import signal

    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    try:
        prompts = _serve_prompts()
        outs, wire = _serve_wire(proc, log_path, prompts)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except Exception:  # noqa: BLE001 — killed below
            proc.kill()
            proc.wait()
    check = _generate_check(_moe_serve_model(weights), prompts, outs)
    stats = wire["engine_stats"]
    out = {"nvidia_smi": smi_name_and_power_limit(), "requests": len(prompts),
           "tokens_per_s": wire["tokens_per_s"], "seconds": wire["seconds"],
           "moe_prefill_drops": stats.get("moe_prefill_drops"), "generate_check": check,
           "margin": SERVE_MARGIN}
    log("moe_serve", **out)
    if not isinstance(stats.get("moe_prefill_drops"), int):
        raise AssertionError(f"the server's stats carry no moe_prefill_drops: {stats}")
    if check["mismatched"] or check["checked"] < 0.1 * check["tokens"]:
        raise AssertionError(f"served tokens differ from generate's under the margin: {check}")
    return out


def phase_moe(ctx) -> None:
    """The mixture-of-experts LM: (a) the MoE flagship (and its 2-layer
    f32 first loss against the CPU's), (b) ep 2 over gloo on the one card
    against ep 1, (c) serve_lm --moe 8 over the wire."""
    import shutil

    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_moe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log_path = root / "serve_moe.log"
    proc = _start_server(log_path, ["--moe", str(MOE_E), "--moe_top_k", str(MOE_K)])
    try:
        log("moe", nvidia_smi=smi_name_and_power_limit())
        marks = [time.perf_counter()]
        _moe_flagship(ctx)
        marks.append(time.perf_counter())
        _moe_card_vs_cpu()
        marks.append(time.perf_counter())
        _moe_ep(root)
        marks.append(time.perf_counter())
        _moe_serve(proc, log_path, ctx.pop("moe_seed0"))
        marks.append(time.perf_counter())
        log("moe", seconds=dict(zip(("a_flagship", "a_card_vs_cpu", "b_ep", "c_serve"),
                                    (b - a for a, b in zip(marks, marks[1:])))))
    finally:
        ctx.pop("moe_seed0", None)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


# -- phase 20 --------------------------------------------------------------------

RING_ARGS = ["--layers", "2", "--embed", "768", "--heads", "6", "--mlp", "3072",
             "--vocab", "32000", "--seq_len", "2048", "--batch_size", "4", "--fused_ce",
             "--lr", "3e-4"]
RING_STEPS = 3
# the step-1 gradient of every parameter, sp 2 against one process, in
# relative norm, as the mesh phase holds tp 2's: on the H100 the worst
# parameter read 1.40e-2 (ring: plain bf16 a hop against the kernel) and
# 6.53e-3 (gathered: each rank's gradient over its half of the sequence
# is rounded to bf16 before the all-reduce adds them), the embedding's
# both times (PERF.md §6); 3e-2 is twice the larger
SP_GRAD_RTOL = 3e-2


def _grads_against(path: str):
    """``on_grads`` for ``_train_steps``: each parameter's step-1 gradient
    against the one process's saved at ``path``, in relative norm."""
    import torch

    def compare(grads):
        want = torch.load(path, weights_only=True)
        errs = {n: rel_err(g, want[n]) for n, g in grads.items()}
        if errs.keys() != want.keys():
            raise AssertionError(f"parameters differ: {sorted(errs)} != {sorted(want)}")
        return {"grad_rel_err_max": max(errs.values()),
                "grad_rel_err_worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3]}
    return compare


def _ring_rank(rank: int, port: int, root: str) -> None:
    """One rank of sp = 2 over gloo on cuda:0: (a) ring attention, then (b)
    the gathered sequence through the splash kernels, 3 steps each (rank
    0 holds the step-1 gradients against one process's) and one more with
    its collectives timed.  Writes ``root/ring<rank>.json``."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.ops import ring
    device = _pair_world(rank, port)
    out = {}
    for mode, extra in (("ring", ["--attention", "ring"]), ("gathered", [])):
        args = train_lm.parse_args(RING_ARGS + ["--sp", "2"] + extra)
        batch = {"ids": torch.from_numpy(_moe_batch(args)).to(device)}

        def timed(step):
            hops = [0.0, 0, 0]
            plain = ring._shift

            def shift(x, group, s):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = plain(x, group, s)
                torch.cuda.synchronize()
                hops[0] += time.perf_counter() - t0
                hops[1] += 1
                hops[2] += x.numel() * x.element_size()
                return y

            ring._shift = shift
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, spent = _timed_collectives(step)
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                ring._shift = plain
            return {"wall_ms": wall, "hops": hops[1],
                    "ms_per_hop": hops[0] / max(1, hops[1]) * 1e3,
                    "bytes_rotated": hops[2], "gloo_all_reduce_ms": spent["all_reduce"][0] * 1e3,
                    "all_reduces": spent["all_reduce"][1]}

        out[mode] = _train_steps(args, device, batch, RING_STEPS, timed,
                                 on_grads=_grads_against(f"{root}/plain_grads.pt")
                                 if rank == 0 else None)
    with open(f"{root}/ring{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_ring(ctx) -> None:
    """Sequence parallelism at the flagship's width, seq 2048, batch 4, 2
    layers: sp = 2 over gloo on the one card with (a) ring attention and
    (b) the gathered sequence, each against one process's splash run: the
    losses of 3 steps and the step-1 gradients."""
    import shutil

    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ring"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        args = train_lm.parse_args(RING_ARGS)
        one = _train_steps(args, torch.device("cuda", 0),
                           {"ids": torch.from_numpy(_moe_batch(args)).cuda()}, RING_STEPS,
                           logical=False,
                           on_grads=lambda g: torch.save(g, root / "plain_grads.pt"))
        _spawn_pair("_ring_rank", root)
        ranks = [json.loads((root / f"ring{r}.json").read_text()) for r in range(2)]
        out = {"nvidia_smi": smi_name_and_power_limit(), "splash_losses": one["losses"],
               "splash_wall_ms": one["wall_ms"], "splash_launches": one["launches"],
               "rtol": SPLIT_LOSS_RTOL, "grad_rtol": SP_GRAD_RTOL}
        for mode in ("ring", "gathered"):
            runs = [r[mode] for r in ranks]
            rel = max(abs(a - b) / abs(b) for r in runs
                      for a, b in zip(r["losses"], one["losses"]))
            out[mode] = {"losses": [r["losses"] for r in runs], "loss_rel_max": rel,
                         "wall_ms": [r["wall_ms"] for r in runs],
                         "launches": runs[0]["launches"], "mesh": runs[0]["mesh"],
                         "step1_grads": runs[0]["step1_grads"],
                         "timed_step": [r["timed"] for r in runs]}
        log("ring", **out)
        for mode, want in (("ring", 0), ("gathered", RING_STEPS * 2)):
            res = out[mode]
            if res["loss_rel_max"] > SPLIT_LOSS_RTOL or res["losses"][0] != res["losses"][1]:
                raise AssertionError(f"sp 2 ({mode}) losses are not one process's: {res}")
            if res["step1_grads"]["grad_rel_err_max"] > SP_GRAD_RTOL:
                raise AssertionError(f"sp 2 ({mode}) gradients are not one process's: {res}")
            if res["mesh"]["sp"] != 2:
                raise AssertionError(f"not an sp = 2 mesh: {res['mesh']}")
            launches = res["launches"]
            if launches != {n: want if n in SPLASH_WRAPPERS else 0 for n in launches}:
                raise AssertionError(f"sp 2 ({mode}) kernel launches: {launches}")
        if out["ring"]["timed_step"][0]["hops"] == 0:
            raise AssertionError("the ring rotated nothing")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated subset of {','.join(PHASES)}")
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    # every comparison below is against full-f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_and_power_limit()
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0))

    ctx: dict = {}
    runners = {"build": phase_build, "kernels": phase_kernels, "parity": phase_parity,
               "flagship": phase_flagship, "flash": phase_flash, "d256": phase_d256,
               "d384": phase_d384, "d768": phase_d768, "resnet": phase_resnet,
               "resume": phase_resume, "data": phase_data,
               "elastic": phase_elastic, "serve": phase_serve, "fleet": phase_fleet,
               "distill": phase_distill, "reshard": phase_reshard, "mesh": phase_mesh,
               "meshserve": phase_meshserve, "moe": phase_moe, "ring": phase_ring}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            runners[name](ctx)
            log(name, phase_seconds=time.perf_counter() - t0)

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
                "profile_retakes": r.get("profile_retakes")}

    kern, launches = ctx.get("kernels", {}), ctx.get("launches", {})
    entries = [entry(kname, source, replaces, launches.get(wrapper), kern.get(wrapper, {}))
               for wrapper, (kname, source, replaces) in KERNELS.items()]
    # the d256 phase's kernels: the splash path at [8, 1024, 3, 256]
    kern, launches = ctx.get("kernels_d256", {}), ctx.get("launches_d256", {})
    entries += [entry(f"{KERNELS[w][0]} at D=256", SM90, KERNELS[w][2], launches.get(w),
                      kern.get(w, {})) for w in SPLASH_WRAPPERS]
    # the d384 phase's kernels: the splash path at [8, 1024, 2, 384]
    kern, launches = ctx.get("kernels_d384", {}), ctx.get("launches_d384", {})
    entries += [entry(f"{kname} at D=384", source, replaces, launches.get(w), kern.get(w, {}))
                for w, (kname, source, replaces) in KERNELS_D384.items()]
    # the d768 phase's kernels: the splash path at [8, 1024, 1, 768]
    kern, launches = ctx.get("kernels_d768", {}), ctx.get("launches_d768", {})
    entries += [entry(f"{kname} at D=768", source, replaces, launches.get(w), kern.get(w, {}))
                for w, (kname, source, replaces) in KERNELS_D768.items()]
    # the meshserve phase's kernel: the tp-2 teacher's splash forward, 3 heads
    # a rank at TP_SHAPE (launches a call on rank 0; timed in the kernels phase)
    kern, launches = ctx.get("kernels_meshserve", {}), ctx.get("launches_meshserve", {})
    entries.append(entry("edl_attn_fwd at tp=2 (3 heads a rank)", SM90, KERNELS["attention_fwd"][2],
                         launches.get("attention_fwd"), kern.get("attention_fwd", {})))
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
