"""Coordination-store names, trainer, data-service and serving knobs the port uses
(copies of the JAX package's ``utils/constants.py`` entries, under the
same ``EDL_TPU_*`` names and defaults).

The store's table names are the contract with the JAX launcher, which
reads what a trainer writes; the knobs are read from the environment
when asked, so one process can see them change (tests do).
"""

import os

ROOT = "/edl_tpu"                   # a job's state lives under ROOT/<job_id>/<table>/
ETCD_POD_RANK = "rank"              # leader seat lives at rank/0
ETCD_STATE = "state"                # train State (data checkpoint etc.)
ETCD_TRAIN_STATUS = "train_status"  # per-pod TrainStatus
ETCD_HEARTBEAT = "heartbeat"        # per-pod trainer liveness beats
ETCD_RECOVERY = "recovery"          # per-stage resize timing records
ETCD_CLUSTER = "cluster"            # the generated Cluster JSON
ETCD_READER = "reader"              # distributed-reader registry
ETCD_SERVING = "serving"            # leased LM replica adverts (gateway fleet)
ETCD_MEMSTATE = "memstate"          # peer checkpoint-cache adverts + commit record
ETCD_RESHARD = "reshard"            # live-reshard handshake (flag/go/done/worldsvc)
ETCD_TORCH_WORLD = "torchworld"     # the port's process-group rendezvous keys
ETCD_SCALE = "scale"                # desired size, range, spec, demand, backlogs
ETCD_DIST_READER = "dist_reader"    # the data service's generation journal
ETCD_OBS = "obs"                    # leased /metrics endpoint adverts (obs agg)
LEADER_KEY = "0"                    # rank table key seized by the leader
TTL_REFRESH_FRACTION = 0.5          # a leased key's keep-alive runs at ttl/2
# the exit code of a trainer after its preemption-point checkpoint: the
# launcher reads it as a clean coordinated departure, not success, not a crash
PREEMPT_EXIT_CODE = 94
# a data-service batch carries its consumed record spans under this key;
# the trainer pops it and marks the DataCheckpoint when it trains the batch
DATA_SPANS_KEY = "__consumed_spans__"


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def hang_timeout() -> float:
    """``EDL_TPU_HANG_TIMEOUT``: the launcher's hang watchdog.  0 (the
    default) = auto, the trainer publishes its own stale threshold with
    each beat; > 0 = an explicit threshold in seconds; < 0 = disabled."""
    return _env_float("EDL_TPU_HANG_TIMEOUT", 0.0)


def lr_rescale() -> bool:
    """``EDL_TPU_LR_RESCALE=1``: the trainer builds its optimizer with a
    world-scale stage (``train/lr.py``) and rescales the effective LR by
    new_world / old_world on a restore across a world change."""
    return bool(int(_env_float("EDL_TPU_LR_RESCALE", 0)))


def resize_delta() -> bool:
    """``EDL_TPU_RESIZE_DELTA``: the launcher's live-reshard path, on
    unless set to 0 (the JAX package's default)."""
    return bool(int(_env_float("EDL_TPU_RESIZE_DELTA", 1)))


def resize_reshard_timeout() -> float:
    """``EDL_TPU_RESIZE_RESHARD_TIMEOUT``: bounds a trainer's wait for the
    live reshard's go record and re-formed world (the launcher waits as
    long, plus 10 s, for the done records before it stop-resumes)."""
    return _env_float("EDL_TPU_RESIZE_RESHARD_TIMEOUT", 60.0)


def resize_min_delta() -> float:
    """``EDL_TPU_RESIZE_MIN_DELTA``: the least fraction of cached bytes that
    must stay on surviving owners for the launcher to reshard live (0:
    always)."""
    return _env_float("EDL_TPU_RESIZE_MIN_DELTA", 0.0)


# -- the peer checkpoint cache and the delta plane (memstate/) -----------------
def memstate() -> bool:
    """``EDL_TPU_MEMSTATE``: committed saves tee into the pod's in-RAM
    checkpoint cache and restores try it before storage (on unless 0)."""
    return bool(int(_env_float("EDL_TPU_MEMSTATE", 1)))


def memstate_max_bytes() -> int:
    """``EDL_TPU_MEMSTATE_MAX_BYTES``: the bytes a cache service holds,
    staged and committed (0: no cap); an over-cap push is rejected."""
    return int(_env_float("EDL_TPU_MEMSTATE_MAX_BYTES", 0))


def delta_every() -> int:
    """``EDL_TPU_DELTA_EVERY``: a delta record of the changed shards is
    streamed to the ring replica every this many steps (0: no delta plane)."""
    return int(_env_float("EDL_TPU_DELTA_EVERY", 10))


def delta_max_chain() -> int:
    """``EDL_TPU_DELTA_MAX_CHAIN``: records a chain holds before the
    producer stops staging until the next checkpoint."""
    return int(_env_float("EDL_TPU_DELTA_MAX_CHAIN", 64))


def transfer_workers() -> int:
    """``EDL_TPU_TRANSFER_WORKERS``: threads a shard push or restore fans
    distinct shards across."""
    return int(_env_float("EDL_TPU_TRANSFER_WORKERS", 4))


def stripe_min_bytes() -> int:
    """``EDL_TPU_STRIPE_MIN_BYTES``: a shard at least this large is fetched
    in ranges striped over every holder."""
    return int(_env_float("EDL_TPU_STRIPE_MIN_BYTES", 8 << 20))


def transfer_budget_bytes() -> int:
    """``EDL_TPU_TRANSFER_BUDGET_BYTES``: fetched bytes a restore holds on
    the host before it moves them to the device (0: no bound)."""
    return int(_env_float("EDL_TPU_TRANSFER_BUDGET_BYTES", 1 << 30))


def preempt_check_steps() -> int:
    """``EDL_TPU_PREEMPT_CHECK_STEPS``: a world of several processes makes
    its first preempt-flag check on a multiple of this many steps (the only
    cadence every process knows before any agreement exists); later checks
    land on a step the check itself agrees on."""
    return int(_env_float("EDL_TPU_PREEMPT_CHECK_STEPS", 8))


def preempt_check_seconds() -> float:
    """``EDL_TPU_PREEMPT_CHECK_SECONDS``: the wall time between preempt-flag
    checks (a solo process's cadence; a world's agreed step spacing)."""
    return _env_float("EDL_TPU_PREEMPT_CHECK_SECONDS", 2.0)


def coord_retry_deadline() -> float:
    """``EDL_TPU_COORD_RETRY_DEADLINE``: the resilient store client's total
    retry budget for one op (s), backoff and failover inside it."""
    return _env_float("EDL_TPU_COORD_RETRY_DEADLINE", 30.0)


def coord_backoff_init() -> float:
    """``EDL_TPU_COORD_BACKOFF_INIT``: its first backoff (s)."""
    return _env_float("EDL_TPU_COORD_BACKOFF_INIT", 0.05)


def coord_backoff_max() -> float:
    """``EDL_TPU_COORD_BACKOFF_MAX``: its largest backoff (s)."""
    return _env_float("EDL_TPU_COORD_BACKOFF_MAX", 2.0)


def etcd_ttl() -> float:
    """``EDL_TPU_TTL``: the lease TTL of a registration (s)."""
    return _env_float("EDL_TPU_TTL", 15.0)


def prefill_chunk() -> int:
    """``EDL_TPU_PREFILL_CHUNK``: the serving engine prefills a prompt
    longer than this many tokens in chunks of this size, one a tick,
    between its decode steps (0: every admission in one pass)."""
    return int(_env_float("EDL_TPU_PREFILL_CHUNK", 512))


def spec_k() -> int:
    """``EDL_TPU_SPEC_K``: draft tokens a round of speculative decoding
    proposes, verified by the target in one multi-token pass (0: off;
    greedy engines only)."""
    return int(_env_float("EDL_TPU_SPEC_K", 0))


# -- the paged KV pool and the serving fleet (serving/, gateway/) ---------------
def kv_block() -> int:
    """``EDL_TPU_KV_BLOCK``: the replica CLI's paged-KV block size in tokens
    (0: contiguous slabs, no prefix reuse, no migration)."""
    return int(_env_float("EDL_TPU_KV_BLOCK", 16))


def kv_pool_blocks() -> int:
    """``EDL_TPU_KV_POOL_BLOCKS``: the pool's blocks (0: twice the slot
    pool's worth, plus the scratch block)."""
    return int(_env_float("EDL_TPU_KV_POOL_BLOCKS", 0))


def kv_reuse() -> bool:
    """``EDL_TPU_KV_REUSE``: prefix reuse on admission (0: commit and
    migrate only, every admission prefills cold)."""
    return bool(int(_env_float("EDL_TPU_KV_REUSE", 1)))


def kv_migrate() -> bool:
    """``EDL_TPU_KV_MIGRATE``: a draining replica pushes its pinned session
    chains to an adoptive replica."""
    return bool(int(_env_float("EDL_TPU_KV_MIGRATE", 1)))


def kv_sessions() -> int:
    """``EDL_TPU_KV_SESSIONS``: pinned session chains a replica keeps (LRU
    unpin beyond)."""
    return int(_env_float("EDL_TPU_KV_SESSIONS", 64))


def serving_advert_period() -> float:
    """``EDL_TPU_SERVING_ADVERT_PERIOD``: seconds between a replica's
    refreshes of its leased advert (live engine stats)."""
    return _env_float("EDL_TPU_SERVING_ADVERT_PERIOD", 1.0)


def gateway_poll_period() -> float:
    """``EDL_TPU_GATEWAY_POLL_PERIOD``: the gateway's fleet-view refresh
    period (s); a routing failure also refreshes at once."""
    return _env_float("EDL_TPU_GATEWAY_POLL_PERIOD", 0.25)


def gateway_quarantine() -> float:
    """``EDL_TPU_GATEWAY_QUARANTINE``: seconds a replica stays out of
    routing after a transport failure (its advert may outlive it by a TTL)."""
    return _env_float("EDL_TPU_GATEWAY_QUARANTINE", 5.0)


def serving_result_ttl() -> float:
    """``EDL_TPU_SERVING_RESULT_TTL``: seconds a replica keeps a finished
    generation nobody released (a gateway died mid-fetch)."""
    return _env_float("EDL_TPU_SERVING_RESULT_TTL", 600.0)


def chunk_bytes() -> int:
    """``EDL_TPU_MEMSTATE_CHUNK_BYTES``: the chunk size of a chunked byte
    transfer (``rpc/chunks.py``)."""
    return int(_env_float("EDL_TPU_MEMSTATE_CHUNK_BYTES", 4 << 20))


def distill_advert_period() -> float:
    """``EDL_TPU_DISTILL_ADVERT_PERIOD``: seconds between a teacher's
    refreshes of its advert (the live ``stats()`` payload)."""
    return _env_float("EDL_TPU_DISTILL_ADVERT_PERIOD", 1.0)


def distill_backlog_period() -> float:
    """``EDL_TPU_DISTILL_BACKLOG_PERIOD``: seconds between a student feed's
    publications of its backlog record."""
    return _env_float("EDL_TPU_DISTILL_BACKLOG_PERIOD", 2.0)


def transfer_conns() -> int:
    """``EDL_TPU_TRANSFER_CONNS``: connections an ``RpcChannelPool`` holds."""
    return int(_env_float("EDL_TPU_TRANSFER_CONNS", 4))


def transfer_window() -> int:
    """``EDL_TPU_TRANSFER_WINDOW``: requests a pipelined call keeps in flight."""
    return int(_env_float("EDL_TPU_TRANSFER_WINDOW", 8))


# -- the data service (data/) ---------------------------------------------------
def data_journal() -> bool:
    """``EDL_TPU_DATA_JOURNAL``: a hosted data service journals its
    generations into the coordination store (write-ahead), so a successor
    rebuilds them and readers reattach without restarting the epoch (on
    unless 0; off, live readers re-seed a successor from their own
    checkpoints)."""
    return bool(int(_env_float("EDL_TPU_DATA_JOURNAL", 1)))


def data_journal_budget() -> float:
    """``EDL_TPU_DATA_JOURNAL_BUDGET``: seconds a journal write may take
    before it raises the retryable ``EdlCoordError`` to the reader."""
    return _env_float("EDL_TPU_DATA_JOURNAL_BUDGET", 5.0)


def data_retry_deadline() -> float:
    """``EDL_TPU_DATA_RETRY_DEADLINE``: a data-plane leader call's total
    retry budget (s), backoff, leader re-resolution and reattach inside it."""
    return _env_float("EDL_TPU_DATA_RETRY_DEADLINE", 30.0)


def data_backoff_init() -> float:
    """``EDL_TPU_DATA_BACKOFF_INIT``: its first backoff (s)."""
    return _env_float("EDL_TPU_DATA_BACKOFF_INIT", 0.05)


def data_backoff_max() -> float:
    """``EDL_TPU_DATA_BACKOFF_MAX``: its largest backoff (s)."""
    return _env_float("EDL_TPU_DATA_BACKOFF_MAX", 2.0)


def data_rebuild_grace() -> float:
    """``EDL_TPU_DATA_REBUILD_GRACE``: after a generation is rebuilt (or
    re-seeded by a reattach), the seconds during which parked metas and new
    file grants are held for reattaching readers."""
    return _env_float("EDL_TPU_DATA_REBUILD_GRACE", 5.0)


def data_prefetch_workers() -> int:
    """``EDL_TPU_DATA_PREFETCH_WORKERS``: fetch threads a consumer runs, so
    one dead producer costs them one timeout in parallel, not N in series."""
    return int(_env_float("EDL_TPU_DATA_PREFETCH_WORKERS", 2))


def data_prefetch_depth() -> int:
    """``EDL_TPU_DATA_PREFETCH_DEPTH``: batches fetched or in flight ahead of
    the consumer loop (new metas are asked for only below it)."""
    return int(_env_float("EDL_TPU_DATA_PREFETCH_DEPTH", 16))


def data_prefetch_meta() -> int:
    """``EDL_TPU_DATA_PREFETCH_META``: batch metas asked for per leader round
    trip."""
    return int(_env_float("EDL_TPU_DATA_PREFETCH_META", 4))


def data_prefetch_stream() -> bool:
    """``EDL_TPU_DATA_PREFETCH_STREAM``: 1 fetches a producer's batches as
    one framed stream, 0 forces one request a batch everywhere."""
    return bool(int(_env_float("EDL_TPU_DATA_PREFETCH_STREAM", 1)))


def data_stream_batch() -> int:
    """``EDL_TPU_DATA_STREAM_BATCH``: batches one ``get_batch_stream``
    request carries at most."""
    return int(_env_float("EDL_TPU_DATA_STREAM_BATCH", 8))


def data_produce_meta_batch() -> int:
    """``EDL_TPU_DATA_PRODUCE_META_BATCH``: produced batches a
    ``report_batch_meta`` call carries at most."""
    return int(_env_float("EDL_TPU_DATA_PRODUCE_META_BATCH", 8))
