"""LM generation service: KV-cache decoding behind the teacher wire (the
port of ``examples/lm/serve_lm.py``).

    python -m edl_tpu_torch.serve_lm --layers 12 --embed 768 --heads 6 \\
        --mlp 3072 --vocab 32000 --max_len 1024 --continuous 16

Clients send ``feed={"ids": [B, P] int32}`` and fetch ``["tokens"]`` ->
``[B, max_new_tokens]`` continuations, over the EDL1 wire (any
``TeacherClient``, the JAX package's too, or :func:`request`).  Every
prompt in a request must be P tokens long: do not right-pad shorter ones
(the model would condition on the pads); send ragged prompts as separate
requests.  Batch-at-a-time by default (a ``TeacherServer`` coalescing
same-shape requests into one :func:`generate`); with ``--continuous
SLOTS`` a :class:`ContinuousBatcher` whose running decode batch requests
join and leave at token granularity, prompts over
``EDL_TPU_PREFILL_CHUNK`` tokens prefilled in chunks.

Same flags as the JAX example minus ``--tp`` and ``--moe*``, plus
``--device`` (default ``cuda``: without a card it raises ``NoCardError``
unless given ``--device cpu``).  Compute is bf16 on the card and f32 on
the CPU, as ``train_lm``'s.  ``--checkpoint_dir`` restores the newest
checkpoint that ``edl_tpu_torch.train_lm`` wrote there and keeps its
parameters; without it the weights are random from seed 0 (a wiring
demo).  The first line of the output is ``[serve_lm] serving on
<host:port> ...``; SIGTERM or SIGINT stops the server.
"""

from __future__ import annotations

import argparse
import signal
import threading

import numpy as np
import torch


def request(endpoint: str, prompts: np.ndarray, timeout: float = 120.0) -> np.ndarray:
    """One-shot client: ``[B, P]`` int32 prompts -> generated tokens."""
    from edl_tpu_torch.distill.predict_client import TeacherClient

    client = TeacherClient(endpoint, fetch=["tokens"], timeout=timeout)
    try:
        return client.predict({"ids": prompts.astype(np.int32)})["tokens"]
    finally:
        client.close()


def build_predict_fn(model, max_new_tokens: int, temperature: float, top_k: int,
                     top_p: float = 0.0):
    """``predict(feed) -> {"tokens": [B, new]}``: one :func:`generate` of
    the batch on the model's device, from a fresh generator per call, so
    temperature sampling differs between identical requests.  The decode
    copy of the model is built once here."""
    from edl_tpu_torch.models.generate import generate
    from edl_tpu_torch.models.transformer import decode_model

    dmodel = decode_model(model)
    device = dmodel.tok_embed.weight.device
    counter = {"n": 0}
    lock = threading.Lock()

    def predict(feed: dict) -> dict:
        with lock:
            counter["n"] += 1
            n = counter["n"]
        gen = torch.Generator(device=device).manual_seed(20_26 * 1_000_003 + n)
        toks = generate(dmodel, torch.from_numpy(np.asarray(feed["ids"], np.int32)),
                        max_new_tokens, generator=gen, temperature=temperature, top_k=top_k,
                        top_p=top_p)
        return {"tokens": toks.cpu().numpy()}

    return predict


class _ContinuousServer:
    """A TeacherClient-compatible RPC front over a ContinuousBatcher.  No
    inference thread to queue behind: every request, on its own RPC
    thread, submits its rows to the engine and waits on their futures,
    and the engine batches whatever is in flight."""

    def __init__(self, engine, max_new_tokens: int, port: int = 0, host: str | None = None):
        from edl_tpu_torch.distill.predict_client import decode_array, encode_array
        from edl_tpu_torch.rpc.server import RpcServer
        from edl_tpu_torch.utils.network import local_ip

        self._engine = engine
        self._max_new = max_new_tokens

        def predict(feed: dict, fetch: list[str]) -> dict:
            ids = decode_array(feed["ids"])
            if len(ids) == 0:
                return {"out": {"tokens": encode_array(np.zeros((0, 0), np.int32))}}
            outs = [f.result() for f in [engine.submit(row, self._max_new) for row in ids]]
            toks = np.full((len(outs), max(len(o) for o in outs)), -1, np.int32)
            for i, o in enumerate(outs):       # ragged under eos: -1 pad
                toks[i, :len(o)] = o
            return {"out": {"tokens": encode_array(toks)}}

        self._rpc = RpcServer(host="0.0.0.0", port=port)
        self._rpc.register("predict", predict)
        self._rpc.register("ping", lambda: {"pong": True})
        self._rpc.register("stats", engine.stats)
        self._rpc.start()
        self._host = host
        self.endpoint = f"{host or local_ip()}:{self._rpc.port}"
        self._register = None

    def register(self, store, service: str) -> "_ContinuousServer":
        """Advertise under the service; without a ``host``, at the interface
        that routes to the store."""
        from edl_tpu_torch.coord.register import Register
        from edl_tpu_torch.distill.balance import server_key
        from edl_tpu_torch.utils.network import local_ip

        if self._host is None:
            self.endpoint = f"{local_ip(getattr(store, 'endpoint', None))}:{self._rpc.port}"
        self._register = Register(store, server_key(service, self.endpoint),
                                  self.endpoint.encode())
        return self

    def stop(self) -> None:
        if self._register is not None:
            self._register.stop()
        self._rpc.stop()
        self._engine.stop()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LM generation service")
    p.add_argument("--coord_endpoints", default="", help="register under --service when set")
    p.add_argument("--service", default="lm")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--checkpoint_dir", default="",
                   help="restore train_lm's parameters (else random init — demo)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embed", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv_heads", type=int, default=0, help="must match training (GQA)")
    p.add_argument("--mlp", type=int, default=256)
    p.add_argument("--max_len", type=int, default=512)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling mass in (0, 1]; 0 disables")
    p.add_argument("--continuous", type=int, default=0, metavar="SLOTS",
                   help="serve with slot-based continuous batching over this many decode "
                        "lanes; 0 = batch-at-a-time TeacherServer")
    p.add_argument("--eos_id", type=int, default=-1,
                   help="stop generation at this token (continuous mode); -1 disables")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_model(args, device: torch.device):
    """The served model on ``device``: the checkpoint's parameters when
    ``--checkpoint_dir`` is given, else random from seed 0."""
    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=args.vocab, num_layers=args.layers,
                            embed_dim=args.embed, num_heads=args.heads,
                            num_kv_heads=args.kv_heads, mlp_dim=args.mlp,
                            max_len=args.max_len, remat=False,
                            dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    model = TransformerLM(cfg, torch.Generator().manual_seed(0)).to(device)
    if args.checkpoint_dir:
        # train_lm's checkpoint holds the whole TrainState: restore it into
        # a state of the same structure (AdamW; its hyperparameters do not
        # shape the state), then keep the module
        from edl_tpu_torch.train.checkpoint import CheckpointManager
        from edl_tpu_torch.train.state import TrainState, adamw

        restored = CheckpointManager(args.checkpoint_dir).restore(
            TrainState.create(model, adamw(1e-3)))
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        model = restored[0].model
    return model.requires_grad_(False).eval()


def serve(args):
    """Start the server ``args`` describe; returns it (``.endpoint``,
    ``.stop()``)."""
    from edl_tpu_torch.distill.teacher import TeacherServer
    from edl_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = build_model(args, device)
    if args.continuous:
        from edl_tpu_torch.serving import ContinuousBatcher

        engine = ContinuousBatcher(model, slots=args.continuous,
                                   temperature=args.temperature, top_k=args.top_k,
                                   top_p=args.top_p,
                                   eos_id=None if args.eos_id < 0 else args.eos_id)
        server = _ContinuousServer(engine, args.max_new_tokens, port=args.port)
    else:
        server = TeacherServer(build_predict_fn(model, args.max_new_tokens, args.temperature,
                                                args.top_k, args.top_p),
                               port=args.port, device=device)
    if args.coord_endpoints:
        from edl_tpu_torch.coord.client import connect

        server.register(connect(args.coord_endpoints), args.service)
    return server


def main(argv=None) -> None:
    args = parse_args(argv)
    server = serve(args)
    print(f"[serve_lm] serving on {server.endpoint} (max_new_tokens={args.max_new_tokens}, "
          f"continuous={args.continuous}, device={args.device})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
