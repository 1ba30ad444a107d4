"""Wide&Deep CTR model with embedding tables cut over ``ep``: the port of
the JAX package's ``models/wide_deep.py`` (reference example/ctr/ctr/
train.py:288, tables on parameter servers).

Every sparse slot ``i`` has a deep table ``embed_i`` ``[vocab, embed_dim]``
and a wide table ``wide_i`` ``[vocab, 1]``; the wide logits are summed in
the compute dtype, the MLP (``fc{k}``, ReLU) runs on ``concat(dense,
embeddings)``, then ``deep_head``; the result is ``(wide + deep)`` in f32,
``[B]``.

The flax numerics kept: tables and kernels are f32 and compute in ``dtype``
(bf16 by default): ``nn.Embed(dtype=...)`` casts the table before the take
(a take commutes with the cast, so the rows are looked up, then cast),
``nn.Dense`` its kernel and bias.  Init as
flax's defaults: tables a normal of variance 1 / features (so a wide table's
rows are N(0, 1)), kernels ``lecun_normal``, zero biases.

The tables are ordinary parameters with the logical axes of
:data:`LOGICAL_RULES` ("table" first), which the port's default rules map
to ``ep`` (``parallel/sharding.py``).  Placed on a mesh with ``ep > 1``
(``shard_init``, which calls :meth:`WideDeep.set_ep`), each rank holds
``vocab / ep`` rows of every table and a lookup is the vocab-parallel one of
the LM's embedding (``models/transformer.py:embed_tokens``): this rank's rows
looked up, the others zero, then all-reduced over ``ep`` (one nonzero term
per id: exact).  JAX gets the same from XLA's inserted collectives.  The ep
ranks read the same rows of the batch (the batch is split over dp x fsdp
only), so each rank's table gradient is the whole gradient of its rows and
the trainer averages nothing over ``ep``.  Checkpoints hold the global
tables (``TrainState.full_state_dict``), so a save at ep 2 resumes at ep 1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.layers import embed_init_
from edl_tpu_torch.models.resnet import Dense
from edl_tpu_torch.models.transformer import embed_tokens

# parameter-name regex -> logical axes (torch names; a table is [vocab, ...])
LOGICAL_RULES = [
    (r"^embed_\d+\.weight$", ("table", "embed")),
    (r"^wide_\d+\.weight$", ("table", None)),
]


class WideDeep(nn.Module):
    """``forward(dense [B, dense_features] float, sparse [B, n_slots] int)
    -> f32 logits [B]``."""

    def __init__(self, vocab_sizes: Sequence[int], dense_features: int = 13,
                 embed_dim: int = 16, hidden: Sequence[int] = (400, 400, 400),
                 dtype: torch.dtype = torch.bfloat16, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.vocab_sizes, self.dtype = tuple(vocab_sizes), dtype
        self.ep = None
        for i, vocab in enumerate(self.vocab_sizes):
            for name, width in ((f"embed_{i}", embed_dim), (f"wide_{i}", 1)):
                table = nn.Embedding(vocab, width, _weight=torch.empty(vocab, width))
                embed_init_(table.weight, g)
                setattr(self, name, table)
        cin = dense_features + embed_dim * len(self.vocab_sizes)
        for k, h in enumerate(hidden):
            setattr(self, f"fc{k}", Dense(cin, h, g))
            cin = h
        self.n_hidden = len(hidden)
        self.deep_head = Dense(cin, 1, g)

    def set_ep(self, ep, shards=None) -> None:
        """Look up in this rank's rows of every table (the tables already
        cut by ``shard_init``)."""
        for vocab in self.vocab_sizes:
            if vocab % ep.size:
                raise ValueError(f"a vocab of {vocab} does not divide over ep = {ep.size}")
        self.ep = ep

    def forward(self, dense, sparse):
        deep = [dense.to(self.dtype)]
        wide = torch.zeros(dense.shape[0], 1, dtype=self.dtype, device=dense.device)
        for i in range(len(self.vocab_sizes)):
            ids = sparse[:, i]
            deep.append(embed_tokens(ids, getattr(self, f"embed_{i}").weight, self.ep, self.dtype))
            wide = wide + embed_tokens(ids, getattr(self, f"wide_{i}").weight, self.ep, self.dtype)
        x = torch.cat(deep, dim=-1)
        for k in range(self.n_hidden):
            x = F.relu(getattr(self, f"fc{k}")(x))
        return (wide + self.deep_head(x)).float().squeeze(-1)
