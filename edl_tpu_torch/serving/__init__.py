"""LM serving: slot-based continuous batching over one KV cache (engine.py)."""

from edl_tpu_torch.serving.engine import ContinuousBatcher

__all__ = ["ContinuousBatcher"]
