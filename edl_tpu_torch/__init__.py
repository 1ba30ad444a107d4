"""PyTorch and CUDA port of the elastic training system, for NVIDIA Hopper.

The JAX package ``edl_tpu`` is the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of what it needs.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""
