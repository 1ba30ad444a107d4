"""Models: the decoder-only transformer LM and its weight converter."""
