"""Observability: FLOP accounting for MFU."""
