"""Utilities: device resolution, JSON serialization, errors and constants."""
