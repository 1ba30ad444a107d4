"""Cluster model copies: the resume ``State`` sidecar and the trainer env contract."""
