"""Cluster model copies: the resume ``State`` sidecar, the trainer env
contract, and the train-status and heartbeat records the launcher reads."""
