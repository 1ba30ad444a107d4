"""Cluster model copies: the resume ``State`` sidecar, the trainer env
contract, the cluster record the launcher writes (pods, stage, leader), and
the train-status and heartbeat records the launcher reads."""
