"""Training: train state, checkpoints and the single-process ElasticTrainer."""
