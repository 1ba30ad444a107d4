"""Training: train state, checkpoints, LR schedules, the process group and
the elastic data-parallel ElasticTrainer."""
