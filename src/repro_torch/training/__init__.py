"""Training: optimizer, data, checkpoints, the train step and the trainer
(the port of ``repro.training``)."""
