"""Training: state and optimizers, the train step, the epoch loop and
checkpoints."""
