"""Train state, the bucketed EF step and the training loop."""
