"""Training: losses and the weights-only NeRF train step."""
