"""Training data: the JAX package's slice dataset with the port's resize."""
