"""Utilities: the JAX-variables to torch state_dict bridge."""
