"""Serving artifacts, inference functions and the JAX weight bridge."""
