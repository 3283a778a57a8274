"""Batched object decoding."""
