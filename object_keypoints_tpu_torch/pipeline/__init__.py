"""Batched decoding (depth head and stereo) and the host components."""
