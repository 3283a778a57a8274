"""perf_h100's reference."""
