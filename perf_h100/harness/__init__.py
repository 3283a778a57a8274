"""perf_h100's harness."""
