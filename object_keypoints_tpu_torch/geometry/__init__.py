"""Camera geometry, SE3 helpers and stereo triangulation."""
