"""Camera geometry."""
