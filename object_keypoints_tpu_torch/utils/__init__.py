"""Host utilities: visualization, metrics, event files, detection configs."""
