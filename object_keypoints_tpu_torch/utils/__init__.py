"""Host utilities: visualization, metrics, event files, detector configs, timers."""
