"""Host utilities: visualization."""
