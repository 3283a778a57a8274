"""Device ops: the stem kernel, heatmap decode, association."""
