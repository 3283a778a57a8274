"""Device ops: the stem kernel, heatmap decode, association, corner pools,
corner decode, the NMS family."""
