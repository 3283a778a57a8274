"""Network modules: blocks, fire hourglass, KeypointNet."""
