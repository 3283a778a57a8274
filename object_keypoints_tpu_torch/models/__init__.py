"""Network modules: blocks, fire and residual hourglasses, KeypointNet, the CornerNet detectors."""
