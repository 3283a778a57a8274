"""Detection inference: single-pass CornerNet inference and its Detector facade."""
