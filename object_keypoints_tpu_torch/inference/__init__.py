"""Detection inference: single-pass CornerNet inference and its Detector facade, and
CornerNet-Saccade's two-stage inference and its SaccadeDetector facade."""
