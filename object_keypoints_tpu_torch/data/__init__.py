"""Data layer: sequence reading, target rendering, augmentation, writers."""
