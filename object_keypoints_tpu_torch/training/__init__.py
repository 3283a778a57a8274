"""Training: the keypoint loss, AdamW with reduce-on-plateau, the train and
eval steps, and the device data store."""
