"""Data on the device: CLIP normalization and answer-span labels."""
