"""Evaluation: rank metrics and the item latent cache."""
