"""Analytic FLOP counts, inference casts and weight-only int8 quantization."""
