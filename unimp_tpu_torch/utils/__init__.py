"""Analytic FLOP counts and the card's peak rate."""
