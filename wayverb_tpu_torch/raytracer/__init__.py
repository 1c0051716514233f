"""Stochastic ray tracer: bounce loop, histograms, late-field synthesis."""
