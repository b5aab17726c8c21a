"""Synthetic scenes for the port's smoke run and tests (numpy, no JAX)."""
