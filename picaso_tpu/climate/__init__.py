"""Radiative-convective equilibrium climate solver in JAX."""
