"""Carrying params across from the JAX package."""
