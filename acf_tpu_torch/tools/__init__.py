"""Measurement scripts of the port, run on the GPU machine (``python -m``)."""
