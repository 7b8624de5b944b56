"""Serving engine of the port: static-batch prefill + greedy decode."""
