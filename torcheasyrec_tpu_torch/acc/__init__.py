"""Serving acceleration: embedding quantization."""
