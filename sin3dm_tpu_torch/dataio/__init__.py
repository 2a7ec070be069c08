"""Mesh -> training-data samplers."""
