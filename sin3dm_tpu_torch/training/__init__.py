"""Trainers (inference subsets in this slice)."""
