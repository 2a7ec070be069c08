"""Diffusion schedule, sampling math and sampling loops."""
