"""Evaluation metrics: LP-IoU/F, Div, SSFID, SIFID, LPIPS."""
