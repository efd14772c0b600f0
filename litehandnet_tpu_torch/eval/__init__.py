"""Evaluation-side decode (result dicts)."""
