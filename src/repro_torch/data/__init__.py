"""Deterministic synthetic data pipelines (``pipeline``)."""
