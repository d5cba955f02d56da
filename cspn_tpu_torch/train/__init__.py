"""Eval runtime: losses, metrics, the evaluation driver."""
