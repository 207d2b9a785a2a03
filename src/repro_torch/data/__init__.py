"""Synthetic training data (numpy)."""
