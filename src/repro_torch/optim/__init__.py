"""Optimizers over the port's nested dicts of tensors."""
