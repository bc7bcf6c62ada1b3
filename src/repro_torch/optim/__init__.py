"""Optimizers for the LM stack (AdamW, SGD-momentum, factored Adafactor)."""
