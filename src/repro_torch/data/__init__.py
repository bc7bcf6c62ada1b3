"""Synthetic dataset builders (numpy)."""
