"""Secure serving: score queries against a secret-shared model."""
