"""Field arithmetic, randomness and the COPML protocol on torch tensors."""
