"""PyTorch/CUDA port of the COPML reproduction (see README, "The PyTorch port")."""
