"""Training-side utilities: straggler budgets and fault-plan validation."""
