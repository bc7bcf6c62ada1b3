"""Training: the LM trainer (checkpoint/restart, secure aggregation),
checkpoints, elastic re-meshing, straggler budgets and fault-plan
validation."""
