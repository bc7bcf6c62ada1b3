"""Runnable examples of the port, each `python -m repro_torch.examples.<name>`
(on the CUDA card unless `--device cpu` is given): quickstart,
multiclass_quickstart, protocol_matrix, train_lm, secure_agg_lm."""
