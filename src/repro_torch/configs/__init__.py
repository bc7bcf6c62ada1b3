"""Paper-scale workload shapes."""
