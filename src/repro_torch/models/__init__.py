"""The LM stack's serving half: configs, parameter tables, forward passes
for every family (dense, moe, ssm, hybrid, encdec, vlm), decode caches and
the batched greedy/sampled `lm_serving.generate` driver."""
