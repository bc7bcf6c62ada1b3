"""repro_torch's MpcBaseline vs the JAX package's at the wider registry
workloads, on the CPU: cifar10_like (N=15, T=2, d=96, a held-out split)
on both schemes and mnist10_like's (d, 10) model.  A file of its own so
the JAX package's per-shape compilation runs beside test_torch_baselines.py.
"""

import pytest

from test_torch_baselines import check_fit_matches_jax, check_setup_and_steps


@pytest.mark.parametrize("name,scheme", [
    ("cifar10_like", "bh08"), ("cifar10_like", "bgw"),
    ("mnist10_like", "bh08")])
def test_setup_and_steps_match_jax(name, scheme):
    check_setup_and_steps(name, scheme)


def test_fit_matches_jax_matrix_model():
    check_fit_matches_jax("mnist10_like")
