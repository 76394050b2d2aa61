"""The port's Driver with ``flip_mode="negshift"`` and ``parent_swap``
against the JAX package's, as tests/test_torch_negshift.py does without
parent-pair swaps (a file of its own, so that the two JAX Driver runs
compile on two test workers).  In this cohort no swap hypothesis scores
(its F1 parents are untyped), so the swap stage runs and moves nothing;
the function-level test in tests/test_torch_negshift.py makes moves.
"""
from torch_port_util import check_negshift_run


def test_driver_negshift_parentswap_matches_jax(record_property):
    check_negshift_run(True, record_property)
