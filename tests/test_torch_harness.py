"""The port's copy of ``utils/harness.py`` (the mask-impute-compare
experiment) against the JAX package's.

* ``mask_markers`` blanks the same (individual, marker) entries, priors
  included, and keeps the same truth as the JAX function on the same
  cohort (``simulate_f2(n_f2=8, n_markers=24, missing_rate=0, error_rate=0,
  seed=3)``, every 5th marker from 2); ``score_recovery`` gives the same
  scores on the same imputed state (seeded imputed calls and sures).
* ``run_experiment(device="cpu")`` on tests/test_harness.py's 8 x 24
  cohort (every 8th marker, four iterations) meets that test's bounds:
  at least 8 held-out sites, majority-confidence call rate above 0.9 and
  accuracy above 0.85.
"""
import numpy as np
import torch
import torch_port_util  # noqa: F401  (one torch thread a worker)

from cnf2freq_tpu.utils import harness as jax_harness
from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate
from cnf2freq_tpu_torch.utils import (mask_markers, run_experiment,
                                      score_recovery, simulate_f2)


def test_mask_and_score_match_jax():
    peds = {"jax": jax_simulate(n_f2=8, n_markers=24, missing_rate=0.0,
                                error_rate=0.0, seed=3),
            "port": simulate_f2(n_f2=8, n_markers=24, missing_rate=0.0,
                                error_rate=0.0, seed=3)}
    fns = {"jax": (jax_harness.mask_markers, jax_harness.score_recovery),
           "port": (mask_markers, score_recovery)}
    res, scores = {}, {}
    for k, ped in peds.items():
        res[k] = fns[k][0](ped, every=5, phase=2)
        # a seeded imputed state: some calls right, some wrong, some unsure
        rng = np.random.default_rng(8)
        for (n, m), (a, b) in res[k].truth.items():
            ind = ped.by_id(n)
            ind.markerdata[m] = (a, b) if rng.random() < 0.7 else (3 - a, b)
            ind.markersure[m] = rng.uniform(0.0, 0.4, 2)
        scores[k] = [fns[k][1](ped, res[k], sure_threshold=t)
                     for t in (0.2, 0.5)]
    assert res["port"].masked == res["jax"].masked
    assert res["port"].truth == res["jax"].truth
    assert len(res["port"].masked) == 8 * 5
    for a, b in zip(peds["port"].inds[1:], peds["jax"].inds[1:]):
        for f in ("markerdata", "markersure", "priormarkerdata",
                  "priormarkersure"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert scores["port"] == scores["jax"]
    assert 0 < scores["port"][0]["called"] < scores["port"][1]["called"]
    assert 0 < scores["port"][1]["accuracy"] < 1


def test_run_experiment_recovers_masked_markers():
    ped = simulate_f2(n_f2=8, n_markers=24, marker_spacing_cm=2.0,
                      missing_rate=0.0, error_rate=0.0, seed=3)
    out = run_experiment(ped, every=8, iterations=4, dtype=torch.float64,
                         device="cpu")
    assert out["total"] >= 8
    assert out["majority_call_rate"] > 0.9, out
    assert out["majority_accuracy"] > 0.85, out
    assert out["iterations"] == 4
