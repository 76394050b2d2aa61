"""End-to-end cohort imputation walkthrough on the port.

The port's counterpart of ``examples/impute_cohort.py``: simulates an F2
cross (swap in ``io.load_plantimpute`` / the other readers for real
data), hides a fraction of genotypes, runs the full inference loop,
scores the recovery, and writes the three output artifacts:
genotype-probability table, phased haplotype dump (the checkpoint
format), and founder line-origin posteriors.

    python -m cnf2freq_tpu_torch.examples.impute_cohort [--f2 40]
        [--markers 30] [--iters 8] [--device cuda|cpu]

The Driver runs on the card unless ``--device cpu`` is given; without a
card ``--device cuda`` raises the Driver's error before anything is
written.  Recovery is scored at ``score_recovery``'s strict threshold
(markersure below 0.2), and the exit code is 0 only when more than 90% of
the called sites are right; at these defaults held-out markersure settles
near 0.2-0.35 (``utils.harness.run_experiment``), so few or no sites are
called and the run exits 1, as the JAX package's example does.
"""

import argparse
import sys
from typing import Dict, Tuple

import numpy as np


def impute_cohort(f2: int = 40, markers: int = 30, iters: int = 8,
                  mask_every: int = 7, out_prefix: str = "/tmp/impute_demo",
                  device: str = "cuda", dtype=np.float32
                  ) -> Tuple[Dict[str, float], Dict[str, str], object]:
    """Simulate, mask, run ``iters`` iterations (the first early), score
    and write the three files.  Returns (the recovery score, {kind: path}
    of the files written, the Driver)."""
    from ..driver import Driver
    from ..io import outputs
    from ..utils import harness, simulate

    ped = simulate.simulate_f2(n_f2=f2, n_markers=markers,
                               missing_rate=0.05, error_rate=0.01, seed=42)
    held_out = harness.mask_markers(ped, every=mask_every)
    print(f"{len(ped.dous)} analysis individuals, "
          f"{ped.num_markers} markers, "
          f"{len(held_out.masked)} genotypes hidden", file=sys.stderr)

    drv = Driver(ped, dtype=dtype, device=device)
    drv.preprocess()
    for i in range(iters):
        info = drv.iterate(early=(i == 0))
        print(f"iter {i}: {info}", file=sys.stderr)

    score = harness.score_recovery(ped, held_out)
    print(f"recovery: {score}", file=sys.stderr)

    paths = {k: f"{out_prefix}.{k}"
             for k in ("genotypes", "dump", "lineorigin")}
    with open(paths["genotypes"], "w") as f:
        outputs.write_genotype_table(ped, drv.pair_tables, f)
    with open(paths["dump"], "w") as f:
        outputs.write_haplotype_dump(ped, f, reset_negshift=False)
    with open(paths["lineorigin"], "w") as f:
        outputs.write_line_origin_table(ped, drv.line_origin_tables(), f)
    print(f"wrote {out_prefix}.genotypes/.dump/.lineorigin",
          file=sys.stderr)
    return score, paths, drv


def exit_code(score: Dict[str, float]) -> int:
    """The example's exit rule: 0 when the called sites' accuracy is
    above 0.9."""
    return 0 if score["accuracy"] > 0.9 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f2", type=int, default=40)
    ap.add_argument("--markers", type=int, default=30)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--mask-every", type=int, default=7)
    ap.add_argument("--out-prefix", default="/tmp/impute_demo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    score, _, _ = impute_cohort(args.f2, args.markers, args.iters,
                                args.mask_every, args.out_prefix,
                                args.device)
    return exit_code(score)


if __name__ == "__main__":
    raise SystemExit(main())
