"""Two runs' haplotype dumps compared where a collapse tie may part them:
the port's CLI against the JAX CLI on the CPU, or the card against the
CPU.  Host-side; the CPU tests and ``chip_smoke.py`` use the one copy.

The emission's phase factor collapses for a homozygous member whose two
markersure values are exactly equal (``hmm.emission._collapse``, the
reference's rule).  Two runs that compute the update in different orders
(two packages, or two devices) can come out on the two sides of that
equality at a homozygous marker.  The unit's adjacent-phase coherence
over the intervals that touch the marker then differs, and with it the
relhaplo there and the haploweights that the relskew term pulls along the
chromosome.  A dump block (individual, iteration) may depart from the
other run's by more than the tolerance only so:

* in the haploweight and relhaplo columns alone (``DEPARTING_COLUMNS``);
* where a member of the block's unit had other collapse flags in the two
  runs as that iteration started (``recording_collapse`` records them);
* its relhaplo only at a marker m whose interval (m, m + 1) touches a
  marker at which such a member's flags differ;
* its haploweights by at most ``HAPLOWEIGHT_SLACK``.

The caller bounds the number of departed blocks of a set.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import numpy as np

# dump columns: haploweight, markerdata x 2, negshift, markersure x 2,
# relhaplo, then the priors
HAPLOWEIGHT, RELHAPLO = 0, 6
DEPARTING_COLUMNS = (HAPLOWEIGHT, RELHAPLO)
# the largest haploweight departure a collapse tie may cause (the tie
# moves the relskew pull, not the step cap); the readings were 0.012 (the
# port against the JAX CLI on the CPU) and 0.0085 (an NVIDIA H100 against
# the CPU)
HAPLOWEIGHT_SLACK = 0.05


def dump_blocks(path):
    """[(individual line, rows [M, columns])] of a dump, in order."""
    blocks = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                blocks.append((line.strip(), []))
            else:
                blocks[-1][1].append([float(x) for x in parts])
    return [(head, np.array(rows)) for head, rows in blocks]


def collapse_flags(ped):
    """{id: [M] bool}: where the emission's phase factor collapses for the
    individual (homozygous, its two markersure values equal)."""
    return {i.n: (i.markerdata[:, 0] == i.markerdata[:, 1]) &
            (i.markersure[:, 0] == i.markersure[:, 1]) for i in ped.inds[1:]}


@contextlib.contextmanager
def recording_collapse(cls, seen: list):
    """Within the block, ``cls.iterate`` appends (the pedigree's
    family_slots, its collapse flags) to ``seen`` as each iteration
    starts."""
    real = cls.iterate

    def iterate(self, *a, **kw):
        seen.append((self.ped.family_slots, collapse_flags(self.ped)))
        return real(self, *a, **kw)
    cls.iterate = iterate
    try:
        yield seen
    finally:
        cls.iterate = real


class Departure(NamedTuple):
    iteration: int
    block: str            # the dump's individual line
    haploweight: float    # the largest departure in each column
    relhaplo: float
    fault: Optional[str]  # the rule broken, None if the tie explains it


def compare_dumps(path_a, path_b, seen_a, seen_b, iterations: int,
                  atol: float):
    """(the largest difference over the blocks within ``atol``, the
    departed blocks [Departure]).  Raises ValueError if the two dumps hold
    other blocks."""
    ba, bb = dump_blocks(path_a), dump_blocks(path_b)
    if [h for h, _ in ba] != [h for h, _ in bb] or \
            any(x.shape != y.shape for (_, x), (_, y) in zip(ba, bb)):
        raise ValueError(f"{path_a} and {path_b} hold other blocks")
    n_inds = len(ba) // iterations
    worst, departed = 0.0, []
    for i, ((head, x), (_, y)) in enumerate(zip(ba, bb)):
        off = np.abs(x - y)
        if not (off > atol).any():
            worst = max(worst, float(off.max()))
            continue
        it = i // n_inds
        (slots, fa), (_, fb) = seen_a[it], seen_b[it]
        # markers where a member of the unit collapses in one run only
        apart = np.zeros(x.shape[0], dtype=bool)
        for m in slots(int(head.split()[0])):
            if m:
                apart |= fa[m] != fb[m]
        touch = apart | np.append(apart[1:], False)
        cols = set(np.nonzero(off > atol)[1])
        rh_rows = np.nonzero(off[:, RELHAPLO] > atol)[0]
        fault = None
        if not cols <= set(DEPARTING_COLUMNS):
            fault = f"columns {sorted(cols)} depart"
        elif not apart.any():
            fault = "no member's collapse flags differ"
        elif not touch[rh_rows].all():
            fault = (f"relhaplo departs at markers "
                     f"{rh_rows[~touch[rh_rows]].tolist()}, away from the "
                     f"flags that differ")
        elif off[:, HAPLOWEIGHT].max() > HAPLOWEIGHT_SLACK:
            fault = "haploweight departs beyond HAPLOWEIGHT_SLACK"
        departed.append(Departure(it, head, float(off[:, HAPLOWEIGHT].max()),
                                  float(off[:, RELHAPLO].max()), fault))
    return worst, departed


def faults(departed: List[Departure], max_blocks: int) -> List[str]:
    """The broken rules of a set's departures, its block count
    included."""
    out = [f"{d.block} (iteration {d.iteration}): {d.fault}"
           for d in departed if d.fault]
    if len(departed) > max_blocks:
        out.append(f"{len(departed)} departed blocks, more than "
                   f"{max_blocks}")
    return out
