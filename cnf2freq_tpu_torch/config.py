"""Model configuration: the state space of the pedigree inheritance HMM.

The port's own copy of ``cnf2freq_tpu/config.py`` (no JAX, no import of
the JAX package); ``tests/test_torch_host.py`` holds the two together.

The reference (``settings.h:1-105``) selects the pedigree
model at *compile time* via preprocessor constants (``NUMGEN``, ``TYPEBITS``,
``NUMTYPES``, ``NUMPATHS``, ``NUMSHIFTS``, feature switches).  Here the same
quantities are derived at *runtime* from a small dataclass, so one build of
the framework serves every model family (F2 with/without haplotyping,
QTLMAS-style 4-state crosses, selfed lines, deeper AIL crosses).

Derivation rules mirror ``settings.h``:

* ``typebits = 2**numgen - 2``      (settings.h:20)
* ``numtypes = 2**typebits``        (settings.h:27, without selfing/relskew bits)
* ``numpaths = 2**(typebits + 1)``  (settings.h:32)
* ``numshifts = 2**(2**(numgen-1) - 1)`` (settings.h:33-35)
* ``numturns = 2**(typebits + 1)``  (settings.h:40-42)

The hidden state ``g`` of the HMM is a ``typebits``-wide bit vector: one bit
per meiosis in the family tree of a focal individual (parents and, for
``numgen==3``, grandparents), stating which parental strand was transmitted.
``flag2`` ("path") adds one bit per family slot selecting which of the two
alleles in the unordered stored genotype pair is being interpreted as which
strand; ``shift`` globally flips the strand labelling of focal/parents.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

UNKNOWN = 0          # MarkerVal 0 == unknown (cnF2freq.cpp:225)
SEXMARKER = 9        # pseudo-allele for sex chromosomes (cnF2freq.cpp:226)

# trackpossible "update" bit flags (cnF2freq.cpp:792-795)
HAPLOS = 1
GENOS = 2
HOMOZYGOUS = 4
GENOSPROBE = 8

# zeropropagate modes (cnF2freq.cpp:42-43)
ZP_NONE = 0          # bind unknowns to matched values
ZP_PROPAGATE = 1     # keep zeros; everything matches (line-origin tracing)
ZP_NO_EQUIVALENCE = -1  # no binding, no haploweight factors (variance probes)

MINFACTOR = -1e15    # log-domain "impossible" sentinel (settings.h:29)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Runtime equivalent of the reference's compile-time ``settings.h``."""

    numgen: int = 3              # generations in the analysis unit
    haplotyping: bool = True     # phase inference active (settings.h:36)
    selfing: bool = False        # selfed-line extension (settings.h:14)
    relskews: bool = True        # relative-skew smoothing HMM (settings.h:15)
    relskewstates: bool = False  # relskew as extra HMM state bit (settings.h:16)
    do_infprobs: bool = True     # genotype-imputation updates (settings.h:12)
    correction_inference: bool = True  # pedigree-based genotype correction

    # per-meiosis-bit sex of the transmitting parent and generation class,
    # mirroring TYPESEXES / TYPEGENS (settings.h:21-23).  Derived by default.
    typesexes: Tuple[int, ...] = None  # type: ignore[assignment]
    typegens: Tuple[int, ...] = None   # type: ignore[assignment]

    def __post_init__(self):
        if self.typesexes is None:
            object.__setattr__(self, "typesexes", self._default_typesexes())
        if self.typegens is None:
            object.__setattr__(self, "typegens", self._default_typegens())
        assert len(self.typesexes) == self.typebits
        assert len(self.typegens) == self.typebits
        if self.relskewstates and self.selfing:
            raise NotImplementedError(
                "combining SELFING with RELSKEWSTATES is not supported "
                "(the reference's own bit layout for the combination is "
                "marked 'TODO: Reorder bits', settings.h:44-46)")

    # -- state-space dimensions -------------------------------------------
    @property
    def typebits(self) -> int:
        return (1 << self.numgen) - 2

    @property
    def numtypes(self) -> int:
        return 1 << self.typebits

    @property
    def numpaths(self) -> int:
        return 1 << (self.typebits + 1) if self.haplotyping else 2

    @property
    def numshiftgen(self) -> int:
        return self.numgen - 1 if self.haplotyping else 0

    @property
    def numshifts(self) -> int:
        if not self.haplotyping:
            return 1
        return 1 << ((1 << self.numshiftgen) - 1)

    @property
    def turnbits(self) -> int:
        return self.typebits + 1

    @property
    def numturns(self) -> int:
        return 1 << self.turnbits

    # -- selfing extension (settings.h:8,14,25-46) -------------------------
    # Two extra state bits encode HBD ("homozygous by descent") status of
    # the focal individual in selfed lines: selfval 0 = ordinary F2 state,
    # 1 / 2 = the two strands are copies, carried on interpretation slot
    # 0 / 1.  The double-bit value 3 is invalid (VALIDSELFNUMTYPES,
    # settings.h:46), so the state space is numtypes * 3.
    @property
    def selfbits(self) -> int:
        return 2 if self.selfing else 0

    @property
    def numselfstates(self) -> int:
        """Valid selfing values (0..2); 1 when selfing is off."""
        return 3 if self.selfing else 1

    @property
    def numrelstates(self) -> int:
        """RELSKEWSTATES phase-coherence state bit (settings.h:16,26):
        an extra hidden bit pinning the focal's root interpretation."""
        return 2 if self.relskewstates else 1

    @property
    def numstates(self) -> int:
        """Full valid state count including the extensions."""
        return self.numtypes * self.numselfstates * self.numrelstates

    @property
    def evengen(self) -> float:
        # EVENGEN = 1/NUMTYPES where NUMTYPES counts the *padded* space
        # 2**(typebits + selfbits + relskewstates) (settings.h:27-28)
        return 1.0 / ((self.numtypes << self.selfbits) *
                      self.numrelstates)

    # -- family-tree slot layout ------------------------------------------
    # Slots follow the reference's flag2-bit layout (fixtrees,
    # cnF2freq.cpp:3099-3187): slot 0 is the focal individual; for each
    # parent k the slot block starts at 1 + k*(2**(numgen-1)-1) with the
    # parent first and its ancestors after.  For numgen==3:
    #   0=focal, 1=par0, 2=gp00, 3=gp01, 4=par1, 5=gp10, 6=gp11
    @property
    def deep_walk(self) -> bool:
        """No-haplotyping builds walk one pedigree level deeper than
        their state space: ``attopnow = (genwidth == HAPLOTYPING)``
        stops at genwidth 0, past the parents into the grandparents
        (cnF2freq.cpp:1120, 1075-1120) — so a numgen==2 no-haplotyping
        unit still spans 7 family slots."""
        return self.numgen == 2 and not self.haplotyping

    @property
    def numslots(self) -> int:
        return 7 if self.deep_walk else (1 << self.numgen) - 1

    @property
    def parent_slot_span(self) -> int:
        """Slots occupied by one parent's branch (parent + its ancestors)."""
        return 3 if self.deep_walk else (1 << (self.numgen - 1)) - 1

    def parent_slot(self, k: int) -> int:
        return 1 + k * self.parent_slot_span

    def grandparent_slot(self, k: int, j: int) -> int:
        assert self.numgen == 3 or self.deep_walk
        return self.parent_slot(k) + 1 + j

    @cached_property
    def slot_parent_index(self) -> Tuple[int, ...]:
        """For each slot, the slot of the individual's child-in-tree (or -1)."""
        out = [-1] * self.numslots
        for k in range(2):
            p = self.parent_slot(k)
            out[p] = 0
            if self.numgen == 3 or self.deep_walk:
                out[p + 1] = p
                out[p + 2] = p
        return tuple(out)

    # -- per-slot bit positions -------------------------------------------
    # State bits consumed by parent k's branch: [k*span2 .. (k+1)*span2)
    # where span2 = typebits/2; within the branch, bit 0 = which grandparent
    # fed the transmitted strand, bits 1.. = grandparent meiosis bits.
    @property
    def state_branch_bits(self) -> int:
        return self.typebits // 2

    def state_bits_of_parent(self, k: int) -> range:
        w = self.state_branch_bits
        return range(k * w, (k + 1) * w)

    def flag2_bits_of_parent(self, k: int) -> range:
        w = self.parent_slot_span
        return range(1 + k * w, 1 + (k + 1) * w)

    # shift bits: 0 = focal, 1 = parent0, 2 = parent1 (numgen==3 only;
    # grandparents always use shift 0 — upflagit maths, cnF2freq.cpp:986)
    def shift_bit_of_parent(self, k: int) -> int:
        return 1 + k

    # -- turn-mask layout (phase-flip optimisation) ------------------------
    # aroundturner (cnF2freq.cpp:498-554): turn bits 0..typebits-1 align
    # with state bits; for numgen==3 the mask `turn & 54` XORs grandparent
    # bits into the state while bits {0,3,6} become shift-mode flips.
    @cached_property
    def turn_state_mask(self) -> int:
        if self.numgen != 3:
            return 3
        mask = 0
        for k in range(2):
            for b in list(self.state_bits_of_parent(k))[1:]:
                mask |= 1 << b
        return mask  # == 54 for the default F2 config

    def turn_shift_flip(self, turn: int) -> int:
        """Shift-mode XOR mask implied by a turn mask (cnF2freq.cpp:506-521)."""
        if self.numgen == 3:
            flip = turn >> self.typebits
            if turn & 1:
                flip |= 2
            if turn & 8:
                flip |= 4
            return flip
        return turn >> self.typebits

    def _default_typesexes(self) -> Tuple[int, ...]:
        if self.numgen == 3:
            return (0, 0, 1, 1, 0, 1)   # settings.h:21
        return (0, 1)                   # settings.h:63

    def _default_typegens(self) -> Tuple[int, ...]:
        if self.numgen == 3:
            return (1, 0, 0, 1, 0, 0)   # settings.h:23
        return (1, 1)


# The reference's default build: F2 with haplotyping (settings.h:18-42).
F2_HAPLO = ModelConfig()
# "F2 with no haplotyping" block (settings.h:60-73): 4 states, no phases.
F2_NOHAPLO = ModelConfig(numgen=2, haplotyping=False, relskews=False,
                         do_infprobs=False)


@dataclasses.dataclass
class RuntimeParams:
    """Scalar knobs the reference keeps as globals (cnF2freq.cpp:228-296,
    3573-3574)."""

    discstep: float = 1.0
    baserec: float = None  # type: ignore[assignment]
    scalefactor: float = 0.013
    entropyfactor: float = 1.0
    maxdiff: float = 5e-6
    sexc: int = 2

    def __post_init__(self):
        if self.baserec is None:
            self.baserec = -self.discstep / 50.0

    @property
    def genrec(self) -> Tuple[float, float, float]:
        # main() initialisation (cnF2freq.cpp:7927-7943): all generations use
        # the same base rate by default.
        return (self.baserec, self.baserec, self.baserec)
