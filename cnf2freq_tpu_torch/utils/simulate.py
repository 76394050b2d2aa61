"""Synthetic F2 pedigree generator.

The port's own copy of ``cnf2freq_tpu/utils/simulate.py`` (no JAX, no
import of the JAX package): the same seed gives the same cohort.

The reference ships no benchmark generator (its closest analogue is the
QTLMAS genotype-grid simulator, cnF2freq.cpp:2952-3042).  This builds
PlantImpute-style F2 crosses of arbitrary size for benchmarks and tests:
founder pairs, implicit F1s, F2 offspring genotyped with configurable
missingness and error, meiosis simulated with Haldane recombination on the
given map.
"""

from __future__ import annotations

import numpy as np

from ..config import UNKNOWN
from ..pedigree import Pedigree


def simulate_f2(n_f2: int = 100, n_markers: int = 100,
                marker_spacing_cm: float = 1.0, n_founder_pairs: int = 1,
                missing_rate: float = 0.3, error_rate: float = 0.02,
                seed: int = 0, n_chromosomes: int = 1) -> Pedigree:
    rng = np.random.default_rng(seed)
    ped = Pedigree()
    per_chrom = n_markers
    poses = []
    starts = []
    for c in range(n_chromosomes):
        starts.append(len(poses))
        poses.extend(np.arange(per_chrom) * marker_spacing_cm)
    starts.append(len(poses))
    ped.markerposes = np.asarray(poses, dtype=float)
    ped.chromstarts = starts
    M = len(poses)

    def meiosis(geno):
        """One gamete from a [M, 2] genotype with Haldane crossovers."""
        out = np.empty(M, dtype=np.int32)
        for c in range(n_chromosomes):
            lo, hi = starts[c], starts[c + 1]
            d = np.diff(ped.markerposes[lo:hi])
            rec = 0.5 * (1 - np.exp(-2 * d / 100.0))
            strand = rng.integers(0, 2)
            idx = [strand]
            for r in rec:
                if rng.random() < r:
                    strand ^= 1
                idx.append(strand)
            out[lo:hi] = geno[np.arange(lo, hi), idx]
        return out

    def observe(ind, truth):
        ind.empty = False
        md = truth.copy()
        err = rng.random((M, 2)) < error_rate
        md[err] = 3 - md[err]          # flip 1<->2
        miss = rng.random(M) < missing_rate
        md[miss] = UNKNOWN
        ind.markerdata[:] = md
        ind.markersure[:] = np.where(md != UNKNOWN, error_rate, 0.0)
        ind.priormarkerdata = ind.markerdata.copy()
        ind.priormarkersure = ind.markersure.copy()
        ind.has_prior = True

    truths = {}
    fams = []
    for p in range(n_founder_pairs):
        fa = ped.getind(f"A{p}")
        fb = ped.getind(f"B{p}")
        fams.append((fa, fb))
    ped.freeze()
    for fa, fb in fams:
        truths[fa.n] = np.full((M, 2), 1, dtype=np.int32)
        truths[fb.n] = np.full((M, 2), 2, dtype=np.int32)
        observe(fa, truths[fa.n])
        observe(fb, truths[fb.n])

    for i in range(n_f2):
        fa, fb = fams[i % len(fams)]
        kid = ped.getind(f"F2_{i}")
        aux = [ped.getind(f"F2_{i}_aux_realf"), ped.getind(f"F2_{i}_aux_realm")]
        ped.freeze()
        for a in aux:
            a.gen = 1
            a.pars = (fa.n, fb.n)
            a.empty = True
            truths[a.n] = np.stack([meiosis(truths[fa.n]),
                                    meiosis(truths[fb.n])], axis=1)
        kid.gen = 2
        kid.pars = (aux[0].n, aux[1].n)
        truth = np.stack([meiosis(truths[aux[0].n]),
                          meiosis(truths[aux[1].n])], axis=1)
        truths[kid.n] = truth
        observe(kid, truth)
        kid.haploweight[:] = 0.5
        ped.dous.append(kid.n)
    ped.truths = truths
    return ped


def simulate_selfed(n_lines: int = 20, n_markers: int = 30,
                    generations: int = 4, marker_spacing_cm: float = 2.0,
                    missing_rate: float = 0.2, error_rate: float = 0.01,
                    seed: int = 0) -> Pedigree:
    """Selfed-line cohort for the SELFING model family: founders
    A=(1,1), B=(2,2) -> F1 -> per line, a chain of ``generations - 2``
    selfing steps (each child's two gametes drawn from ONE parent — the
    process the reference's HBD state bits model, settings.h:33-46,
    selfprec cnF2freq.cpp:2316-2327).  dous are the final-generation
    individuals; intermediate generations are genotyped with the same
    observation model.  ``ped.truths`` maps id -> [M, 2] true alleles."""
    assert generations >= 3, "selfing needs gen >= 3 (selfgen = gen - 2)"
    from ..config import ModelConfig
    rng = np.random.default_rng(seed)
    ped = Pedigree(ModelConfig(selfing=True))
    ped.markerposes = np.arange(n_markers) * marker_spacing_cm
    ped.chromstarts = [0, n_markers]
    M = n_markers

    def meiosis(geno):
        d = np.diff(ped.markerposes)
        rec = 0.5 * (1 - np.exp(-2 * d / 100.0))
        strand = rng.integers(0, 2)
        idx = [strand]
        for r in rec:
            if rng.random() < r:
                strand ^= 1
            idx.append(strand)
        return geno[np.arange(M), idx]

    def observe(ind, truth):
        ind.empty = False
        md = truth.copy()
        err = rng.random((M, 2)) < error_rate
        md[err] = 3 - md[err]
        miss = rng.random(M) < missing_rate
        md[miss] = UNKNOWN
        ind.markerdata[:] = md
        ind.markersure[:] = np.where(md != UNKNOWN, error_rate, 0.0)
        ind.priormarkerdata = ind.markerdata.copy()
        ind.priormarkersure = ind.markersure.copy()
        ind.has_prior = True

    names = ["A", "B", "F1"] + \
        [f"L{i}_G{g}" for i in range(n_lines)
         for g in range(2, generations + 1)]
    for nm in names:
        ped.getind(nm)
    ped.freeze()
    A, B, F1 = ped.getind("A"), ped.getind("B"), ped.getind("F1")
    truths = {A.n: np.full((M, 2), 1, dtype=np.int32),
              B.n: np.full((M, 2), 2, dtype=np.int32)}
    F1.pars = (A.n, B.n)
    F1.gen = 1
    truths[F1.n] = np.stack([meiosis(truths[A.n]), meiosis(truths[B.n])],
                            axis=1)
    observe(A, truths[A.n])
    observe(B, truths[B.n])
    observe(F1, truths[F1.n])
    for i in range(n_lines):
        parent = F1
        for g in range(2, generations + 1):
            ind = ped.getind(f"L{i}_G{g}")
            ind.pars = (parent.n, parent.n)
            ind.gen = g
            truths[ind.n] = np.stack([meiosis(truths[parent.n]),
                                      meiosis(truths[parent.n])], axis=1)
            observe(ind, truths[ind.n])
            parent = ind
        ped.dous.append(parent.n)
    ped.truths = truths
    return ped


def simulate_plantimpute_files(dirpath, n_f2: int = 20, n_markers: int = 30,
                               spacing_cm: float = 5.0,
                               missing_rate: float = 0.1,
                               error_rate: float = 0.02, seed: int = 0,
                               genotyped_f1: int = 0):
    """Write a synthesized F2 cohort in the PlantImpute .map/.ped/.gen
    format both the reference binary (readalphamap/-ped/-data,
    cnF2freq.cpp:6495-6685) and io.alpha read — including the mandatory
    trailing dummy marker (demo.sh:22-23).

    Founders A=(1,1), B=(2,2) at every marker; each F2 is bred through
    the implicit F1 pair that BOTH readers synthesize from the
    ``F2_i A B 2`` pedigree rows, so the in-memory pedigrees agree.
    Returns (mapfile, pedfile, genfile, truths) with truths[name] =
    [n_markers, 2] allele matrix (dummy column excluded)."""
    import os

    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    M = n_markers
    poses = np.arange(M) * spacing_cm

    def meiosis(geno):
        d = np.diff(poses)
        rec = 0.5 * (1 - np.exp(-2 * d / 100.0))
        strand = rng.integers(0, 2)
        idx = [strand]
        for r in rec:
            if rng.random() < r:
                strand ^= 1
            idx.append(strand)
        return geno[np.arange(M), idx]

    truths = {"A": np.full((M, 2), 1, dtype=np.int32),
              "B": np.full((M, 2), 2, dtype=np.int32)}
    rows = {}

    def observe(truth):
        obs = truth.copy()
        err = rng.random((M, 2)) < error_rate
        obs[err] = 3 - obs[err]
        code = (obs == 2).sum(axis=1)
        code[rng.random(M) < missing_rate] = 9
        return code

    f1names = []
    for k in range(genotyped_f1):
        name = f"E_{k}"
        truths[name] = np.stack([meiosis(truths["A"]),
                                 meiosis(truths["B"])], axis=1)
        rows[name] = observe(truths[name])
        f1names.append(name)
    for i in range(n_f2):
        name = f"F2_{i}"
        if genotyped_f1:
            pa = truths[f1names[(2 * i) % genotyped_f1]]
            pb = truths[f1names[(2 * i + 1) % genotyped_f1]]
        else:
            pa = np.stack([meiosis(truths["A"]), meiosis(truths["B"])],
                          axis=1)
            pb = np.stack([meiosis(truths["A"]), meiosis(truths["B"])],
                          axis=1)
        truth = np.stack([meiosis(pa), meiosis(pb)], axis=1)
        truths[name] = truth
        rows[name] = observe(truth)

    mapfile = os.path.join(dirpath, "synth.map")
    pedfile = os.path.join(dirpath, "synth.ped")
    genfile = os.path.join(dirpath, "synth.gen")
    with open(mapfile, "w") as f:
        for p in poses:
            f.write("%g\n" % p)
        f.write("%g\n" % (poses[-1] + 2 * spacing_cm))   # trailing dummy
    with open(pedfile, "w") as f:
        f.write("A 0 0\nB 0 0\n")
        for k in range(genotyped_f1):
            f.write("E_%d A B 1\n" % k)
        for i in range(n_f2):
            if genotyped_f1:
                f.write("F2_%d E_%d E_%d 2\n"
                        % (i, (2 * i) % genotyped_f1,
                           (2 * i + 1) % genotyped_f1))
            else:
                f.write("F2_%d A B 2\n" % i)
    with open(genfile, "w") as f:
        for k in range(genotyped_f1):
            r = rows[f"E_{k}"]
            f.write("E_%d " % k
                    + " ".join(str(c) for c in r) + " %d\n" % r[-1])
        # the dummy column carries real (duplicated last-marker) data,
        # matching the demo convention: an all-missing dummy makes every
        # update there gradient-free, and the reference then walks on
        # -ffast-math rounding noise (irreproducible by construction)
        f.write("A " + " ".join(["0"] * M) + " 0\n")
        f.write("B " + " ".join(["2"] * M) + " 2\n")
        for i in range(n_f2):
            r = rows[f"F2_{i}"]
            f.write("F2_%d " % i
                    + " ".join(str(c) for c in r) + " %d\n" % r[-1])
    return mapfile, pedfile, genfile, truths


def simulate_plantimpute_selfed_files(dirpath, n_lines: int = 8,
                                      n_markers: int = 10,
                                      generations: int = 4,
                                      spacing_cm: float = 5.0,
                                      missing_rate: float = 0.1,
                                      error_rate: float = 0.02,
                                      seed: int = 0):
    """Write a selfed-line cohort in the PlantImpute format.

    A pedigree row ``L_i A B <gen>`` with gen >= 2 makes both readers
    (reference readalphaped, cnF2freq.cpp:6515-6527, and io.alpha)
    synthesize aux F1 parents over the founders; under the SELFING
    build the line's HBD process runs with selfgen = gen - 2
    (selfingfactors, cnF2freq.cpp:2050-2063).  Lines are bred by an
    actual selfing chain: F1 = A x B, then ``generations - 2`` selfing
    steps where both gametes come from the same individual.

    Returns (mapfile, pedfile, genfile, truths)."""
    import os

    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    M = n_markers
    poses = np.arange(M) * spacing_cm

    def meiosis(geno):
        d = np.diff(poses)
        rec = 0.5 * (1 - np.exp(-2 * d / 100.0))
        strand = rng.integers(0, 2)
        idx = [strand]
        for r in rec:
            if rng.random() < r:
                strand ^= 1
            idx.append(strand)
        return geno[np.arange(M), idx]

    truths = {"A": np.full((M, 2), 1, dtype=np.int32),
              "B": np.full((M, 2), 2, dtype=np.int32)}
    rows = {}
    for i in range(n_lines):
        name = f"L_{i}"
        cur = np.stack([meiosis(truths["A"]), meiosis(truths["B"])],
                       axis=1)                      # the F1
        for _ in range(generations - 2):
            cur = np.stack([meiosis(cur), meiosis(cur)], axis=1)
        truths[name] = cur
        obs = cur.copy()
        err = rng.random((M, 2)) < error_rate
        obs[err] = 3 - obs[err]
        code = (obs == 2).sum(axis=1)
        code[rng.random(M) < missing_rate] = 9
        rows[name] = code

    mapfile = os.path.join(dirpath, "selfed.map")
    pedfile = os.path.join(dirpath, "selfed.ped")
    genfile = os.path.join(dirpath, "selfed.gen")
    with open(mapfile, "w") as f:
        for p in poses:
            f.write("%g\n" % p)
        f.write("%g\n" % (poses[-1] + 2 * spacing_cm))
    with open(pedfile, "w") as f:
        f.write("A 0 0\nB 0 0\n")
        for i in range(n_lines):
            f.write("L_%d A B %d\n" % (i, generations))
    with open(genfile, "w") as f:
        f.write("A " + " ".join(["0"] * M) + " 0\n")
        f.write("B " + " ".join(["2"] * M) + " 2\n")
        for i in range(n_lines):
            r = rows[f"L_{i}"]
            f.write("L_%d " % i
                    + " ".join(str(c) for c in r) + " %d\n" % r[-1])
    return mapfile, pedfile, genfile, truths


# the input formats of the CLI's other input sets that write_cohort_files
# writes; each returns {CLI flag (without "--"): path or paths}
COHORT_FORMATS = ("merlin", "gigi", "ccoeff", "haps")


def write_cohort_files(ped: Pedigree, dirpath, fmt: str, seed: int = 0):
    """Write a ``simulate_f2`` cohort as the input set ``fmt`` of the CLI
    (one of ``COHORT_FORMATS``) into ``dirpath``; returns {flag: path} for
    the flags that read it (``--hapfiles`` gets a list).

    Parents are written before their children: the founder pairs (the
    first of each pair as the father), the implicit F1 pairs (the ``realf``
    member as the father), then the F2s, whose parents are their F1 pair.
    Genotypes are the observed ``markerdata`` (0 = unknown); the implicit
    F1s carry none.
    * ``merlin``: ``.map`` (``chrom name cM bp``) and ``.ped`` with a
      phenotype column (``fam id father mother sex pheno a b ...``).
    * ``gigi``: ``.map`` (``chrom name cM 0``) and ``.ped``; the Gigi map
      holds one chromosome, so a cohort of more raises ValueError.
    * ``ccoeff``: marker info, pedigree and genotypes.  Individuals are
      named by their id ``n``; each F2 is a block of one (its four
      grandparents, its F1 pair, itself).  The global marker numbering is a
      seeded permutation of the map order with one extra marker on no
      chromosome (its genotype column is skipped), and the per-sex maps
      split each interval 1:3 (father:mother), averaging to the cohort's
      map.
    * ``haps``: ShapeIT ``.sample`` and ``.bim`` (bp = cM x 1e6), two
      ``.haps`` files from the simulated truths (the maximum realisation;
      then a sample in which a seeded half of the individuals switch phase
      from a seeded marker on and a seeded 2% of the alleles are wrong),
      PLINK ``.fam/.bed`` of the founders' and F2s' observed genotypes
      (``io.plink.write_fam_bed``), and a VCF template (REF 1, ALT 2,
      ``GT:DP``) over every sample.  The last marker is written as
      monomorphic (both alleles 1), which the bed reader reads as a
      hom-second-allele site."""
    import os

    from ..io.plink import write_fam_bed
    if fmt not in COHORT_FORMATS:
        raise ValueError(f"unknown format {fmt!r}: one of {COHORT_FORMATS}")
    if fmt == "gigi" and ped.num_chromosomes != 1:
        raise ValueError("the Gigi map holds one chromosome")
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    M = ped.num_markers
    inds = ped.inds[1:]
    typed = [i for i in inds if not i.empty]
    gen1 = [i for i in inds if i.empty]          # the implicit F1s
    f2 = [ped.by_id(n) for n in ped.dous]
    founders = [i for i in typed if not (i.pars[0] or i.pars[1])]
    order = founders + gen1 + f2
    fathers = {i.pars[0] for i in inds if i.pars[0]}
    sex = {i.n: 1 if i.n in fathers else 2 for i in order}
    chrom = np.zeros(M, dtype=int)
    for c in range(ped.num_chromosomes):
        lo, hi = ped.chromosome_range(c)
        chrom[lo:hi] = c + 1
    names = [f"m{k}" for k in range(M)]

    def name(n):
        return ped.by_id(n).name if n else "0"

    def geno(ind):
        md = ind.markerdata if not ind.empty else np.zeros((M, 2), int)
        return " ".join(f"{a} {b}" for a, b in md)

    def path(ext):
        return os.path.join(dirpath, f"cohort.{ext}")

    if fmt in ("merlin", "gigi"):
        with open(path("map"), "w") as f:
            for k in range(M):
                extra = int(round(ped.markerposes[k] * 1e6)) \
                    if fmt == "merlin" else 0
                f.write(f"{chrom[k]} {names[k]} {ped.markerposes[k]:.6f} "
                        f"{extra}\n")
        with open(path("ped"), "w") as f:
            for ind in order:
                f.write(f"1 {ind.name} {name(ind.pars[0])} "
                        f"{name(ind.pars[1])} {sex[ind.n]} 0 {geno(ind)}\n")
        return {f"{fmt}map" if fmt == "merlin" else "gigimapfile":
                path("map"),
                "merlinped" if fmt == "merlin" else "gigipedfile":
                path("ped")}

    if fmt == "ccoeff":
        perm = rng.permutation(M + 1)   # global number - 1 of map marker k
        with open(path("info"), "w") as f:
            f.write(f"{ped.num_chromosomes} {M + 1}\n")
            for c in range(ped.num_chromosomes):
                lo, hi = ped.chromosome_range(c)
                f.write(f"{hi - lo} " + " ".join(
                    str(perm[k] + 1) for k in range(lo, hi)) + "\n")
            for c in range(ped.num_chromosomes):
                lo, hi = ped.chromosome_range(c)
                d = np.diff(ped.markerposes[lo:hi], prepend=0.0)
                for t, share in enumerate((0.5, 1.5)):
                    f.write(f"{t + 1} " + " ".join(
                        f"{x:.6f}" for x in d * share) + "\n")
        with open(path("ped"), "w") as f:
            for kid in f2:
                pf, pm = (ped.by_id(p) for p in kid.pars)
                rows = [ped.by_id(g) for p in (pf, pm) for g in p.pars] + \
                    [pf, pm, kid]
                f.write("1\n")
                for i, ind in enumerate(rows):
                    strain = (founders.index(ind) % 2) + 1 if i < 4 else -1
                    f.write(f"{ind.n} {ind.pars[0]} {ind.pars[1]} "
                            f"{sex[ind.n]} {strain}\n")
        col = np.argsort(perm)          # map marker of global number i + 1
        with open(path("gen"), "w") as f:
            for ind in founders + f2:
                md = ind.markerdata
                f.write(f"{ind.n} " + " ".join(
                    f"{md[col[i], 0]} {md[col[i], 1]}" if col[i] < M
                    else "0 0" for i in range(M + 1)) + "\n")
        return {"markerinfo": path("info"), "ccoeffped": path("ped"),
                "ccoeffgen": path("gen")}

    # haps: every sample is an analysis unit of the haps reader
    with open(path("sample"), "w") as f:
        f.write("ID_1 ID_2 missing father mother sex plink_pheno\n"
                "0 0 0 D D B\n")
        for ind in order:
            f.write(f"1 {ind.name} 0 {name(ind.pars[0])} "
                    f"{name(ind.pars[1])} {sex[ind.n]} -9\n")
    bp = np.round(ped.markerposes * 1e6).astype(np.int64)
    alleles = [("1", "2")] * (M - 1) + [("1", "1")]
    with open(path("bim"), "w") as f:
        for k in range(M):
            f.write(f"{chrom[k]} {names[k]} 0 {bp[k]} {alleles[k][0]} "
                    f"{alleles[k][1]}\n")
    truth = np.stack([ped.truths[i.n] for i in order], axis=1) - 1  # [M,N,2]
    sampled = truth.copy()
    N = len(order)
    switch = rng.random(N) < 0.5
    at = rng.integers(1, M, N)
    for j in np.nonzero(switch)[0]:
        sampled[at[j]:, j] = sampled[at[j]:, j, ::-1]
    wrong = rng.random(sampled.shape) < 0.02
    sampled[wrong] = 1 - sampled[wrong]
    haps = []
    for h, vals in enumerate((truth, sampled)):
        haps.append(path(f"{h}.haps"))
        with open(haps[-1], "w") as f:
            for k in range(M):
                f.write(f"{chrom[k]} {names[k]} {bp[k]} {alleles[k][0]} "
                        f"{alleles[k][1]} " + " ".join(
                            str(x) for x in vals[k].ravel()) + "\n")
    write_fam_bed(ped, path("fam"), path("bed"),
                  ids=[i.n for i in founders + f2])
    with open(path("vcf"), "w") as f:
        f.write("##fileformat=VCFv4.2\n##source=write_cohort_files\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
                "\t".join(i.name for i in order) + "\n")
        for k in range(M):
            f.write(f"{chrom[k]}\t{bp[k]}\t{names[k]}\t1\t2\t.\tPASS\t.\t"
                    f"GT:DP\t" + "\t".join(["0|0:9"] * N) + "\n")
    return {"samplefile": path("sample"), "bimfile": path("bim"),
            "hapfiles": haps, "famfile": path("fam"), "bedfile": path("bed"),
            "templatevcffile": path("vcf")}


def argv_of(flags) -> list:
    """The command-line arguments of ``write_cohort_files``' {flag:
    path or paths}."""
    out = []
    for k, v in flags.items():
        out += [f"--{k}"] + (list(v) if isinstance(v, list) else [v])
    return out
