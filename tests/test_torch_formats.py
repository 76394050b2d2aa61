"""The port's copies of the JAX package's other file formats against the
originals, on the same files (numpy only: no JAX compile).

Fixtures are a ``simulate_f2`` cohort (6 F2s, two chromosomes of 8
markers, 30% missing, 2% errors; one chromosome of 16 for Gigi, whose map
holds one) written by the port's
``utils.simulate.write_cohort_files`` as MERLIN, Gigi, ccoeff and ShapeIT
haps (+ PLINK fam/bed, a VCF template).  Each reader of each package reads
the same files into its own ``Pedigree``; the two must be equal in every
field, every individual's every field and every attribute a reader adds
(``map_indices``, ``hapmonomorphs``, ``markertranslation``), exactly.  The
writers (``write_merlin_ped``, ``write_fam_bed``, ``output_vcf`` plain and
gzip, ``create_hap_file``) must give the same bytes (gzip: the same text)
from the same pedigree state.  The readers compare through their own
pedigrees, not through ``pedigree.from_host``, which carries no dynamic
attribute.
"""
import dataclasses
import gzip
import io

import numpy as np
import pytest

import cnf2freq_tpu.io as jio
import cnf2freq_tpu.pedigree as jped
import cnf2freq_tpu_torch.io as pio
import cnf2freq_tpu_torch.pedigree as pped
from cnf2freq_tpu_torch.utils.simulate import (COHORT_FORMATS, simulate_f2,
                                               write_cohort_files)

PKGS = {"jax": (jio, jped), "port": (pio, pped)}


@pytest.fixture(scope="module")
def cohorts():
    two = simulate_f2(n_f2=6, n_markers=8, n_chromosomes=2, seed=5)
    return {fmt: simulate_f2(n_f2=6, n_markers=16, seed=5)
            if fmt == "gigi" else two for fmt in COHORT_FORMATS}


@pytest.fixture(scope="module")
def files(cohorts, tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    return {fmt: write_cohort_files(cohorts[fmt], str(root / fmt), fmt,
                                    seed=3)
            for fmt in COHORT_FORMATS}


def read(pkg, fmt, f, fam_bed=False):
    """The pedigree the package's readers build from the set ``f`` (the
    order of its CLI)."""
    io_, ped_mod = PKGS[pkg]
    ped = ped_mod.Pedigree()
    if fmt == "merlin":
        io_.read_merlin_map(ped, f["merlinmap"])
        io_.read_merlin_ped(ped, f["merlinped"])
    elif fmt == "gigi":
        ped = io_.load_gigi(f["gigimapfile"], f["gigipedfile"])
    elif fmt == "ccoeff":
        ped = io_.load_ccoeff(f["markerinfo"], f["ccoeffped"],
                              f["ccoeffgen"])
    else:
        samples = io_.read_sample(f["samplefile"])
        io_.read_haps_full(ped, samples, f["bimfile"], f["hapfiles"])
        if fam_bed:
            ped.changed = io_.read_fam_bed(ped, f["famfile"], f["bedfile"])
    return ped


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_same_pedigree(pj, pp):
    """Every field of the two pedigrees, each individual's fields and every
    dynamic attribute, exactly."""
    vj, vp = vars(pj), vars(pp)
    assert set(vj) == set(vp)
    for k in vj:
        if k == "config":
            assert dataclasses.asdict(vj[k]) == dataclasses.asdict(vp[k])
        elif k == "inds":
            assert len(vj[k]) == len(vp[k]) and vj[k][0] is vp[k][0] is None
            for ij, ip in zip(vj[k][1:], vp[k][1:]):
                for f in dataclasses.fields(ij):
                    _same(getattr(ij, f.name), getattr(ip, f.name),
                          f"{ij.name}.{f.name}")
        elif k == "markerposes" or k == "actrec":
            _same(vj[k], vp[k], k)
        elif isinstance(vj[k], list) and vj[k] and \
                isinstance(vj[k][0], (bool, np.bool_)):
            assert list(map(bool, vj[k])) == list(map(bool, vp[k])), k
        else:
            _same(vj[k], vp[k], k)


@pytest.mark.parametrize("fmt,fam_bed", [
    ("merlin", False), ("gigi", False), ("ccoeff", False), ("haps", False),
    ("haps", True)], ids=["merlin", "gigi", "ccoeff", "haps",
                          "haps_fam_bed"])
def test_readers_match(files, cohorts, fmt, fam_bed):
    cohort = cohorts[fmt]
    pj = read("jax", fmt, files[fmt], fam_bed)
    pp = read("port", fmt, files[fmt], fam_bed)
    assert_same_pedigree(pj, pp)
    # what each reader must have read: the map, every typed member, the
    # worklist of its format
    assert pp.num_markers == cohort.num_markers
    assert pp.chromstarts == cohort.chromstarts
    np.testing.assert_allclose(pp.markerposes, cohort.markerposes,
                               atol=1e-9)
    f2 = [cohort.by_id(n) for n in cohort.dous]
    key = (lambda ind: str(ind.n)) if fmt == "ccoeff" else \
        (lambda ind: ind.name)
    if fmt != "haps":
        for ind in f2:
            np.testing.assert_array_equal(pp.getind(key(ind)).markerdata,
                                          ind.markerdata)
    n_dous = {"merlin": len(cohort.inds) - 3, "gigi": len(cohort.inds) - 1,
              "ccoeff": len(f2), "haps": len(cohort.inds) - 1}[fmt]
    assert len(pp.dous) == n_dous
    if fmt == "ccoeff":
        # per-sex maps: -1 at each chromosome's first marker, the 1:3
        # father:mother split elsewhere
        for c in range(pp.num_chromosomes):
            lo, hi = pp.chromosome_range(c)
            assert (pp.actrec[:, lo] == -1.0).all()
        assert (pp.actrec[0, 1:8] > pp.actrec[1, 1:8]).all()
        assert (pp.markertranslation == 0).sum() == 1
    if fam_bed:
        assert pj.changed == pp.changed > 0


def test_read_haps_only_matches(files):
    """--hapfiles folded onto a loaded pedigree (the alleles from the haps
    columns): the MERLIN set, then the haps files."""
    peds = {}
    for pkg in PKGS:
        ped = read(pkg, "merlin", files["merlin"])
        for ind in ped.inds[1:]:
            ind.has_prior = True
            ind.priormarkerdata = np.where(ind.markerdata > 0, 0,
                                           ind.markerdata).astype(np.int32)
            ind.priormarkersure = np.zeros_like(ind.markersure)
        PKGS[pkg][0].read_haps_only(ped, files["haps"]["hapfiles"])
        peds[pkg] = ped
    assert_same_pedigree(peds["jax"], peds["port"])
    assert any((i.haploweight != 0.5).any() for i in peds["port"].inds[1:])


@pytest.fixture(scope="module")
def haps_state(files):
    """The haps pedigree of each package, with the same seeded haploweights
    and some imputed genotypes, for the writers."""
    out = {}
    for pkg in PKGS:
        ped = read(pkg, "haps", files["haps"], fam_bed=True)
        r = np.random.default_rng(17)
        for ind in ped.inds[1:]:
            ind.haploweight[:] = r.uniform(0.0, 1.0, ind.haploweight.shape)
            flip = r.random(ind.markerdata.shape[0]) < 0.1
            ind.markerdata[flip] = 3 - ind.markerdata[flip]
        out[pkg] = ped
    return out


def test_output_vcf_identical(files, haps_state, tmp_path):
    tpl = files["haps"]["templatevcffile"]
    texts = {}
    for pkg, ped in haps_state.items():
        buf = io.StringIO()
        PKGS[pkg][0].output_vcf(ped, tpl, buf)
        texts[pkg] = buf.getvalue()
        gz = tmp_path / f"{pkg}.vcf.gz"
        PKGS[pkg][0].output_vcf(ped, tpl, str(gz))
        with gzip.open(gz, "rt") as f:
            assert f.read() == texts[pkg]
    assert texts["port"] == texts["jax"]
    recs = [ln.split("\t") for ln in texts["port"].splitlines()
            if not ln.startswith("#")]
    ped = haps_state["port"]
    assert len(recs) == ped.num_markers
    gts = [c.split(":")[0] for r in recs for c in r[9:]]
    assert len(gts) == ped.num_markers * len(ped.dous)
    assert {"0|1", "1|0", "0|0", "1|1"} <= set(gts)


def test_create_hap_file_identical(files, haps_state):
    texts = {}
    for pkg, ped in haps_state.items():
        io_ = PKGS[pkg][0]
        buf = io.StringIO()
        io_.create_hap_file(ped, io_.read_sample(files["haps"]["samplefile"]),
                            files["haps"]["hapfiles"][0], buf)
        texts[pkg] = buf.getvalue()
    assert texts["port"] == texts["jax"]
    with open(files["haps"]["hapfiles"][0]) as f:
        assert texts["port"] != f.read()     # some phases were swapped


def test_fam_bed_round_trip(haps_state, tmp_path):
    """write_fam_bed gives the same bytes, and read_fam_bed of its output
    the same prior bumps, in both packages."""
    out = {}
    for pkg, ped in haps_state.items():
        plink = PKGS[pkg][0]
        fam, bed = tmp_path / f"{pkg}.fam", tmp_path / f"{pkg}.bed"
        plink.write_fam_bed(ped, str(fam), str(bed))
        before = np.stack([i.priormarkersure for i in ped.inds[1:]]).copy()
        changed = plink.read_fam_bed(ped, str(fam), str(bed))
        after = np.stack([i.priormarkersure for i in ped.inds[1:]])
        out[pkg] = (fam.read_bytes(), bed.read_bytes(), changed,
                    before, after)
    for a, b in zip(out["jax"], out["port"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    # each change moves the prior uncertainty to 0.5 (0.5 + prior)
    _, _, changed, before, after = out["port"]
    moved = after != before
    assert changed > 0 and moved.any()
    np.testing.assert_array_equal(after[moved], 0.5 * (0.5 + before[moved]))


def test_merlin_writer_quirk(files):
    """write_merlin_ped writes the first chromosome without a phenotype
    column; read_merlin_ped needs one, so the written file reads back as
    an empty pedigree, in both packages alike."""
    texts, dous = {}, {}
    for pkg in PKGS:
        io_, ped_mod = PKGS[pkg]
        ped = read(pkg, "merlin", files["merlin"])
        buf = io.StringIO()
        io_.write_merlin_ped(ped, buf)
        texts[pkg] = buf.getvalue()
        back = ped_mod.Pedigree()
        io_.read_merlin_map(back, files["merlin"]["merlinmap"])
        io_.read_merlin_ped(back, io.StringIO(texts[pkg]))
        dous[pkg] = back.dous
    assert texts["port"] == texts["jax"]
    first = texts["port"].splitlines()[0].split("\t")
    assert len(first) == 5 + 2 * 8
    assert dous == {"jax": [], "port": []}
