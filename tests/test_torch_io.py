"""The port's PlantImpute reader, output writers and masking against the
JAX package's (numpy only, no JAX compile).

* Parsers: small PlantImpute file sets (the port's
  ``simulate_plantimpute_files`` and a hand-written set with ``a/b`` read
  counts including ``0/0``, code 9, a ``gen >= 2`` row with founder
  parents, a ``haplo`` doubled-haploid parent and a two-chromosome map)
  go through both packages' ``load_plantimpute`` and through the port's
  with ``use_native=True`` and ``False``: every field of every individual
  is identical.  ``markersure`` is compared exactly, except against the
  JAX package's native reader on read-count tokens: that reader rounds
  the binomial model through log-gamma, so its own two paths differ in
  the last bits there (rtol 1e-12, as its own tests/test_native_genread.py
  holds them); the port's native reader computes the coefficient exactly
  (up to 120 reads) and matches its Python reader, and the JAX
  package's, bit for bit.
* Malformed input: a garbage token raises ValueError, a truncated row a
  ValueError that names the individual, a missing file
  FileNotFoundError, on both reader paths; a stream needs
  ``use_native=False``; a failed build of the native reader raises.
* Writers: the same pedigree and tables give the same text from both
  packages' ``write_genotype_table`` (default, ``include_all``,
  ``phased``, with the skipped-block note on stderr),
  ``write_line_origin_table``, ``write_haplotype_dump`` and
  ``output_ped``; ``deserialize`` round-trips across the packages both
  ways; the masking functions give the same results.
"""
import io
import os

import numpy as np
import pytest

from cnf2freq_tpu.io import alpha as jalpha
from cnf2freq_tpu.io import masking as jmask
from cnf2freq_tpu.io import outputs as jout
from cnf2freq_tpu.pedigree import Pedigree as JaxPedigree
from cnf2freq_tpu_torch import native
from cnf2freq_tpu_torch.io import alpha as palpha
from cnf2freq_tpu_torch.io import masking as pmask
from cnf2freq_tpu_torch.io import outputs as pout
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files

FIELDS = ("name", "n", "gen", "sex", "empty", "pars", "founder",
          "has_prior")
ARRAYS = ("markerdata", "priormarkerdata", "haploweight", "relhaplo",
          "negshift", "lockstart", "lastinved")
SURE = ("markersure", "priormarkersure")

HAND_MAP = "0\n5\n10\n15\n20\n0\n4\n8\n"          # two chromosomes
HAND_PED = "\n".join([
    "A 0 0", "B 0 0",
    "C A B 2",            # founder parents at gen 2: implicit F1 pair
    "D A B 3",
    "E A B 1",
    "H 0 0",              # never genotyped: F's paternal line is data-less
    "F H E 2",
    "G A haplo 0",        # doubled haploid
]) + "\n"
HAND_GEN = "\n".join([
    "A 0 0 0 0 0 0 0 0",
    "B 2 2 2 2 2 2 2 2",
    "C 1 9 0/0 3/1 2 1 9 1/4",
    "D 0/0 1 2 9 0 12/2 1 1",
    "E 1 1 1 1 1 0/3 5/5 9",
    "F 2 1 9 1 0 2 1 0",
    "G 4/0 0 7/1 2 0/0 1/1 2 9",
]) + "\n"


def _hand_files(d):
    paths = []
    for name, text in (("h.map", HAND_MAP), ("h.ped", HAND_PED),
                       ("h.gen", HAND_GEN)):
        p = os.path.join(d, name)
        with open(p, "w") as f:
            f.write(text)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    sim = simulate_plantimpute_files(str(tmp_path_factory.mktemp("sim")),
                                     n_f2=9, n_markers=12, missing_rate=0.3,
                                     seed=4)[:3]
    return {"sim": sim,
            "hand": _hand_files(str(tmp_path_factory.mktemp("hand")))}


def _jax_python(mapfile, pedfile, genfile):
    ped = JaxPedigree()
    jalpha.read_alpha_map(ped, mapfile)
    jalpha.read_alpha_ped(ped, pedfile)
    jalpha.read_alpha_data(ped, genfile, use_native=False)
    return ped


def _loads(files):
    return {"port_native": palpha.load_plantimpute(*files),
            "port_python": palpha.load_plantimpute(*files, use_native=False),
            "jax_python": _jax_python(*files),
            "jax": jalpha.load_plantimpute(*files)}


def assert_same_pedigree(a, b, sure_rtol=0.0):
    assert a.dous == b.dous
    np.testing.assert_array_equal(a.markerposes, b.markerposes)
    assert a.chromstarts == b.chromstarts
    assert a._byname == b._byname
    assert len(a.inds) == len(b.inds)
    for ia, ib in zip(a.inds[1:], b.inds[1:]):
        for f in FIELDS:
            assert getattr(ia, f) == getattr(ib, f), (ia.name, f)
        for f in ARRAYS + SURE:
            va, vb = getattr(ia, f), getattr(ib, f)
            assert (va is None) == (vb is None), (ia.name, f)
            if va is None:
                continue
            if f in SURE and sure_rtol:
                np.testing.assert_allclose(va, vb, rtol=sure_rtol, atol=0,
                                           err_msg=f"{ia.name} {f}")
            else:
                np.testing.assert_array_equal(va, vb,
                                              err_msg=f"{ia.name} {f}")


@pytest.mark.parametrize("which", ["sim", "hand"])
def test_parsers_match(filesets, which):
    peds = _loads(filesets[which])
    ref = peds["port_native"]
    assert_same_pedigree(ref, peds["port_python"])
    assert_same_pedigree(ref, peds["jax_python"])
    # the JAX package's native reader: log-gamma rounding on read counts
    assert_same_pedigree(ref, peds["jax"],
                         sure_rtol=1e-12 if which == "hand" else 0.0)


def test_hand_set_exercises_every_branch(filesets):
    ped = palpha.load_plantimpute(*filesets["hand"])
    assert ped.chromstarts == [0, 5, 8]
    c = ped.getind("C")
    aux = [ped.getind("C_aux_realf"), ped.getind("C_aux_realm")]
    assert c.pars == (aux[0].n, aux[1].n) and c.gen == 2
    assert all(a.gen == 1 and a.empty for a in aux)
    assert ped.getind("D").gen == 3 and ped.getind("F").gen == 2
    assert ped.getind("H").empty and not ped.getind("F").empty
    g = ped.getind("G")
    assert g.pars[1] == ped.getind("haplo").n
    # doubled haploid: read-count tokens carry the sexmarker second allele
    assert list(g.markerdata[:, 1]) == [9, 1, 9, 2, 9, 9, 2, 0]
    # 0/0 and code 9 are unknown with zero error, a/b a fitted error
    assert tuple(c.markerdata[2]) == (0, 0) and tuple(c.markersure[2]) == \
        (0.0, 0.0)
    assert tuple(c.markerdata[1]) == (0, 0)
    assert 0.0 < c.markersure[3, 0] < 0.5
    assert ped.getind("D").has_prior


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_malformed_input(filesets, tmp_path, use_native):
    mapfile, pedfile, _ = filesets["hand"]
    rows = HAND_GEN.splitlines()
    cases = {"garbage": rows[:2] + ["C 1 9 x 3/1 2 1 9 1/4"] + rows[3:],
             "garbage_readcount": rows[:2] + ["C 1 9 0/z 3/1 2 1 9 1"],
             "truncated": rows[:4] + ["E 1 1 1"]}
    for name, lines in cases.items():
        p = tmp_path / f"{name}.gen"
        p.write_text("\n".join(lines) + "\n")
        with pytest.raises(ValueError) as err:
            palpha.load_plantimpute(mapfile, pedfile, str(p),
                                    use_native=use_native)
        if name == "truncated":
            assert "'E'" in str(err.value) and "3 of 8" in str(err.value)
    with pytest.raises(FileNotFoundError):
        palpha.load_plantimpute(mapfile, pedfile, str(tmp_path / "no.gen"),
                                use_native=use_native)
    with pytest.raises(FileNotFoundError):
        palpha.load_plantimpute(str(tmp_path / "no.map"), pedfile,
                                filesets["hand"][2], use_native=use_native)


def test_native_reader_needs_a_path_and_a_build(filesets, tmp_path,
                                                monkeypatch):
    mapfile, pedfile, genfile = filesets["hand"]
    with open(genfile) as f, pytest.raises(TypeError, match="use_native"):
        palpha.load_plantimpute(mapfile, pedfile, f)
    with open(genfile) as f:
        from_stream = palpha.load_plantimpute(mapfile, pedfile, f,
                                              use_native=False)
    assert_same_pedigree(palpha.load_plantimpute(*filesets["hand"]),
                         from_stream)
    # a build that fails raises instead of falling back to Python
    monkeypatch.setenv("CNF2FREQ_TORCH_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on genread.cc"):
        palpha.load_plantimpute(*filesets["hand"])


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------
def _tables(ped, seed):
    rng = np.random.default_rng(seed)
    M = ped.num_markers
    pairs = {n: rng.uniform(0.0, 1.0, (M, 2, 2)) for n in ped.dous}
    lo = {}
    for n in ped.dous:
        t = rng.uniform(0.0, 1.0, (M, 3))
        lo[n] = t / t.sum(axis=1, keepdims=True)
    # a zero row falls back to the uniform table; a missing table too
    pairs[ped.dous[0]][1] = 0.0
    del pairs[ped.dous[-1]], lo[ped.dous[-1]]
    return pairs, lo


def _perturb(peds, seed):
    """The same random state in both pedigrees (as after iterations)."""
    rng = np.random.default_rng(seed)
    for inds in zip(*(p.inds[1:] for p in peds)):
        hw = rng.uniform(0.0, 1.0, inds[0].haploweight.shape)
        hw[::3] = 0.5
        rh = rng.uniform(0.0, 1.0, hw.shape)
        ns = rng.uniform(-1.0, 1.0, hw.shape)
        for ind in inds:
            ind.haploweight[:] = hw
            ind.relhaplo[:] = rh
            ind.negshift[:] = ns


@pytest.fixture(scope="module")
def written(filesets):
    """Each package's writers on the same pedigree (the hand set, which
    has a skipped block) and the same tables."""
    out = {}
    for pkg, load, mod in (("jax", jalpha.load_plantimpute, jout),
                           ("port", palpha.load_plantimpute, pout)):
        ped = load(*filesets["hand"])
        out[pkg] = dict(ped=ped, mod=mod)
    _perturb([out["jax"]["ped"], out["port"]["ped"]], seed=5)
    out["tables"] = _tables(out["port"]["ped"], seed=6)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(include_all=True),
                                dict(phased=True)],
                         ids=["default", "include_all", "phased"])
def test_genotype_table_text(written, kw, capsys):
    pairs, _ = written["tables"]
    texts, notes, skipped = {}, {}, {}
    for pkg in ("jax", "port"):
        buf = io.StringIO()
        skipped[pkg] = written[pkg]["mod"].write_genotype_table(
            written[pkg]["ped"], pairs, buf, **kw)
        texts[pkg] = buf.getvalue()
        notes[pkg] = capsys.readouterr().err
    assert texts["port"] == texts["jax"]
    assert notes["port"] == notes["jax"]
    assert skipped["port"] == skipped["jax"]
    if kw.get("include_all"):
        assert skipped["port"] == []
    else:
        assert skipped["port"] == ["F"] and "skipped 1 block(s)" in \
            notes["port"]


def test_line_origin_dump_and_ped_text(written, tmp_path):
    _, lo = written["tables"]
    texts = {}
    for pkg in ("jax", "port"):
        ped, mod = written[pkg]["ped"], written[pkg]["mod"]
        a, b = io.StringIO(), io.StringIO()
        mod.write_line_origin_table(ped, lo, a)
        mod.write_haplotype_dump(ped, b, reset_negshift=False)
        path = tmp_path / f"{pkg}.ped"
        mod.output_ped(ped, str(path))
        texts[pkg] = (a.getvalue(), b.getvalue(), path.read_text())
    for got, want in zip(texts["port"], texts["jax"]):
        assert got == want
    assert texts["port"][0].count(":") == 2 * len(written["port"]["ped"]
                                                   .dous)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_deserialize_round_trip(filesets, written, direction):
    src, dst = direction.split("_to_")
    buf = io.StringIO()
    written[src]["mod"].write_haplotype_dump(written[src]["ped"], buf,
                                             reset_negshift=False)
    fresh = {"jax": jalpha.load_plantimpute,
             "port": palpha.load_plantimpute}[dst](*filesets["hand"])
    switches = written[dst]["mod"].deserialize(fresh,
                                               io.StringIO(buf.getvalue()))
    ref = {"jax": jalpha.load_plantimpute,
           "port": palpha.load_plantimpute}[dst](*filesets["hand"])
    want = written["jax"]["mod"].deserialize(ref,
                                             io.StringIO(buf.getvalue()))
    assert switches == want and len(switches) == len(fresh.inds) - 1
    for a, b in zip(fresh.inds[1:], written[src]["ped"].inds[1:]):
        np.testing.assert_array_equal(a.markerdata, b.markerdata)
        np.testing.assert_allclose(a.haploweight, b.haploweight, atol=5e-7)
        np.testing.assert_allclose(a.markersure, b.markersure, atol=5e-7)
        np.testing.assert_allclose(a.relhaplo, b.relhaplo, atol=5e-7)
        np.testing.assert_array_equal(a.haploweight, ref.by_id(a.n)
                                      .haploweight)


def test_masking_matches(filesets, tmp_path, capsys):
    prot_m = tmp_path / "prot.markers"
    prot_m.write_text("map marker positions\n5 15 4\n")
    prot_i = tmp_path / "prot.inds"
    prot_i.write_text("1 D\n1 nobody\n")
    peds, found = {}, {}
    for pkg, load, mod in (("jax", jalpha.load_plantimpute, jmask),
                           ("port", palpha.load_plantimpute, pmask)):
        ped = load(*filesets["hand"])
        pm = mod.read_protected_markers(str(prot_m))
        pi = mod.read_protected_individuals(ped, str(prot_i))
        found[pkg] = (pm, pi, capsys.readouterr().err)
        mod.clear_unprotected(ped, pi, pm)
        peds[pkg] = ped
    assert found["port"] == found["jax"]
    assert found["port"][0] == {4.0, 5.0, 15.0}
    assert "Incorrect individual name. nobody" in found["port"][2]
    assert_same_pedigree(peds["port"], peds["jax"], sure_rtol=1e-12)
    assert (peds["port"].getind("C").markerdata[0] == 0).all()

    # --impoutput: a genotype table of another run against the data
    rng = np.random.default_rng(8)
    tabs = {n: rng.uniform(0.0, 1.0, (peds["port"].num_markers, 2, 2))
            for n in peds["port"].dous}
    table = io.StringIO()
    pout.write_genotype_table(peds["port"], tabs, table, include_all=True)
    capsys.readouterr()
    res = {}
    for pkg, mod in (("jax", jmask), ("port", pmask)):
        out = io.StringIO()
        n = mod.compare_imputed_output(peds[pkg],
                                       io.StringIO(table.getvalue()), out)
        res[pkg] = (n, out.getvalue())
    assert res["port"] == res["jax"]
