"""Tensorized emission model (enum axes trailing).

The emission of one analysis unit is a closed-form factored product over
the family slots, evaluated for all (state, path, shift) combinations:

    E[g, f, s] = sum_{r0} F(r0, s0) * PB_0(g_{0:3}, f_{1:4}, s1; r0)
                                     * PB_1(g_{3:6}, f_{4:7}, s2; r0)

``F`` is the focal term and ``PB_k`` the block of parent k (the parent
and its two ancestors), tiny tensors over [r0(2), fp(8), fpath(8), sk(2)]
per (unit, marker).  Port of ``cnf2freq_tpu/hmm/emission.py``: the
``ci``, ``zp``, ``inval``/``insv`` and ``side`` options that
preprocessing uses, the GENOS ``update`` mode, and the extended state
spaces' root options (``root_override``: the selfing
HBD-collapsed focal pair; ``no_root_collapse``: RELSKEWSTATES keeps both
root interpretations at a duplicate-allele marker).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import (GENOS, SEXMARKER, UNKNOWN, ZP_NONE, ZP_PROPAGATE,
                      ModelConfig)

from ..utils.transfer import constant
from .family import FamilyBatch

# trailing enum axes of a fully expanded parent block, each of size 2;
# (gb1, gb0, p0) merge to fp and (rg1, rg0, rp) to fpath
_NAX = 8
_AX = {name: i for i, name in enumerate(
    ["r0", "gb1", "gb0", "p0", "rg1", "rg0", "rp", "sk"])}


@lru_cache(maxsize=64)
def _enum(name: str, device: str) -> torch.Tensor:
    shape = [1] * _NAX
    shape[_AX[name]] = 2
    return torch.arange(2, device=device).reshape(shape)


def _ex(x: torch.Tensor, n: int = _NAX) -> torch.Tensor:
    """Append n singleton enum axes to a data array."""
    return x.reshape(x.shape + (1,) * n)


def _pick(pair, idx):
    """pair[..., 2] selected by enum-index array idx (values 0/1)."""
    return torch.where(idx == 1, _ex(pair[..., 1]), _ex(pair[..., 0]))


def _safe_div(a, b):
    ok = b > 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def _match_raw(v, sv, mdj, msj, zp: int):
    """markermiss + base-value arithmetic of one slot test.  Returns
    (bv, pre, bound): raw base value, un-normalised second-channel
    weight, and the value that continues up the branch."""
    unknown_v = v == UNKNOWN
    bound = torch.where(unknown_v, mdj, v) if zp == ZP_NONE else v
    if zp == ZP_PROPAGATE:
        miss = torch.zeros(torch.broadcast_shapes(v.shape, mdj.shape),
                           dtype=torch.bool, device=v.device)
    else:
        miss = (~unknown_v) & ~((mdj == UNKNOWN) & (v != SEXMARKER)) \
            & (v != mdj)
    bv_match = 1.0 - msj
    effsecond = torch.where(unknown_v & (bound != UNKNOWN),
                            torch.ones_like(sv), sv)
    effms = torch.where(mdj == UNKNOWN, torch.ones_like(msj), msj)
    pre_match = effms * effsecond
    pre_miss = torch.where((msj != 0) & (sv != 0), (1.0 - msj) * sv,
                           torch.zeros_like(msj * sv))
    bv = torch.where(miss, msj, bv_match)
    pre = torch.where(miss, pre_miss, pre_match)
    return bv, pre, bound


def _collapse(md, ms, ci: bool):
    same = md[..., 0] == md[..., 1]
    return same if ci else same & (ms[..., 0] == ms[..., 1])


def _phase(md, ms, hw, f2n, zp: int, ci: bool, haplotyping: bool):
    """Phase-interpretation factor; f2n an integer enum tensor."""
    f2nf = f2n.to(hw.dtype)
    collapse = _ex(_collapse(md, ms, ci))
    if zp != ZP_NONE or not haplotyping:
        half = torch.full_like(f2nf + _ex(hw), 0.5)
        if zp != ZP_NONE:
            return half
        return torch.where(collapse, f2nf, half)
    return torch.where(collapse, f2nf, (f2nf - _ex(hw)).abs())


class SlotData(NamedTuple):
    md: torch.Tensor      # [..., 2]
    ms: torch.Tensor      # [..., 2]
    hw: torch.Tensor      # [...]
    exists: torch.Tensor  # [...] bool (broadcastable)
    attop: torch.Tensor   # [...] bool


def slot_data(fb: FamilyBatch, slot: int) -> SlotData:
    """Slot arrays with [B, M] prefix (exists/attop broadcast over M)."""
    return SlotData(md=fb.md[:, slot], ms=fb.ms[:, slot], hw=fb.hw[:, slot],
                    exists=fb.exists[:, slot][:, None],
                    attop=fb.attop[:, slot][:, None])


def _gp_term(gp: SlotData, w, sw, gb, rg, zp: int, ci: bool,
             haplotyping: bool):
    """Grandparent (top-of-recursion) slot term; 1 + sw when vacant."""
    bv, pre, _ = _match_raw(w, sw, _pick(gp.md, rg), _pick(gp.ms, rg), zp)
    ph = _phase(gp.md, gp.ms, gp.hw, rg ^ gb, zp, ci, haplotyping)
    return torch.where(_ex(gp.exists), (bv + pre) * ph, 1.0 + sw)


def parent_block(par: SlotData, gp0: SlotData, gp1: SlotData, v, sv,
                 zp: int = ZP_NONE, ci: bool = False,
                 haplotyping: bool = True, trace_second: bool = True,
                 pathful: bool = False):
    """One parent branch of the emission product.

    v, sv: [..., 2] value/second-channel per focal interpretation r0.
    trace_second: the walk continues past the parent into its second
    branch (off for a GENOS update's traced parent).
    Returns [..., r0(2), fp(8), fpath(8), sk(2)] if pathful, else summed
    over fpath."""
    dev = str(v.device)
    R0, GB1, GB0, P0, RG1, RG0, RP, SK = (
        _enum(n, dev) for n in ("r0", "gb1", "gb0", "p0", "rg1", "rg0",
                                "rp", "sk"))
    vb = _pick(v, R0)
    svb = _pick(sv, R0)

    md_rp, ms_rp = _pick(par.md, RP), _pick(par.ms, RP)
    md_o, ms_o = _pick(par.md, 1 - RP), _pick(par.ms, 1 - RP)

    bv_raw, pre, bound = _match_raw(vb, svb, md_rp, ms_rp, zp)
    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)
    ph = _phase(par.md, par.ms, par.hw, RP ^ P0 ^ SK, zp, ci, haplotyping)

    one = torch.ones_like(ms_o)
    sec_f = torch.where(ms_o != 0, 1.0 - ms_o, one)
    secsec = torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o),
                         torch.zeros_like(ms_o))

    trace2 = trace_second and zp == ZP_NONE
    g0_first = _gp_term(gp0, bound, ms_nab, GB0, RG0, zp, ci, haplotyping)
    g1_first = _gp_term(gp1, bound, ms_nab, GB1, RG1, zp, ci, haplotyping)
    if trace2:
        g0_second = _gp_term(gp0, md_o, secsec, GB0, RG0, zp, ci,
                             haplotyping)
        g1_second = _gp_term(gp1, md_o, secsec, GB1, RG1, zp, ci,
                             haplotyping)
        deep = bv_raw * ph * sec_f * torch.where(
            P0 == 0, g0_first * g1_second, g1_first * g0_second)
    else:
        deep = bv_raw * ph * torch.where(P0 == 0, g0_first, g1_first)

    term = torch.where(_ex(par.attop), bv_abs * ph, deep)
    term = torch.where(_ex(par.exists), term, 1.0 + svb)

    # canonical-path weights: a path bit the recursion never consumes
    # (vacant grandparent, founder parent, untraced second branch) may
    # only count in its 0 assignment
    ex_p, at_p = _ex(par.exists), _ex(par.attop)
    cons = []
    for j, (gp, rg) in enumerate(((gp0, RG0), (gp1, RG1))):
        c = ex_p & ~at_p & _ex(gp.exists)
        if not trace2:
            c = c & (P0 == j)
        cons.append(c | (rg == 0))
    weight = (ex_p | (RP == 0)) & cons[0] & cons[1]
    term = term * weight.to(term.dtype)

    shp = term.shape[:-_NAX]
    term = term.expand(shp + (2,) * _NAX).reshape(shp + (2, 8, 8, 2))
    return term if pathful else term.sum(dim=-2)


class RootBlock(NamedTuple):
    froot: torch.Tensor   # [..., r0(2), s0(2)]
    vA: torch.Tensor      # [..., r0(2)] value into the first-branch parent
    svA: torch.Tensor
    vB: torch.Tensor      # [..., r0(2)] value into the second-branch parent
    svB: torch.Tensor
    top: torch.Tensor     # [..., r0(2), s0(2)] focal-as-top term


def root_block(focal: SlotData, update: int = 0, zp: int = ZP_NONE,
               ci: bool = False, haplotyping: bool = True, inval=None,
               insv=None, side: int = 0, dtype=torch.float64,
               root_override=None,
               no_root_collapse: bool = False) -> RootBlock:
    """Focal-individual factor plus the per-branch values it feeds up.
    side: the root's firstpar bit (side=1 swaps which parent receives
    the continuing branch).  update: 0 or the GENOS probe mode.
    root_override: (md_r, ms_r, md_o, ms_o, collapse) [B, M] tensors
    replacing the focal's own marker pair, independent of r0 (the
    selfing HBD-collapsed pair).  no_root_collapse: no
    duplicate-allele collapse at the root (RELSKEWSTATES)."""
    dev = focal.hw.device
    R0 = torch.arange(2, device=dev).reshape(2, 1)
    S0 = torch.arange(2, device=dev).reshape(1, 2)

    def ex2(x):
        return x.reshape(x.shape + (1, 1))

    def pick2(pair, idx):
        return torch.where(idx == 1, ex2(pair[..., 1]), ex2(pair[..., 0]))

    if inval is None:
        inval = torch.zeros(focal.hw.shape, dtype=torch.int32, device=dev)
    if insv is None:
        insv = torch.zeros(focal.hw.shape, dtype=dtype, device=dev)
    iv, sv = ex2(inval), ex2(insv)

    if root_override is None:
        md_r, ms_r = pick2(focal.md, R0), pick2(focal.ms, R0)
        md_o, ms_o = pick2(focal.md, 1 - R0), pick2(focal.ms, 1 - R0)
    else:
        # r0-independent overrides, broadcast over the (r0, s0) enum axes
        md_r, ms_r, md_o, ms_o = (ex2(x).expand(x.shape + (2, 1))
                                  for x in root_override[:4])

    unknown_v = iv == UNKNOWN
    bound = torch.where(unknown_v, md_r, iv) if zp == ZP_NONE \
        else iv + md_r * 0
    if zp == ZP_PROPAGATE:
        miss = torch.zeros(bound.shape, dtype=torch.bool, device=dev)
    else:
        miss = (~unknown_v) & ~((md_r == UNKNOWN) & (iv != SEXMARKER)) \
            & (iv != md_r)
    one = torch.ones_like(ms_r)
    zero = torch.zeros_like(ms_r)
    effsecond = torch.where(unknown_v & (bound != UNKNOWN), one, sv)
    effms = torch.where(md_r == UNKNOWN, one, ms_r)
    pre = torch.where(miss,
                      torch.where((ms_r != 0) & (sv != 0),
                                  (1.0 - ms_r) * sv, zero),
                      effms * effsecond)
    bv_raw = torch.where(miss, ms_r, 1.0 - ms_r)

    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)

    if root_override is None:
        collapse = ex2(_collapse(focal.md, focal.ms, ci))
    else:
        collapse = ex2(root_override[4])
    if no_root_collapse:
        collapse = torch.zeros_like(collapse)
    f2n = R0 ^ side ^ S0
    if zp != ZP_NONE:
        ph = torch.full(torch.broadcast_shapes(collapse.shape, f2n.shape,
                                               ex2(focal.hw).shape), 0.5,
                        dtype=dtype, device=dev)
    else:
        f2nf = f2n.to(dtype)
        w = (f2nf - ex2(focal.hw)).abs() if haplotyping \
            else torch.full_like(f2nf - ex2(focal.hw), 0.5)
        ph = torch.where(collapse, f2nf, w)

    if update not in (0, GENOS):
        raise NotImplementedError("the port's blocks carry the standard "
                                  "and GENOS update modes only")
    attop = ex2(focal.attop)
    bv = torch.where(attop, bv_abs, bv_raw)
    msA = torch.where(attop, torch.zeros_like(ms_nab), ms_nab)

    # the second branch at the root (GENOS keeps only its base value)
    secfac = torch.ones_like(ms_o)
    svB = torch.zeros_like(ms_o)
    if update != GENOS:
        secfac = torch.where(ms_o != 0, 1.0 - ms_o, secfac)
        svB = torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), svB)

    froot = torch.where(attop, bv_abs * ph, bv * ph * secfac)
    top = bv_abs * ph
    return RootBlock(froot=froot, vA=bound[..., 0], svA=msA[..., 0],
                     vB=md_o[..., 0], svB=svB[..., 0], top=top)


class EmissionBlocks(NamedTuple):
    froot: torch.Tensor       # [b, m, r0(2), s0(2)]
    top: torch.Tensor         # [b, m, r0(2), s0(2)] focal-as-top variant
    pb: Tuple[torch.Tensor, torch.Tensor]  # [b, m, r0, fp, fpath, sk]
    focal_attop: torch.Tensor  # [b] bool
    side: int = 0


def build_blocks(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                 update: int = 0, zp: int = ZP_NONE, inval=None, insv=None,
                 side: int = 0, dtype=torch.float64, root_override=None,
                 no_root_collapse: bool = None) -> EmissionBlocks:
    """The factored emission blocks for one probe variant.
    no_root_collapse defaults to ``cfg.relskewstates``."""
    if cfg.numgen != 3:
        raise NotImplementedError("the 7-slot blocks need numgen == 3")
    if no_root_collapse is None:
        no_root_collapse = cfg.relskewstates
    focal = slot_data(fb, 0)
    rb = root_block(focal, update=update, zp=zp, ci=ci,
                    haplotyping=cfg.haplotyping, inval=inval, insv=insv,
                    side=side, dtype=dtype, root_override=root_override,
                    no_root_collapse=no_root_collapse)
    genos = update == GENOS
    pbs = []
    for k in range(2):
        par = slot_data(fb, cfg.parent_slot(k))
        gps = [slot_data(fb, cfg.grandparent_slot(k, j)) for j in range(2)]
        # the continuing branch feeds parent `side`, the second the other
        first = k == side
        vk, svk = (rb.vA, rb.svA) if first else (rb.vB, rb.svB)
        if genos and not first:
            # GENOS updates never trace the second branch at the root:
            # that parent contributes factor 1 on its canonical path
            B, M = fb.md.shape[0], fb.md.shape[2]
            pbs.append(torch.ones((B, M, 2, 8, 8, 2), dtype=dtype,
                                  device=fb.md.device) *
                       _canonical_only(dtype, fb.md.device))
            continue
        pbs.append(parent_block(par, gps[0], gps[1], vk, svk, zp=zp, ci=ci,
                                haplotyping=cfg.haplotyping,
                                trace_second=not genos, pathful=True))
    return EmissionBlocks(froot=rb.froot, top=rb.top, pb=tuple(pbs),
                          focal_attop=fb.attop[:, 0], side=side)


def _canonical_only(dtype, device="cpu") -> torch.Tensor:
    """[8] -> broadcastable fpath weight keeping only the all-zero path,
    for a branch the recursion never enters."""
    w = np.zeros(8)
    w[0] = 1.0
    return constant(w, device, dtype)[None, None, None, None, :, None]


def assemble_e_all(blocks: EmissionBlocks, cfg: ModelConfig) -> torch.Tensor:
    """E_all[b, m, s, g] from factored blocks (path axes summed)."""
    s0 = blocks.pb[0].sum(dim=-2)
    s1 = blocks.pb[1].sum(dim=-2)
    e = torch.einsum("...rt,...rau,...rbv->...vutba", blocks.froot, s0, s1)
    B, M = e.shape[:2]
    e = e.reshape(B, M, cfg.numshifts, cfg.numtypes)
    tops = blocks.top.sum(dim=-2).repeat(1, 1, cfg.numshifts // 2)
    tops = tops[:, :, :, None].expand(B, M, cfg.numshifts, cfg.numtypes)
    return torch.where(blocks.focal_attop[:, None, None, None], tops, e)


def emission_all(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                 dtype=torch.float64) -> torch.Tensor:
    """E_all[b, m, s, g]: per-state, per-shift emission summed over all
    interpretation paths."""
    return assemble_e_all(build_blocks(fb, cfg, ci=ci, dtype=dtype), cfg)
