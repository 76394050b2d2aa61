"""Posterior update statistics: the enum-leading block helpers, the plain
PyTorch statistics (``stats_tile``) and the wrapper of the CUDA kernel.

Port of ``cnf2freq_tpu/ops/stats_pallas.py``.  Layout of the plain
helpers: enum axes LEADING, one flattened data axis trailing (the TPU's
(8, 128) tile pair becomes one axis of (marker, unit) pairs).  The block
math mirrors hmm/emission.py, specialised to the engine's standard probe
configuration (zp == ZP_NONE, ci == False, update == 0).

``stats`` is the wrapper of the v2 layout: a CPU tensor goes to
``stats_reference``; a CUDA tensor launches ``csrc/stats.cu`` (which
replaces the TPU kernel ``stats_pallas._kernel`` launched from
``scan_v2.stats_from_v2``) or raises.  ``stats_pallas`` is the wrapper of
the [B, M, NS, S] layout of the coherence-carrying scan (the TPU's own
launcher ``stats_pallas.stats_pallas`` of the same kernel): a CPU tensor
goes to ``stats_bmns_reference``, a CUDA tensor launches the second entry
of ``csrc/stats.cu``, which reads the sweeps and the family batch in
place.

The TPU kernel has a second form, ``rules=True`` (parity mode's probe
dedup): the ignoreflag2 rule 2-3 factors of ``_rule_factors_tile``
decorate froot and the masked parent blocks, launched once per dup-flip
variant and averaged.  ``stats_rules`` and ``stats_bmns_rules`` are its
wrappers (one variant a call; the rules entries of ``csrc/stats.cu``);
``stats(probe_rules=True)`` and ``stats_pallas(probe_rules=True)`` average
them over the variants.

``stats_ext`` is the wrapper of kernel #13, the third entry of
csrc/stats.cu: the extended spaces' statistics (SELFING, RELSKEWSTATES)
from the [B, M, V, NS, S] sweeps, every extension value and probe-rule
variant in one launch, for the JAX package's XLA program
``engine_ext.ext_statistics``; ``stats_ext_reference`` is its plain twin.
``engine_ext.ext_statistics`` routes a CUDA tensor to it.
"""

from __future__ import annotations

import torch

from ..config import SEXMARKER, UNKNOWN, ModelConfig

from .. import _build

_NAX = 8
_AXL = {name: i for i, name in enumerate(
    ["r0", "gb1", "gb0", "p0", "rg1", "rg0", "rp", "sk"])}
DATA_ND = 1


def _eL(name: str, device):
    """Enum index array [1]*8 + [1] with the named axis of length 2."""
    shape = [1] * (_NAX + DATA_ND)
    shape[_AXL[name]] = 2
    return torch.arange(2, device=device).reshape(shape)


def _iota(shape, dim, device):
    n = shape[dim]
    view = [1] * len(shape)
    view[dim] = n
    return torch.arange(n, device=device).reshape(view)


def _safe_div(a, b):
    ok = b > 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a * b))


def _pickL(pair, idx):
    """pair: [2, data...] selected by enum-index array idx (0/1)."""
    return torch.where(idx == 1, pair[1], pair[0])


def _match_raw_L(v, sv, mdj, msj):
    """markermiss + base-value arithmetic, zp == ZP_NONE path."""
    unknown_v = v == UNKNOWN
    bound = torch.where(unknown_v, mdj, v)
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


def _phase_L(md, ms, hw, f2n, haplotyping: bool):
    """Phase-interpretation factor; md/ms carry the allele axis LEADING."""
    f2nf = f2n.to(hw.dtype)
    collapse = (md[0] == md[1]) & (ms[0] == ms[1])
    weight = (f2nf - hw).abs() if haplotyping \
        else torch.full_like(f2nf + hw, 0.5)
    return torch.where(collapse, f2nf + 0.0 * hw, weight)


class SlotL:
    __slots__ = ("md", "ms", "hw", "exists", "attop")

    def __init__(self, md, ms, hw, exists, attop):
        self.md, self.ms, self.hw = md, ms, hw
        self.exists, self.attop = exists, attop


def _gp_term_L(gp: SlotL, w, sw, gb, rg, haplotyping: bool):
    """Grandparent slot term (attopnow); 1 + sw when vacant."""
    bv, pre, _ = _match_raw_L(w, sw, _pickL(gp.md, rg), _pickL(gp.ms, rg))
    ph = _phase_L(gp.md, gp.ms, gp.hw, rg ^ gb, haplotyping)
    return torch.where(gp.exists, (bv + pre) * ph, 1.0 + sw)


def parent_block_L(par: SlotL, gp0: SlotL, gp1: SlotL, v, sv,
                   haplotyping: bool = True):
    """One parent branch, enum-leading.  v, sv: [2(r0), data...].
    Returns [r0(2), fp(8), fpath(8), sk(2), data...]."""
    dev = v.device
    R0, P0, SK = _eL("r0", dev), _eL("p0", dev), _eL("sk", dev)
    GB0, GB1, RG0, RG1, RP = (_eL("gb0", dev), _eL("gb1", dev),
                              _eL("rg0", dev), _eL("rg1", dev),
                              _eL("rp", dev))
    vb = _pickL(v, R0)
    svb = _pickL(sv, R0)

    md_rp, ms_rp = _pickL(par.md, RP), _pickL(par.ms, RP)
    md_o, ms_o = _pickL(par.md, 1 - RP), _pickL(par.ms, 1 - RP)

    bv_raw, pre, bound = _match_raw_L(vb, svb, md_rp, ms_rp)
    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)
    ph = _phase_L(par.md, par.ms, par.hw, RP ^ P0 ^ SK, haplotyping)

    sec_f = torch.where(ms_o != 0, 1.0 - ms_o, torch.ones_like(ms_o))
    secsec = torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o),
                         torch.zeros_like(ms_o))

    g0_first = _gp_term_L(gp0, bound, ms_nab, GB0, RG0, haplotyping)
    g1_first = _gp_term_L(gp1, bound, ms_nab, GB1, RG1, haplotyping)
    g0_second = _gp_term_L(gp0, md_o, secsec, GB0, RG0, haplotyping)
    g1_second = _gp_term_L(gp1, md_o, secsec, GB1, RG1, haplotyping)
    deep = bv_raw * ph * sec_f * torch.where(
        P0 == 0, g0_first * g1_second, g1_first * g0_second)

    term = torch.where(par.attop, bv_abs * ph, deep)
    term = torch.where(par.exists, term, 1.0 + svb)

    # canonical-path weights (see parent_block in hmm/emission.py)
    ex_p, at_p = par.exists, par.attop
    cons = [(ex_p & ~at_p & gp.exists) | (rg == 0)
            for gp, rg in ((gp0, RG0), (gp1, RG1))]
    weight = (ex_p | (RP == 0)) & cons[0] & cons[1]
    term = term * weight.to(term.dtype)

    data_shape = term.shape[_NAX:]
    term = term.expand((2,) * _NAX + data_shape)
    return term.reshape((2, 8, 8, 2) + data_shape)


def root_block_L(focal: SlotL, haplotyping: bool = True, inval=None,
                 side: int = 0, dtype=torch.float64):
    """Focal term, enum-leading: (froot [2(r0), 2(s0), data...],
    vA [2(r0), data...], svA, vB, svB)."""
    dev = focal.hw.device
    R0 = _iota((2, 1) + (1,) * DATA_ND, 0, dev)
    S0 = _iota((1, 2) + (1,) * DATA_ND, 1, dev)
    if inval is None:
        iv = torch.zeros((1, 1) + (1,) * DATA_ND, dtype=torch.int32,
                         device=dev)
    else:
        iv = inval.reshape((1, 1) + tuple(inval.shape))
    sv = torch.zeros((1, 1) + (1,) * DATA_ND, dtype=dtype, device=dev)

    md_r, ms_r = _pickL(focal.md, R0), _pickL(focal.ms, R0)
    md_o, ms_o = _pickL(focal.md, 1 - R0), _pickL(focal.ms, 1 - R0)

    unknown_v = iv == UNKNOWN
    bound = torch.where(unknown_v, md_r, iv)
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

    collapse = (focal.md[0] == focal.md[1]) & (focal.ms[0] == focal.ms[1])
    f2n = R0 ^ side ^ S0
    if haplotyping:
        w = (f2n.to(dtype) - focal.hw).abs()
    else:
        w = torch.full_like(focal.hw + 0.0 * f2n, 0.5)
    ph = torch.where(collapse, f2n.to(dtype) + 0.0 * w, w)

    attop = focal.attop
    bv = torch.where(attop, bv_abs, bv_raw)
    msA = torch.where(attop, torch.zeros_like(ms_nab), ms_nab)

    secfac = torch.where(ms_o != 0, 1.0 - ms_o, torch.ones_like(ms_o))
    svB = torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o),
                      torch.zeros_like(ms_o))
    froot = torch.where(attop, bv_abs * ph, bv * ph * secfac)

    data_shape = torch.broadcast_shapes(focal.hw.shape, focal.md.shape[1:],
                                        (1,) * DATA_ND)

    def up(x):
        """Broadcast to [2(r0), data...], dropping the s0 axis."""
        return x.expand((2, x.shape[1]) + tuple(data_shape))[:, 0]

    froot = froot.expand((2, 2) + tuple(data_shape))
    return froot, up(bound), up(msA), up(md_o), up(svB)


def _rule_factors_tile(md, ms, exists, empty, dupf, cfg: ModelConfig,
                       dtype):
    """Probe-survival factors of the ignoreflag2 rules 2-3 on enum-leading
    operands: the tile form of ``hmm.probes.probe_rule_factors``.

    empty [7,N] int (1 = a genotype-less member); dupf [7,N] int (this
    variant's duplicate-pair sign slots) or None.
    Returns (F0 [2(r0),2(s0),N], [FPk [8(f),8(p),2(sk),N] for k])."""
    dev = md.device

    def tied(s):
        return (exists[s] & (empty[s] == 0) & (md[s, 0] == md[s, 1])
                & (ms[s, 0] == ms[s, 1]))

    def iota(shape, dim):
        return _iota(shape + (1,) * DATA_ND, dim, dev)

    one = torch.ones((), dtype=dtype, device=dev)
    ri, ti = iota((2, 1), 0), iota((1, 2), 1)
    F0 = torch.where(tied(0)[None, None], (ri ^ ti).to(dtype), one)
    if dupf is not None:
        F0 = F0 * torch.where(dupf[0][None, None] != 0,
                              1.0 - 2.0 * ri.to(dtype), one)
    fi, pi, si = iota((8, 1, 1), 0), iota((1, 8, 1), 1), iota((1, 1, 2), 2)
    FPs = []
    for k in range(2):
        xp = (fi & 1) ^ (pi & 1)
        ps = cfg.parent_slot(k)
        f = torch.where(tied(ps)[None, None, None], (xp ^ si).to(dtype), one)
        if dupf is not None:
            f = f * torch.where(dupf[ps][None, None, None] != 0,
                                1.0 - 2.0 * xp.to(dtype), one)
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            xg = ((fi >> (1 + j)) & 1) ^ ((pi >> (1 + j)) & 1)
            f = f * torch.where(tied(gs)[None, None, None], xg.to(dtype),
                                one)
            if dupf is not None:
                f = f * torch.where(dupf[gs][None, None, None] != 0,
                                    1.0 - 2.0 * xg.to(dtype), one)
        FPs.append(f)
    return F0, FPs


def stats_tile(md, ms, hw, exists, attop, f2ig, shig, fw_pre, bw,
               fw_pre_f, bw_f, total, cfg: ModelConfig, empty=None,
               dupf=None):
    """All update statistics for a batch of (marker, unit) pairs.

    md [7,2,N] int; ms [7,2,N]; hw [7,N]; exists/attop [7,N] bool;
    f2ig/shig [N] int; fw_pre/bw [8,8,2,2,2,N] (fp1,fp0,s2,s1,s0);
    fw_pre_f/bw_f [2,2,2,N]; total [N]; empty/dupf [7,N] int or None
    (the probe-dedup inputs: with ``empty`` the ignoreflag2 rule 2-3
    factors decorate froot and the masked parent blocks; the share
    tensors of the infprob statistics stay undecorated).
    Returns (b12 [7,2,N], accum [7,2,2,N], pair [2,2,N])."""
    dtype = hw.dtype
    dev = hw.device
    T = tuple(md.shape[2:])
    hap = cfg.haplotyping

    def slotL(s):
        return SlotL(md=md[s], ms=ms[s], hw=hw[s], exists=exists[s],
                     attop=attop[s])

    def zeros(*lead):
        return torch.zeros(lead + T, dtype=dtype, device=dev)

    def iota(shape, dim):
        return _iota(shape + (1,) * DATA_ND, dim, dev)

    focal = slotL(0)
    par = [slotL(cfg.parent_slot(k)) for k in range(2)]
    gps = [[slotL(cfg.grandparent_slot(k, j)) for j in range(2)]
           for k in range(2)]

    froot, vA, svA, vB, svB = root_block_L(focal, haplotyping=hap,
                                           dtype=dtype)
    pb = [parent_block_L(par[k], gps[k][0], gps[k][1],
                         vA if k == 0 else vB, svA if k == 0 else svB,
                         haplotyping=hap) for k in range(2)]

    # canonical-path masks V[k][p] and masked blocks
    pidx = torch.arange(8, device=dev).reshape((8,) + (1,) * DATA_ND)
    PBm = []
    for k in range(2):
        bits = (f2ig >> (1 + 3 * k)) & 7
        V = ((bits[None] & pidx) == 0).to(dtype)              # [8, *T]
        PBm.append(pb[k] * V[None, None, :, None])

    if empty is not None:
        F0, FPs = _rule_factors_tile(md, ms, exists, empty, dupf, cfg, dtype)
        froot = froot * F0
        PBm = [PBm[k] * FPs[k][None] for k in range(2)]

    # posterior weight W[b(fp1), a(fp0), v(s2), u(s1), t(s0)]
    sidx = iota((2, 1, 1), 0) * 4 + iota((1, 2, 1), 1) * 2 + \
        iota((1, 1, 2), 2)
    allowed = ((sidx & shig) == 0).to(dtype)                  # [2,2,2,*T]
    wexp = torch.exp(fw_pre_f + bw_f - total) * allowed
    W = fw_pre * bw * wexp[None, None]                        # [8,8,2,2,2,*T]

    # side collapses: T1[r,a,u,t] folds branch 1; T0[r,b,v,t] branch 0
    PBq = [PBm[k].sum(dim=2) for k in range(2)]               # [r,f,sk,*T]
    T1 = zeros(2, 8, 2, 2)
    T0 = zeros(2, 8, 2, 2)
    for b in range(8):
        for v in range(2):
            T1 = T1 + PBq[1][:, b, v][:, None, None, None] * W[b, :, v][None]
    for a in range(8):
        for u in range(2):
            T0 = T0 + PBq[0][:, a, u][:, None, None, None] * \
                W[:, a, :, u][None]

    # ---- haplo stats --------------------------------------------------
    pbs0 = PBm[0].sum(dim=2)                                  # [r,a,u,*T]
    F = zeros(2, 2)                                           # [r,t,*T]
    for a in range(8):
        for u in range(2):
            F = F + pbs0[:, a, u][:, None] * T1[:, a, u]
    fF = froot * F
    indf = iota((2, 1), 0) ^ iota((1, 2), 1)                  # focal j bit
    foc = torch.stack([(fF * (indf == j).to(dtype)).sum(dim=(0, 1))
                       for j in range(2)], dim=0)

    b12_list = [None] * cfg.numslots
    b12_list[0] = foc
    fi, pi, si = iota((8, 1, 1), 0), iota((1, 8, 1), 1), iota((1, 1, 2), 2)
    jbits = [(pi & 1) ^ (fi & 1) ^ si,
             ((pi >> 1) & 1) ^ ((fi >> 1) & 1),
             ((pi >> 2) & 1) ^ ((fi >> 2) & 1)]
    for k in range(2):
        Y = zeros(8, 8, 2)                                    # [f,p,s,*T]
        Tk = T1 if k == 0 else T0
        for r in range(2):
            for t in range(2):
                Y = Y + froot[r, t] * PBm[k][r] * Tk[r, :, :, t][:, None]
        for i, jb in enumerate(jbits):
            st = torch.stack([(Y * (jb == j).to(dtype)).sum(dim=(0, 1, 2))
                              for j in range(2)], dim=0)
            slot = cfg.parent_slot(k) if i == 0 else \
                cfg.grandparent_slot(k, i - 1)
            b12_list[slot] = st
    b12 = torch.stack(b12_list, dim=0)                        # [7, 2, *T]

    # ---- infprob stats ------------------------------------------------
    zero = zeros()
    acc_g = [[[zero, zero], [zero, zero]] for _ in range(cfg.numslots)]
    P0mv, P1mv = [], []
    ai, pi2 = iota((8, 1), 0), iota((1, 8), 1)
    for side in range(2):
        us = []
        for mv in (1, 2):
            iv = torch.full(T, mv, dtype=torch.int32, device=dev)
            fr_mv, vA_mv, svA_mv, _, _ = root_block_L(
                focal, haplotyping=hap, inval=iv, side=side, dtype=dtype)
            pbp = parent_block_L(par[side], gps[side][0], gps[side][1],
                                 vA_mv, svA_mv, haplotyping=hap)
            # U[r, a, p, t, u] = froot_mv[r, t] * pbp[r, a, p, u]
            us.append(fr_mv[:, None, None, :, None] *
                      pbp[:, :, :, None, :])
        den = us[0] + us[1]
        for mvi in range(2):
            sh = _safe_div(us[mvi], den)
            if side == 1:
                sh = torch.stack([sh[1], sh[0]], dim=0)   # r' = 1 - r
            Tk = T1 if side == 0 else T0
            PBk = PBm[side]
            X = zeros(2, 8, 8)                                # [r,a,p,*T]
            for t in range(2):
                for u in range(2):
                    ft = froot[:, t][:, None] * Tk[:, :, u, t]   # [r,a,*T]
                    X = X + ft[:, :, None] * PBk[:, :, :, u] * \
                        sh[:, :, :, t, u]
            nf = X.sum(dim=(1, 2))                            # [r,*T]
            acc_g[0][0][mvi] = acc_g[0][0][mvi] + nf[0 if side == 0 else 1]
            acc_g[0][1][mvi] = acc_g[0][1][mvi] + nf[1 if side == 0 else 0]
            Xr = X.sum(dim=0)                                 # [a,p,*T]
            ps = cfg.parent_slot(side)
            for w in range(2):
                acc_g[ps][w][mvi] = acc_g[ps][w][mvi] + \
                    (Xr * ((pi2 & 1) == w).to(dtype)).sum(dim=(0, 1))
                for j in range(2):
                    gs = cfg.grandparent_slot(side, j)
                    sel = ((ai & 1) == j) & (((pi2 >> (1 + j)) & 1) == w)
                    acc_g[gs][w][mvi] = acc_g[gs][w][mvi] + \
                        (Xr * sel.to(dtype)).sum(dim=(0, 1))

            # branch collapsed with its share, for the pair table
            P = zeros(2, 8, 2, 2)
            if side == 0:
                # P0[r,a,u,t] = sum_p PB0[r,a,p,u] * sh[r,a,p,t,u]
                for p in range(8):
                    P = P + PBk[:, :, p][:, :, :, None] * \
                        sh[:, :, p].transpose(2, 3)
                P0mv.append(P)
            else:
                # P1[r,b,t,v] = sum_q PB1[r,b,q,v] * sh[r,b,q,t,v]
                for q in range(8):
                    P = P + PBk[:, :, q][:, :, None] * sh[:, :, q]
                P1mv.append(P.transpose(2, 3))                # [r,b,v,t]

    # pair: fold each P1[mv1] against W once, then contract with P0[mv0]
    T1mv = []
    for j in range(2):
        T1j = zeros(2, 8, 2, 2)                               # [r,a,u,t]
        for b in range(8):
            for v in range(2):
                T1j = T1j + P1mv[j][:, b, v][:, None, None] * W[b, :, v][None]
        T1mv.append(T1j)
    pair_rows = []
    for i in range(2):
        row = []
        for j in range(2):
            acc = zeros()
            for r in range(2):
                for t in range(2):
                    acc = acc + froot[r, t] * (
                        P0mv[i][r, :, :, t] * T1mv[j][r, :, :, t]
                    ).sum(dim=(0, 1))
            row.append(acc)
        pair_rows.append(torch.stack(row, dim=0))
    pair = torch.stack(pair_rows, dim=0)                      # [mv0,mv1,*T]

    accum = torch.stack([torch.stack([torch.stack(wrow, dim=0)
                                      for wrow in slotrow], dim=0)
                         for slotrow in acc_g], dim=0)        # [7,2,2,*T]
    return b12, accum, pair


def stats_reference(st, fw_pre, bw, fw_pre_f, bw_f, total, B: int,
                    cfg: ModelConfig, max_pairs: int = 1 << 15, em=None,
                    df=None, rules: bool = False):
    """Plain PyTorch statistics from the v2 tensors.

    st: ops.scan.SlotTensors ([7,2,M,R] ... layouts); fw_pre/bw [M,512,R]
    (feature x = shift*64 + state); fw_pre_f/bw_f [M,8,R]; total [R];
    with ``rules`` the probe-rule form: em [7,R] the empty-slot flags and
    df [7,R] one variant's dup-flip column.
    Runs stats_tile over marker slabs of at most ``max_pairs`` pairs.
    Returns (b12 [B,M,7,2], accum [B,M,7,2,2], pair [B,M,2,2])."""
    M, X, R = fw_pre.shape
    step = max(1, max_pairs // B)
    outs = []
    for m0 in range(0, M, step):
        ms_ = slice(m0, min(M, m0 + step))
        K = ms_.stop - m0
        N = K * B

        def flat_m(x, lead):        # [lead..., K, R] -> [lead..., K*B]
            return x[..., ms_, :B].reshape(lead + (N,))

        def flat_b(x, lead):        # [lead..., R] -> broadcast over K
            return x[..., :B].unsqueeze(-2).expand(
                lead + (K, B)).reshape(lead + (N,))

        def sweep(x, lead):         # [M, F, R] -> [F..., K*B]
            x = x[ms_, :, :B].permute(1, 0, 2).reshape((-1, N))
            return x.reshape(lead + (N,))

        # x = ((s2*2 + s1)*2 + s0)*64 + fp1*8 + fp0 -> [fp1,fp0,s2,s1,s0]
        fwp = sweep(fw_pre, (2, 2, 2, 8, 8)).permute(3, 4, 0, 1, 2, 5)
        bwt = sweep(bw, (2, 2, 2, 8, 8)).permute(3, 4, 0, 1, 2, 5)
        b12, acc, pair = stats_tile(
            flat_m(st.md, (7, 2)), flat_m(st.ms, (7, 2)),
            flat_m(st.hw, (7,)), flat_b(st.ex, (7,)) != 0,
            flat_b(st.at, (7,)) != 0, flat_b(st.f2, ()), flat_b(st.sh, ()),
            fwp, bwt, sweep(fw_pre_f, (2, 2, 2)), sweep(bw_f, (2, 2, 2)),
            flat_b(total, ()), cfg,
            empty=flat_b(em, (7,)) if rules else None,
            dupf=flat_b(df, (7,)) if rules else None)

        def back(x, shape):         # [shape..., K*B] -> [B, K, shape...]
            nl = len(shape)
            x = x.reshape(shape + (K, B))
            return x.permute((nl + 1, nl) + tuple(range(nl)))

        outs.append((back(b12, (7, 2)), back(acc, (7, 2, 2)),
                     back(pair, (2, 2))))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def _variant_mean(parts):
    """The probe-rule variants' statistics averaged, as the JAX package
    sums them: sum(parts) / nv."""
    nv = len(parts)
    return tuple(sum(p) / nv for p in zip(*parts))


def _check_v2(st, fw_pre, bw, fw_pre_f, bw_f, total, B: int,
              cfg: ModelConfig):
    M, X, R = fw_pre.shape
    _build.check_config(cfg)
    dt = fw_pre.dtype
    _build.check(fw_pre, dt, (M, 512, R), "fw_pre")
    _build.check(bw, dt, (M, 512, R), "bw")
    _build.check(fw_pre_f, dt, (M, 8, R), "fw_pre_f")
    _build.check(bw_f, dt, (M, 8, R), "bw_f")
    _build.check(total, dt, (R,), "total")
    _build.check(st.md, torch.int32, (7, 2, M, R), "md")
    _build.check(st.ms, dt, (7, 2, M, R), "ms")
    _build.check(st.hw, dt, (7, M, R), "hw")
    for name in ("ex", "at"):
        _build.check(getattr(st, name), torch.int32, (7, R), name)
    for name in ("f2", "sh"):
        _build.check(getattr(st, name), torch.int32, (R,), name)
    if not 0 < B <= R:
        raise ValueError(f"B={B} outside (0, R={R}]")
    kw = dict(dtype=dt, device=fw_pre.device)
    return (torch.empty((B, M, 7, 2), **kw),
            torch.empty((B, M, 7, 2, 2), **kw),
            torch.empty((B, M, 2, 2), **kw))


def stats(st, fw_pre, bw, fw_pre_f, bw_f, total, B: int, cfg: ModelConfig,
          probe_rules: bool = False, n_variants: int = 1):
    """Statistics from the v2 tensors: (b12 [B,M,7,2], accum [B,M,7,2,2],
    pair [B,M,2,2]).  CPU tensors run ``stats_reference``; CUDA tensors
    launch the kernel of csrc/stats.cu.  ``probe_rules``: the probe-rule
    form (``stats_rules``), once per dup-flip variant of the first
    ``n_variants``, averaged."""
    args = (fw_pre, bw, fw_pre_f, bw_f, total, B, cfg)
    if probe_rules:
        return _variant_mean([stats_rules(st, v, *args)
                              for v in range(n_variants)])
    if fw_pre.device.type == "cpu":
        return stats_reference(st, *args)
    M, _, R = fw_pre.shape
    b12, accum, pair = _check_v2(st, *args)
    _build.launch("stats", fw_pre.dtype, st.md, st.ms, st.hw, st.ex, st.at,
                  st.f2, st.sh, fw_pre, bw, fw_pre_f, bw_f, total, b12, accum,
                  pair, M, R, B)
    stats.launches += 1
    return b12, accum, pair


stats.launches = 0


def stats_rules(st, variant: int, fw_pre, bw, fw_pre_f, bw_f, total, B: int,
                cfg: ModelConfig):
    """The probe-rule form of ``stats`` for dup-flip variant ``variant``
    (st.em, st.df[variant]): ``stats_reference(rules=True)`` on the CPU,
    the rules entry of csrc/stats.cu on the card."""
    args = (fw_pre, bw, fw_pre_f, bw_f, total, B, cfg)
    df = st.df[variant]
    if fw_pre.device.type == "cpu":
        return stats_reference(st, *args, em=st.em, df=df, rules=True)
    M, _, R = fw_pre.shape
    b12, accum, pair = _check_v2(st, *args)
    _build.check(st.em, torch.int32, (7, R), "em")
    _build.check(df, torch.int32, (7, R), "df")
    _build.launch("stats_rules", fw_pre.dtype, st.md, st.ms, st.hw, st.ex,
                  st.at, st.em, df, st.f2, st.sh, fw_pre, bw, fw_pre_f, bw_f,
                  total, b12, accum, pair, M, R, B)
    stats_rules.launches += 1
    return b12, accum, pair


stats_rules.launches = 0


def stats_bmns_reference(fb, fw_pre, bw, fw_pre_f, bw_f, total,
                         cfg: ModelConfig, max_pairs: int = 1 << 15,
                         em=None, df=None, rules: bool = False):
    """Plain PyTorch statistics from the [B, M, NS, S] sweeps.

    fb: torch FamilyBatch ([B, 7, M, ...]); fw_pre/bw [B, M, NS, S] with
    the feature index shift-major (x = ns*64 + g); fw_pre_f/bw_f
    [B, M, NS]; total [B]; with ``rules`` the probe-rule form: em [B, 7]
    the empty-slot flags and df [B, 7] one variant's dup-flip column.
    Runs stats_tile over slabs of whole units of at most ``max_pairs``
    (unit, marker) pairs.
    Returns (b12 [B,M,7,2], accum [B,M,7,2,2], pair [B,M,2,2])."""
    B, M = fw_pre.shape[:2]
    dt = fw_pre.dtype
    step = max(1, max_pairs // M)
    outs = []
    for b0 in range(0, B, step):
        bs = slice(b0, min(B, b0 + step))
        K = bs.stop - b0
        N = K * M

        def per_unit(x):            # [K] -> [K*M]
            return x[bs, None].expand(K, M).reshape(N)

        def slot_unit(x):           # [K, 7] -> [7, K*M]
            return x[bs].T[:, :, None].expand(7, K, M).reshape(7, N)

        def sweep(x):               # [K, M, 512] -> [fp1,fp0,s2,s1,s0,N]
            return x[bs].reshape(K, M, 2, 2, 2, 8, 8).permute(
                5, 6, 2, 3, 4, 0, 1).reshape(8, 8, 2, 2, 2, N)

        def factors(x):             # [K, M, 8] -> [s2,s1,s0,N]
            return x[bs].reshape(K, M, 2, 2, 2).permute(
                2, 3, 4, 0, 1).reshape(2, 2, 2, N)

        b12, acc, pair = stats_tile(
            fb.md[bs].permute(1, 3, 0, 2).reshape(7, 2, N),
            fb.ms[bs].to(dt).permute(1, 3, 0, 2).reshape(7, 2, N),
            fb.hw[bs].to(dt).permute(1, 0, 2).reshape(7, N),
            slot_unit(fb.exists), slot_unit(fb.attop),
            per_unit(fb.flag2ignore), per_unit(fb.shiftignore),
            sweep(fw_pre), sweep(bw), factors(fw_pre_f), factors(bw_f),
            per_unit(total), cfg,
            empty=slot_unit(em.to(torch.int32)) if rules else None,
            dupf=slot_unit(df.to(torch.int32)) if rules else None)

        def back(x, shape):         # [shape..., K*M] -> [K, M, shape...]
            nl = len(shape)
            x = x.reshape(shape + (K, M))
            return x.permute((nl, nl + 1) + tuple(range(nl)))

        outs.append((back(b12, (7, 2)), back(acc, (7, 2, 2)),
                     back(pair, (2, 2))))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _bmns_operands(fb, fw_pre, bw, fw_pre_f, bw_f, total, cfg: ModelConfig):
    """The [B, M, NS, S] entry's checked operands and empty outputs."""
    _build.check_config(cfg)
    B, M = fw_pre.shape[:2]
    dt = fw_pre.dtype
    i32 = torch.int32
    md = fb.md.to(i32).contiguous()
    ms = fb.ms.to(dt).contiguous()
    hw = fb.hw.to(dt).contiguous()
    ex, at = (x.to(i32).contiguous() for x in (fb.exists, fb.attop))
    f2, sh = (x.to(i32).contiguous() for x in (fb.flag2ignore,
                                                fb.shiftignore))
    _build.check(fw_pre, dt, (B, M, 8, 64), "fw_pre")
    _build.check(bw, dt, (B, M, 8, 64), "bw")
    _build.check(fw_pre_f, dt, (B, M, 8), "fw_pre_f")
    _build.check(bw_f, dt, (B, M, 8), "bw_f")
    _build.check(total, dt, (B,), "total")
    _build.check(md, i32, (B, 7, M, 2), "md")
    _build.check(ms, dt, (B, 7, M, 2), "ms")
    _build.check(hw, dt, (B, 7, M), "hw")
    _build.check(ex, i32, (B, 7), "exists")
    _build.check(at, i32, (B, 7), "attop")
    _build.check(f2, i32, (B,), "flag2ignore")
    _build.check(sh, i32, (B,), "shiftignore")
    kw = dict(dtype=dt, device=fw_pre.device)
    outs = (torch.empty((B, M, 7, 2), **kw),
            torch.empty((B, M, 7, 2, 2), **kw),
            torch.empty((B, M, 2, 2), **kw))
    return (md, ms, hw, ex, at), (f2, sh), outs


def stats_pallas(fb, fw_pre, bw, fw_pre_f, bw_f, total, cfg: ModelConfig,
                 probe_rules: bool = False, n_variants: int = 1):
    """Statistics from the [B, M, NS, S] sweeps: (b12 [B,M,7,2], accum
    [B,M,7,2,2], pair [B,M,2,2]).  CPU tensors run
    ``stats_bmns_reference``; CUDA tensors launch the [B, M, NS, S] entry
    of csrc/stats.cu.  ``probe_rules``: the probe-rule form
    (``stats_bmns_rules``), once per dup-flip variant of the first
    ``n_variants``, averaged."""
    args = (fw_pre, bw, fw_pre_f, bw_f, total, cfg)
    if probe_rules:
        return _variant_mean([stats_bmns_rules(fb, v, *args)
                              for v in range(n_variants)])
    if fw_pre.device.type == "cpu":
        return stats_bmns_reference(fb, *args)
    slots, flags, outs = _bmns_operands(fb, *args)
    B, M = fw_pre.shape[:2]
    _build.launch("stats_bmns", fw_pre.dtype, *slots, *flags, fw_pre, bw,
                  fw_pre_f, bw_f, total, *outs, M, B)
    stats_pallas.launches += 1
    return outs


stats_pallas.launches = 0


def stats_bmns_rules(fb, variant: int, fw_pre, bw, fw_pre_f, bw_f, total,
                     cfg: ModelConfig):
    """The probe-rule form of ``stats_pallas`` for dup-flip variant
    ``variant`` (fb.emptyslot, fb.dup_flip[:, variant]):
    ``stats_bmns_reference(rules=True)`` on the CPU, the [B, M, NS, S]
    rules entry of csrc/stats.cu on the card."""
    args = (fw_pre, bw, fw_pre_f, bw_f, total, cfg)
    em, df = fb.emptyslot, fb.dup_flip[:, variant]
    if fw_pre.device.type == "cpu":
        return stats_bmns_reference(fb, *args, em=em, df=df, rules=True)
    slots, flags, outs = _bmns_operands(fb, *args)
    B, M = fw_pre.shape[:2]
    em, df = (x.to(torch.int32).contiguous() for x in (em, df))
    _build.check(em, torch.int32, (B, 7), "emptyslot")
    _build.check(df, torch.int32, (B, 7), "dup_flip")
    _build.launch("stats_bmns_rules", fw_pre.dtype, *slots, em, df, *flags,
                  fw_pre, bw, fw_pre_f, bw_f, total, *outs, M, B)
    stats_bmns_rules.launches += 1
    return outs


stats_bmns_rules.launches = 0


def stats_ext_reference(fb, fw_pre, bw, fw_pre_f, bw_f, total,
                        cfg: ModelConfig, n_variants: int):
    """The plain twin of ``stats_ext`` on any device: each extension
    value's blocks from the family batch (``engine_ext.ext_block_list``),
    the posterior weights W, and ``engine_ext.ext_statistics_per_v``.
    Returns (b12 [B, M, V, 7, 2], accum [B, M, 7, 2, 2], pair
    [B, M, 2, 2]): b12 per extension value before its update mask, accum
    and pair summed over the values, each value's statistics the
    average of its ``n_variants`` probe-rule variants."""
    from ..engine_ext import (ExtFBResult, ext_block_list,
                              ext_statistics_per_v, posterior_weight_ext)
    blocks_v, _, ovs = ext_block_list(fb, cfg, dtype=fw_pre.dtype)
    fbres = ExtFBResult(fw_pre, None, bw, fw_pre_f, None, bw_f)
    W = posterior_weight_ext(fbres, total, fb.shiftignore)
    b12, inf, pair = [], 0.0, 0.0
    for b12_v, inf_v, pair_v in ext_statistics_per_v(
            W, blocks_v, ovs, fb, cfg, n_variants):
        b12.append(b12_v)
        inf = inf + inf_v
        pair = pair + pair_v
    return torch.stack(b12, dim=2), inf, pair


def stats_ext(fb, fw_pre, bw, fw_pre_f, bw_f, total, cfg: ModelConfig,
              n_variants: int):
    """The extended spaces' statistics (kernel #13, the ``cnf_stats_ext_*``
    entry of csrc/stats.cu): one launch for every (unit, marker) pair,
    extension value and probe-rule variant, the blocks of each value
    rebuilt from the family batch inside the kernel.  fw_pre, bw
    [B, M, V, 8, 64], fw_pre_f, bw_f [B, M, 8], total [B]; fb's fields
    [B, 7, M, ...] with ``dup_flip`` [B, NV, 7] (NV >= n_variants; None
    is one variant without flips).  Returns what ``stats_ext_reference``
    returns.  CUDA tensors only: every argument's type and shape is
    checked before any device, and all of them before the launch; a
    refused argument or a failed launch raises."""
    V = _build.check_ext_config(cfg)
    B, M = fw_pre.shape[:2]
    dt = fw_pre.dtype
    i32 = torch.int32
    if not isinstance(n_variants, int) or n_variants < 1:
        raise ValueError(f"n_variants={n_variants}: a positive int")
    df = fb.dup_flip
    if df is None:
        df = torch.zeros((B, 1, 7), dtype=torch.bool, device=fw_pre.device)
    if df.ndim != 3 or df.shape[1] < n_variants:
        raise ValueError(f"dup_flip: shape {tuple(df.shape)} holds fewer "
                         f"than {n_variants} variants")
    em = fb.emptyslot
    if em is None:
        raise ValueError("emptyslot: required by the probe rules")
    md, ms, hw, ex, at, em, df, f2, sh = (
        x.to(t).contiguous() for x, t in (
            (fb.md, i32), (fb.ms, dt), (fb.hw, dt), (fb.exists, i32),
            (fb.attop, i32), (em, i32), (df, i32), (fb.flag2ignore, i32),
            (fb.shiftignore, i32)))
    NV = df.shape[1]
    specs = ((fw_pre, dt, (B, M, V, 8, 64), "fw_pre"),
             (bw, dt, (B, M, V, 8, 64), "bw"),
             (fw_pre_f, dt, (B, M, 8), "fw_pre_f"),
             (bw_f, dt, (B, M, 8), "bw_f"), (total, dt, (B,), "total"),
             (md, i32, (B, 7, M, 2), "md"), (ms, dt, (B, 7, M, 2), "ms"),
             (hw, dt, (B, 7, M), "hw"), (ex, i32, (B, 7), "exists"),
             (at, i32, (B, 7), "attop"), (em, i32, (B, 7), "emptyslot"),
             (df, i32, (B, NV, 7), "dup_flip"),
             (f2, i32, (B,), "flag2ignore"), (sh, i32, (B,), "shiftignore"))
    for spec in specs:
        _build.check_form(*spec)
    for spec in specs:
        _build.check(*spec)
    kw = dict(dtype=dt, device=fw_pre.device)
    outs = (torch.empty((B, M, V, 7, 2), **kw),
            torch.empty((B, M, 7, 2, 2), **kw),
            torch.empty((B, M, 2, 2), **kw))
    if B and M:
        _build.launch("stats_ext", dt, md, ms, hw, ex, at, em, df, f2, sh,
                      fw_pre, bw, fw_pre_f, bw_f, total, *outs, M, B, V,
                      n_variants, NV, int(cfg.selfing))
        stats_ext.launches += 1
    return outs


stats_ext.launches = 0
