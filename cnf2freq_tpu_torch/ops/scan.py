"""Feature-leading chromosome scan: the main-path pipeline.

Port of ``cnf2freq_tpu/ops/scan_v2.py``:

    slot tensors [7, ..., M, R]    (R = batch padded to a multiple of 32)
      | emission: blocks rebuilt per (m, r) from ~50 slot scalars
      v
    e  [M, X=512, R]               (x = shift*64 + state, batch last)
      | fb_sweeps: forward and backward carries along the markers
      v
    fw_pre / fw_post / bw [M, X, R], factors [M, NS, R]
      | stats_from_v2: posterior update statistics per (m, unit)
      | turn_weights: weighted xor-correlation at the 128 turn offsets
      v
    b12 / infprob accum / pair / turn weights

Each stage with a TPU kernel has a plain PyTorch version here
(``emission_reference``, ``fb_scan_v2`` / ``fb_scan_v2_block``,
``fb_carry_fwd`` / ``fb_carry_bwd``, ``turn_weights_v2``;
``ops.stats.stats_reference``) and a wrapper (``emission``,
``fb_sweeps``, ``fb_carry``, ``turn_weights``, ``ops.stats.stats``) that
runs the plain version for a CPU tensor and launches the CUDA kernel for a
CUDA tensor.

The marker-blocked scan (``blocked_carries``, ``blocked_block_pass``,
``blocked_scan_chunk``) holds one block of [K, X, R] tensors at a time:
pass A runs the forward sweep carry-only over each block and keeps the
carries at the block boundaries, pass B does the same backward, and pass C
recomputes each block's sweeps from its two boundary carries, then its
statistics and turn weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import MINFACTOR, ModelConfig, RuntimeParams

from .. import _build
from ..hmm.family import FamilyBatch
from ..hmm.transition import fwht, interval_recomb, transition_eigenvalues
from ..utils.transfer import constant
from . import stats as stats_mod

R_QUANTUM = 32   # batch padding: one warp of consecutive units


class SlotTensors(NamedTuple):
    md: torch.Tensor    # [7, 2, M, R] int32
    ms: torch.Tensor    # [7, 2, M, R]
    hw: torch.Tensor    # [7, M, R]
    ex: torch.Tensor    # [7, R] int32
    at: torch.Tensor    # [7, R] int32
    f2: torch.Tensor    # [R] int32
    sh: torch.Tensor    # [R] int32
    em: torch.Tensor = None   # [7, R] int32 empty-slot flags
    df: torch.Tensor = None   # [NV, 7, R] int32 dup-flip variants

    @property
    def R(self) -> int:
        return self.f2.shape[0]


def prep_slots(fb: FamilyBatch, dtype) -> SlotTensors:
    """Torch FamilyBatch [B, 7, M, ...] -> feature-leading slot tensors
    with the batch padded to R (padded units: vacant, all-unknown, no
    empty slot, no dup flip)."""
    B, _, M, _ = fb.md.shape
    R = -(-B // R_QUANTUM) * R_QUANTUM

    def padb(x):
        if R == B:
            return x
        pad = torch.zeros((R - B,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad], dim=0)

    i32 = torch.int32
    return SlotTensors(
        md=padb(fb.md.to(i32)).permute(1, 3, 2, 0).contiguous(),
        ms=padb(fb.ms.to(dtype)).permute(1, 3, 2, 0).contiguous(),
        hw=padb(fb.hw.to(dtype)).permute(1, 2, 0).contiguous(),
        ex=padb(fb.exists.to(i32)).T.contiguous(),
        at=padb(fb.attop.to(i32)).T.contiguous(),
        f2=padb(fb.flag2ignore.to(i32)).contiguous(),
        sh=padb(fb.shiftignore.to(i32)).contiguous(),
        em=padb(fb.emptyslot.to(i32)).T.contiguous(),
        df=padb(fb.dup_flip.to(i32)).permute(1, 2, 0).contiguous())


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------
def emission_reference(st: SlotTensors, M: int, cfg: ModelConfig):
    """Plain e [M, 512, R]: assemble_e_all semantics on the enum-leading
    blocks of ops.stats, over all (m, r) pairs at once."""
    R = st.R
    N = M * R
    dtype = st.ms.dtype
    ex = st.ex[:, None, :].expand(7, M, R).reshape(7, N) != 0
    at = st.at[:, None, :].expand(7, M, R).reshape(7, N) != 0
    md = st.md.reshape(7, 2, N)
    ms = st.ms.reshape(7, 2, N)
    hw = st.hw.reshape(7, N)

    def slotL(s):
        return stats_mod.SlotL(md=md[s], ms=ms[s], hw=hw[s], exists=ex[s],
                               attop=at[s])

    focal = slotL(0)
    hap = cfg.haplotyping
    froot, vA, svA, vB, svB = stats_mod.root_block_L(focal, haplotyping=hap,
                                                     dtype=dtype)
    pbs = []
    for k in range(2):
        par = slotL(cfg.parent_slot(k))
        gps = [slotL(cfg.grandparent_slot(k, j)) for j in range(2)]
        pb = stats_mod.parent_block_L(par, gps[0], gps[1],
                                      vA if k == 0 else vB,
                                      svA if k == 0 else svB,
                                      haplotyping=hap)
        # no flag2ignore mask: the canonical-path weights already zero
        # every path bit a vacant or founder slot cannot consume
        pbs.append(pb.sum(dim=2))                        # [r, f, sk, N]
    planes = []
    for v in range(2):
        for u in range(2):
            for t in range(2):
                acc = torch.zeros((8, 8, N), dtype=dtype, device=md.device)
                for r in range(2):
                    acc = acc + (froot[r, t] * pbs[0][r][:, u])[None, :] * \
                        pbs[1][r][:, v][:, None]
                planes.append(acc)
    e = torch.stack(planes, dim=0).reshape(512, M, R)
    # focal top: the root term alone
    tops = froot.sum(dim=0)                              # [t, N]
    tops_e = tops.reshape(2, M, R).repeat(4, 1, 1)[:, None, None].expand(
        8, 8, 8, M, R).reshape(512, M, R)
    e = torch.where(at[0].reshape(M, R)[None], tops_e, e)
    return e.permute(1, 0, 2).contiguous()


def emission(st: SlotTensors, M: int, cfg: ModelConfig) -> torch.Tensor:
    """e [M, 512, R]: plain version on the CPU, csrc/emission.cu on the
    card (replaces scan_v2._e_kernel)."""
    if st.ms.device.type == "cpu":
        return emission_reference(st, M, cfg)
    _build.check_config(cfg)
    R, dt = st.R, st.ms.dtype
    _build.check(st.md, torch.int32, (7, 2, M, R), "md")
    _build.check(st.ms, dt, (7, 2, M, R), "ms")
    _build.check(st.hw, dt, (7, M, R), "hw")
    _build.check(st.ex, torch.int32, (7, R), "ex")
    _build.check(st.at, torch.int32, (7, R), "at")
    e = torch.empty((M, 512, R), dtype=dt, device=st.ms.device)
    _build.launch("emission", dt, st.md, st.ms, st.hw, st.ex, st.at, e, M, R)
    emission.launches += 1
    return e


emission.launches = 0


# ---------------------------------------------------------------------------
# Forward-backward sweeps
# ---------------------------------------------------------------------------
class FBv2(NamedTuple):
    fw_pre: torch.Tensor    # [M, X, R]
    fw_post: torch.Tensor   # [M, X, R]
    bw: torch.Tensor        # [M, X, R]
    fw_pre_f: torch.Tensor  # [M, NS, R]
    fw_post_f: torch.Tensor
    bw_f: torch.Tensor


def sweep_eigenvalues(dists: torch.Tensor, cfg: ModelConfig,
                      params: RuntimeParams, dtype, ratemat=None):
    """lam_pad [M, S]: row j = the interval leaving marker j, last row
    ones (identity)."""
    r = interval_recomb(cfg, params, dists, ratemat=ratemat)
    lam = transition_eigenvalues(cfg, r).to(dtype)
    return torch.cat([lam, torch.ones((1, cfg.numtypes), dtype=dtype,
                                      device=lam.device)], dim=0)


def _emit_norm_v2(p, e, logf, NS, S):
    """p, e: [X, R]; logf [NS, R]: adjustprobs semantics."""
    p = torch.where(p < torch.tensor(1e-300, dtype=p.dtype), 0.0, p)
    pe = (p * e).reshape(NS, S, -1)
    s = pe.sum(dim=1, keepdim=True)                      # [NS, 1, R]
    ok = s > 0
    pn = torch.where(ok, pe / torch.where(ok, s, 1.0), 0.0)
    logf = torch.where(ok[:, 0], logf + torch.log(torch.where(ok[:, 0],
                                                              s[:, 0], 1.0)),
                       MINFACTOR)
    return pn.reshape(p.shape), logf


def _transition_v2(p, lam_row, NS, S):
    """p [X, R] -> H diag(lam) H p / S per shift block (butterflies)."""
    ph = fwht(p.reshape(NS, S, -1), 1) * lam_row[None, :, None]
    return (fwht(ph, 1) / S).reshape(p.shape)


def sweep_seeds(X: int, R: int, cfg: ModelConfig, dtype, device,
                backward: bool = False):
    """The whole-chromosome carry seeds (p [X, R], f [NS, R]): evengen
    forward, ones backward, zero log-factors."""
    kw = dict(dtype=dtype, device=device)
    p = torch.full((X, R), 1.0 if backward else cfg.evengen, **kw)
    return p, torch.zeros((cfg.numshifts, R), **kw)


def fb_carry_fwd(e: torch.Tensor, lam_pad: torch.Tensor, p0, f0,
                 cfg: ModelConfig):
    """Plain carry-only forward sweep over one block: e [K, X, R],
    lam_pad [K, S] (row j = the interval leaving marker j; the last row
    crosses the block boundary).  Returns the pre-emission carry (p, f)
    entering the next block."""
    S, NS = cfg.numtypes, cfg.numshifts
    p, f = p0, f0
    for m in range(e.shape[0]):
        p, f = _emit_norm_v2(p, e[m], f, NS, S)
        p = _transition_v2(p, lam_pad[m], NS, S)
    return p, f


def fb_carry_bwd(e: torch.Tensor, lam_pad: torch.Tensor, lam_below, bT, bfT,
                 cfg: ModelConfig):
    """Plain carry-only backward sweep over one block: from the carry at
    the block's last marker (bT = bw[last], bfT) consume markers K-1..0;
    the step at marker 0 crosses the boundary below through lam_below
    [S].  Returns bw at the previous block's last marker."""
    S, NS = cfg.numtypes, cfg.numshifts
    p, f = bT, bfT
    for m in range(e.shape[0] - 1, -1, -1):
        p, f = _emit_norm_v2(p, e[m], f, NS, S)
        p = _transition_v2(p, lam_pad[m - 1] if m > 0 else lam_below, NS, S)
    return p, f


def fb_scan_v2_block(e: torch.Tensor, lam_pad: torch.Tensor, p0, f0, bT,
                     bfT, cfg: ModelConfig) -> FBv2:
    """Plain sweeps over e [K, X, R] from boundary carries: the forward
    from (p0, f0), the backward from (bT, bfT) at the last marker.  With
    the seeds of ``sweep_seeds`` and the whole chromosome's lam_pad this
    is the whole sweep; with a block's carries it is exactly that sweep's
    slice of the block."""
    K = e.shape[0]
    S, NS = cfg.numtypes, cfg.numshifts
    p, f = p0, f0
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(K):
        fw_pre.append(p)
        fw_pre_f.append(f)
        p, f = _emit_norm_v2(p, e[m], f, NS, S)
        fw_post.append(p)
        fw_post_f.append(f)
        p = _transition_v2(p, lam_pad[m], NS, S)

    p, f = bT, bfT
    bw, bw_f = [None] * K, [None] * K
    for m in range(K - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            p, f = _emit_norm_v2(p, e[m], f, NS, S)
            p = _transition_v2(p, lam_pad[m - 1], NS, S)
    st = torch.stack
    return FBv2(fw_pre=st(fw_pre), fw_post=st(fw_post), bw=st(bw),
                fw_pre_f=st(fw_pre_f), fw_post_f=st(fw_post_f),
                bw_f=st(bw_f))


def fb_scan_v2(e: torch.Tensor, dists: torch.Tensor, cfg: ModelConfig,
               params: RuntimeParams, ratemat=None) -> FBv2:
    """Plain sweeps over a whole chromosome's e [M, X, R] (a loop over
    markers)."""
    M, X, R = e.shape
    lam_pad = sweep_eigenvalues(dists, cfg, params, e.dtype, ratemat)
    return fb_scan_v2_block(
        e, lam_pad, *sweep_seeds(X, R, cfg, e.dtype, e.device),
        *sweep_seeds(X, R, cfg, e.dtype, e.device, backward=True), cfg)


def _check_carry(carry, X: int, R: int, dt, name: str):
    _build.check(carry[0], dt, (X, R), name + "[0]")
    _build.check(carry[1], dt, (8, R), name + "[1]")


def fb_sweeps(e: torch.Tensor, dists: Optional[torch.Tensor],
              cfg: ModelConfig, params: Optional[RuntimeParams],
              ratemat=None, lam_pad=None, init_fwd=None,
              init_bwd=None) -> FBv2:
    """Both sweeps: plain on the CPU, csrc/fb_sweep.cu on the card
    (replaces scan_v2._fbv2_fwd_kernel / _fbv2_bwd_kernel).  As
    ``fb_sweeps_v2_pallas``: ``lam_pad`` [M, S] supplies the eigenvalue
    rows (else they come from ``dists``), ``init_fwd`` = (p0 [X, R],
    f0 [NS, R]) seeds the forward carry and ``init_bwd`` = (bT, bfT) the
    backward carry at the last marker; the defaults give the
    whole-chromosome sweep."""
    M, X, R = e.shape
    dt = e.dtype
    if lam_pad is None:
        lam_pad = sweep_eigenvalues(dists, cfg, params, dt, ratemat)
    if e.device.type == "cpu":
        fwd = init_fwd or sweep_seeds(X, R, cfg, dt, e.device)
        bwd = init_bwd or sweep_seeds(X, R, cfg, dt, e.device, backward=True)
        return fb_scan_v2_block(e, lam_pad.to(dt), *fwd, *bwd, cfg)
    _build.check_config(cfg)
    _build.check(e, dt, (M, 512, R), "e")
    _build.check(lam_pad, dt, (M, 64), "lam_pad")
    for carry, name in ((init_fwd, "init_fwd"), (init_bwd, "init_bwd")):
        if carry is not None:
            _check_carry(carry, X, R, dt, name)
    p0, f0 = init_fwd or (None, None)
    bT, bfT = init_bwd or (None, None)
    kw = dict(dtype=dt, device=e.device)
    out = FBv2(*(torch.empty((M, n, R), **kw)
                 for n in (512, 512, 512, 8, 8, 8)))
    _build.launch("fb_sweep", dt, e, lam_pad, float(cfg.evengen), p0, f0, bT,
                  bfT, out.fw_pre, out.fw_post, out.bw, out.fw_pre_f,
                  out.fw_post_f, out.bw_f, M, R)
    fb_sweeps.launches += 1
    return out


fb_sweeps.launches = 0


def fb_carry(e: torch.Tensor, lam_pad: torch.Tensor, cfg: ModelConfig,
             init=None, backward: bool = False, lam_below=None):
    """Carry-only sweep over one block (passes A and B of the blocked
    scan): ``fb_carry_fwd`` / ``fb_carry_bwd`` on the CPU, the carry-only
    entry of csrc/fb_sweep.cu on the card, which stores no [K, X, R]
    tensor.  ``init`` = (p, f) entering the block (None: the
    whole-chromosome seed); ``lam_below`` [S] is the backward step's
    interval below the block (None: identity).  Returns the outgoing
    (p [X, R], f [NS, R])."""
    K, X, R = e.shape
    dt = e.dtype
    if lam_below is None and backward:
        lam_below = torch.ones(cfg.numtypes, dtype=dt, device=e.device)
    if e.device.type == "cpu":
        p, f = init or sweep_seeds(X, R, cfg, dt, e.device, backward)
        if backward:
            return fb_carry_bwd(e, lam_pad, lam_below, p, f, cfg)
        return fb_carry_fwd(e, lam_pad, p, f, cfg)
    _build.check_config(cfg)
    _build.check(e, dt, (K, 512, R), "e")
    _build.check(lam_pad, dt, (K, 64), "lam_pad")
    if backward:
        _build.check(lam_below, dt, (64,), "lam_below")
    if init is not None:
        _check_carry(init, X, R, dt, "init")
    p_in, f_in = init or (None, None)
    p = torch.empty((512, R), dtype=dt, device=e.device)
    f = torch.empty((8, R), dtype=dt, device=e.device)
    _build.launch("fb_carry", dt, e, lam_pad, lam_below, float(cfg.evengen),
                  p_in, f_in, p, f, int(backward), K, R)
    fb_carry.launches += 1
    return p, f


fb_carry.launches = 0


def loglik_from_factors(f: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """total [R] from final post-emission factors f [NS, R]."""
    NS, R = f.shape
    allowed = (torch.arange(NS, device=f.device)[:, None] & sh[None, :]) == 0
    f = torch.where(allowed, f, MINFACTOR)
    fmax = f.max(dim=0).values
    return fmax + torch.log(torch.where(allowed, torch.exp(f - fmax[None]),
                                        0.0).sum(dim=0))


def combined_loglik_v2(fb2: FBv2, sh: torch.Tensor) -> torch.Tensor:
    return loglik_from_factors(fb2.fw_post_f[-1], sh)


# ---------------------------------------------------------------------------
# Turn weights
# ---------------------------------------------------------------------------
def turn_offsets(cfg: ModelConfig) -> np.ndarray:
    """Feature index of each turn: turn_shift_flip(t)*S + (t & mask)."""
    return np.array([cfg.turn_shift_flip(t) * cfg.numtypes +
                     (t & cfg.turn_state_mask)
                     for t in range(cfg.numturns)], dtype=np.int32)


def turn_weights_v2(fb2: FBv2, sh: torch.Tensor, descendants: torch.Tensor,
                    cfg: ModelConfig, B: int) -> torch.Tensor:
    """Plain [B, M, T] clause weights (turn_weights_v2 of scan_v2)."""
    M, X, R = fb2.fw_post.shape
    S, NS = cfg.numtypes, cfg.numshifts
    dtype = fb2.fw_post.dtype
    allowed = (torch.arange(NS, device=sh.device)[:, None] & sh[None]) == 0
    ff = torch.where(allowed[None], fb2.fw_post_f, -torch.inf)
    ffm = ff.max(dim=1).values                               # [M, R]
    fexp = torch.where(allowed[None], torch.exp(ff - ffm[:, None]), 0.0)
    bf = fb2.bw_f
    bexp = torch.exp(bf - bf.max(dim=1).values[:, None])
    fwp = fb2.fw_post.reshape(M, NS, S, R) * fexp[:, :, None]
    bwp = fb2.bw.reshape(M, NS, S, R) * bexp[:, :, None]

    def wht_x(x):   # the 512-point WHT H_NS (x) H_S
        return fwht(fwht(x, 1), 2)

    D = (wht_x(wht_x(fwp) * wht_x(bwp)) / X).reshape(M, X, R)
    idx = constant(turn_offsets(cfg), D.device, torch.long)
    vals = D[:, idx]                                         # [M, T, R]
    tiny = torch.finfo(dtype).tiny
    logv = torch.log(torch.clamp(vals, min=tiny))
    ok = vals > 0
    w = torch.where(ok & ok[:, 0:1], logv - logv[:, 0:1], MINFACTOR)
    return w[:, :, :B].permute(2, 0, 1) * descendants[:, None, None]


def turn_weights(fb2: FBv2, sh: torch.Tensor, descendants: torch.Tensor,
                 cfg: ModelConfig, B: int) -> torch.Tensor:
    """[B, M, T] turn weights: plain version on the CPU,
    csrc/turn.cu on the card (replaces scan_v2._turn_kernel)."""
    if fb2.fw_post.device.type == "cpu":
        return turn_weights_v2(fb2, sh, descendants, cfg, B)
    _build.check_config(cfg)
    M, X, R = fb2.fw_post.shape
    dt = fb2.fw_post.dtype
    _build.check(fb2.fw_post, dt, (M, 512, R), "fw_post")
    _build.check(fb2.bw, dt, (M, 512, R), "bw")
    _build.check(fb2.fw_post_f, dt, (M, 8, R), "fw_post_f")
    _build.check(fb2.bw_f, dt, (M, 8, R), "bw_f")
    _build.check(sh, torch.int32, (R,), "sh")
    _build.check(descendants, dt, (B,), "descendants")
    if not 0 < B <= R:
        raise ValueError(f"B={B} outside (0, R={R}]")
    idx = constant(turn_offsets(cfg), sh.device)
    out = torch.empty((B, M, cfg.numturns), dtype=dt, device=sh.device)
    _build.launch("turn", dt, fb2.fw_post, fb2.bw, fb2.fw_post_f, fb2.bw_f,
                  sh, descendants, idx, out, M, R, B)
    turn_weights.launches += 1
    return out


turn_weights.launches = 0


# ---------------------------------------------------------------------------
# Statistics and the whole scan
# ---------------------------------------------------------------------------
def stats_from_v2(st: SlotTensors, fb2: FBv2, total: torch.Tensor, B: int,
                  cfg: ModelConfig, probe_rules: bool = False,
                  n_variants: int = 1):
    """(b12 [B,M,7,2], accum [B,M,7,2,2], pair [B,M,2,2]) read straight
    from the v2 sweep tensors (ops.stats.stats); ``probe_rules``: the
    probe-rule form averaged over ``n_variants`` dup-flip variants."""
    return stats_mod.stats(st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f,
                           total, B, cfg, probe_rules=probe_rules,
                           n_variants=n_variants)


def chromosome_scan_v2(fb: FamilyBatch, dists: torch.Tensor,
                       cfg: ModelConfig, params: RuntimeParams,
                       ratemat=None, probe_rules: bool = False,
                       n_variants: int = 1):
    """engine.chromosome_scan on the feature-leading pipeline; returns an
    engine.ScanResult whose sweep fields are [B, M, NS, S] views."""
    from ..engine import ScanResult
    from ..hmm.probes import haplo_update_mask

    dtype = fb.ms.dtype
    B, _, M, _ = fb.md.shape
    st = prep_slots(fb, dtype)
    e = emission(st, M, cfg)
    fb2 = fb_sweeps(e, dists, cfg, params, ratemat=ratemat)
    del e
    total_r = combined_loglik_v2(fb2, st.sh)
    b12, accum, pair = stats_from_v2(st, fb2, total_r, B, cfg, probe_rules,
                                     n_variants)
    turn_w = turn_weights(fb2, st.sh, fb.descendants.to(dtype), cfg, B)
    hmask = haplo_update_mask(fb, cfg)
    coh = torch.full((B, M, cfg.numslots), 0.5, dtype=dtype,
                     device=total_r.device)
    return ScanResult(total=total_r[:B], haplo_b12=b12, haplo_mask=hmask,
                      inf_accum=accum, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=to_std(fb2.fw_pre, B, cfg),
                      bw=to_std(fb2.bw, B, cfg),
                      fw_pre_f=to_std_f(fb2.fw_pre_f, B),
                      bw_f=to_std_f(fb2.bw_f, B))


def to_std(x: torch.Tensor, B: int, cfg: ModelConfig) -> torch.Tensor:
    """[M, X, R] sweep tensor -> its [B, M, NS, S] view."""
    return x[:, :, :B].unflatten(1, (cfg.numshifts, cfg.numtypes)).permute(
        3, 0, 1, 2)


def to_std_f(x: torch.Tensor, B: int) -> torch.Tensor:
    """[M, NS, R] factors -> their [B, M, NS] view."""
    return x[:, :, :B].permute(2, 0, 1)


# ---------------------------------------------------------------------------
# The marker-blocked scan
# ---------------------------------------------------------------------------
Carry = Tuple[torch.Tensor, torch.Tensor]   # (p [X, R], f [NS, R])


class BlockedCarries(NamedTuple):
    """Passes A and B of one batch chunk: the chunk's slot tensors, the
    eigenvalue rows, the totals and the carries at every block boundary
    (``fbound[i]`` enters block i forward, ``bbound[i]`` is bw at block
    i's last marker)."""
    st: SlotTensors
    lam_pad: torch.Tensor        # [M, S]
    total_r: torch.Tensor        # [R] whole-chromosome log-likelihoods
    fbound: List[Carry]
    bbound: List[Carry]


def marker_slice(fb: FamilyBatch, sl: slice) -> FamilyBatch:
    """The family batch restricted to the markers ``sl``."""
    relh = None if fb.relh is None else fb.relh[:, sl]
    return dataclasses.replace(fb, md=fb.md[:, :, sl], ms=fb.ms[:, :, sl],
                               hw=fb.hw[:, :, sl], relh=relh)


def blocked_slice(fb: FamilyBatch, i: int, block: int) -> FamilyBatch:
    """The family batch restricted to block i's markers."""
    return marker_slice(fb, slice(i * block, (i + 1) * block))


def _blk_inputs(st: SlotTensors, i: int, block: int, cfg: ModelConfig):
    """Block i's slot tensors (cut from the chunk's) and its emission
    e [K, X, R]."""
    sl = slice(i * block, (i + 1) * block)
    st_i = st._replace(md=st.md[:, :, sl].contiguous(),
                       ms=st.ms[:, :, sl].contiguous(),
                       hw=st.hw[:, sl].contiguous())
    return st_i, emission(st_i, block, cfg)


def blocked_pass_a(st: SlotTensors, lam_pad: torch.Tensor, cfg: ModelConfig,
                   block: int):
    """Pass A: the forward sweep carry-only, block by block.  Returns the
    carry entering each block and the one after the last."""
    X = cfg.numtypes * cfg.numshifts
    carry = sweep_seeds(X, st.R, cfg, lam_pad.dtype, lam_pad.device)
    fbound = []
    for i in range(lam_pad.shape[0] // block):
        fbound.append(carry)
        _, e = _blk_inputs(st, i, block, cfg)
        carry = fb_carry(e, lam_pad[i * block:(i + 1) * block], cfg,
                         init=carry)
    return fbound, carry


def blocked_pass_b(st: SlotTensors, lam_pad: torch.Tensor, cfg: ModelConfig,
                   block: int) -> List[Carry]:
    """Pass B: the backward sweep carry-only, last block first.  Returns
    bw at each block's last marker."""
    X = cfg.numtypes * cfg.numshifts
    nblk = lam_pad.shape[0] // block
    carry = sweep_seeds(X, st.R, cfg, lam_pad.dtype, lam_pad.device,
                        backward=True)
    bbound = [None] * nblk
    for i in range(nblk - 1, -1, -1):
        bbound[i] = carry
        below = lam_pad[i * block - 1] if i > 0 else None
        _, e = _blk_inputs(st, i, block, cfg)
        carry = fb_carry(e, lam_pad[i * block:(i + 1) * block], cfg,
                         init=carry, backward=True, lam_below=below)
    return bbound


def blocked_carries(fb: FamilyBatch, dists: torch.Tensor, ratemat,
                    cfg: ModelConfig, params: RuntimeParams,
                    block: int) -> BlockedCarries:
    """Passes A and B of the marker-blocked scan for one batch chunk:
    carry-only forward and backward sweeps that keep only the carries at
    block boundaries (M / block of them).  The marker axis of ``fb`` is a
    multiple of ``block``."""
    M = fb.md.shape[2]
    if M % block:
        raise ValueError(f"{M} markers is not a multiple of block {block}")
    dt = fb.ms.dtype
    lam_pad = sweep_eigenvalues(dists, cfg, params, dt, ratemat)
    st = prep_slots(fb, dt)
    fbound, (_, f) = blocked_pass_a(st, lam_pad, cfg, block)
    bbound = blocked_pass_b(st, lam_pad, cfg, block)
    return BlockedCarries(st, lam_pad, loglik_from_factors(f, st.sh),
                          fbound, bbound)


def blocked_block_pass(fb: FamilyBatch, bc: BlockedCarries, i: int,
                       block: int, lut: torch.Tensor, cfg: ModelConfig,
                       num_individuals: int, with_turn: bool = True,
                       probe_rules: bool = False, n_variants: int = 1):
    """Pass C for one (batch chunk, block): the block's sweeps recomputed
    from its boundary carries, the statistics against the whole
    chromosome's totals (``probe_rules``: the probe-rule form over
    ``n_variants`` variants, the infprob merge then counting non-empty
    slots only), the merges and (``with_turn``) the turn weights.
    Returns (fb_blk, st_blk, fb2, pair, hb, hc, inf, w or None) for the
    block's markers."""
    from ..hmm.probes import haplo_update_mask
    from ..parallel.collective import merge_haplos, merge_infprobs
    B = fb.md.shape[0]
    fb_blk = blocked_slice(fb, i, block)
    st_i, e = _blk_inputs(bc.st, i, block, cfg)
    fb2 = fb_sweeps(e, None, cfg, None,
                    lam_pad=bc.lam_pad[i * block:(i + 1) * block],
                    init_fwd=bc.fbound[i], init_bwd=bc.bbound[i])
    del e
    b12, accum, pair = stats_from_v2(st_i, fb2, bc.total_r, B, cfg,
                                     probe_rules, n_variants)
    hmask = haplo_update_mask(fb_blk, cfg)
    hb, hc = merge_haplos(b12, hmask, fb_blk.hw, fb_blk.slot_ind,
                          fb_blk.descendants, lut, num_individuals)
    inf = merge_infprobs(accum, fb_blk.slot_ind, fb_blk.descendants, lut,
                         num_individuals,
                         emptyslot=fb_blk.emptyslot if probe_rules else None)
    w = None
    if with_turn:
        w = turn_weights(fb2, st_i.sh, fb_blk.descendants.to(fb2.bw.dtype),
                         cfg, B)
    return fb_blk, st_i, fb2, pair, hb, hc, inf, w


def blocked_scan_chunk(fb: FamilyBatch, dists: torch.Tensor, ratemat,
                       lut: torch.Tensor, cfg: ModelConfig,
                       params: RuntimeParams, block: int,
                       num_individuals: int, turn_consumer=None,
                       probe_rules: bool = False, n_variants: int = 1):
    """The scan and merges of one batch chunk in O(block) sweep memory:
    ``blocked_carries``, then ``blocked_block_pass`` per block.
    ``turn_consumer(offset, w)`` takes each block's turn weights, so that
    they never accumulate across blocks.  Returns (total [B],
    pair [B, M, 2, 2], hb, hc [NI, M], inf [NI, M, 2, 2]) on the chunk's
    device."""
    B, _, M, _ = fb.md.shape
    bc = blocked_carries(fb, dists, ratemat, cfg, params, block)
    kw = dict(dtype=fb.ms.dtype, device=fb.ms.device)
    NI = num_individuals
    pair = torch.zeros((B, M, 2, 2), **kw)
    hb, hc = torch.zeros((NI, M), **kw), torch.zeros((NI, M), **kw)
    inf = torch.zeros((NI, M, 2, 2), **kw)
    for i in range(M // block):
        _, _, _, pair_i, hb_i, hc_i, inf_i, w = blocked_block_pass(
            fb, bc, i, block, lut, cfg, NI,
            with_turn=turn_consumer is not None, probe_rules=probe_rules,
            n_variants=n_variants)
        sl = slice(i * block, (i + 1) * block)
        pair[:, sl], hb[:, sl], hc[:, sl], inf[:, sl] = \
            pair_i, hb_i, hc_i, inf_i
        if turn_consumer is not None:
            turn_consumer(i * block, w)
    return bc.total_r[:B], pair, hb, hc, inf
