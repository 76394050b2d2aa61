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
(``emission_reference``, ``fb_scan_v2``, ``turn_weights_v2``;
``ops.stats.stats_reference``) and a wrapper (``emission``,
``fb_sweeps``, ``turn_weights``, ``ops.stats.stats``) that runs the plain
version for a CPU tensor and launches the CUDA kernel for a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple

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

    @property
    def R(self) -> int:
        return self.f2.shape[0]


def prep_slots(fb: FamilyBatch, dtype) -> SlotTensors:
    """Torch FamilyBatch [B, 7, M, ...] -> feature-leading slot tensors
    with the batch padded to R (padded units: vacant, all-unknown)."""
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
        sh=padb(fb.shiftignore.to(i32)).contiguous())


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


def fb_scan_v2(e: torch.Tensor, dists: torch.Tensor, cfg: ModelConfig,
               params: RuntimeParams, ratemat=None) -> FBv2:
    """Plain sweeps over e [M, X, R] (a loop over markers)."""
    lam_pad = sweep_eigenvalues(dists, cfg, params, e.dtype, ratemat)
    M, X, R = e.shape
    S, NS = cfg.numtypes, cfg.numshifts
    kw = dict(dtype=e.dtype, device=e.device)
    p = torch.full((X, R), cfg.evengen, **kw)
    f = torch.zeros((NS, R), **kw)
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(M):
        fw_pre.append(p)
        fw_pre_f.append(f)
        p, f = _emit_norm_v2(p, e[m], f, NS, S)
        fw_post.append(p)
        fw_post_f.append(f)
        p = _transition_v2(p, lam_pad[m], NS, S)

    p = torch.ones((X, R), **kw)
    f = torch.zeros((NS, R), **kw)
    bw, bw_f = [None] * M, [None] * M
    for m in range(M - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            p, f = _emit_norm_v2(p, e[m], f, NS, S)
            p = _transition_v2(p, lam_pad[m - 1], NS, S)
    st = torch.stack
    return FBv2(fw_pre=st(fw_pre), fw_post=st(fw_post), bw=st(bw),
                fw_pre_f=st(fw_pre_f), fw_post_f=st(fw_post_f),
                bw_f=st(bw_f))


def fb_sweeps(e: torch.Tensor, dists: torch.Tensor, cfg: ModelConfig,
              params: RuntimeParams, ratemat=None) -> FBv2:
    """Both sweeps: ``fb_scan_v2`` on the CPU, csrc/fb_sweep.cu on the
    card (replaces scan_v2._fbv2_fwd_kernel / _fbv2_bwd_kernel)."""
    if e.device.type == "cpu":
        return fb_scan_v2(e, dists, cfg, params, ratemat=ratemat)
    _build.check_config(cfg)
    M, X, R = e.shape
    dt = e.dtype
    lam_pad = sweep_eigenvalues(dists, cfg, params, dt, ratemat).contiguous()
    _build.check(e, dt, (M, 512, R), "e")
    _build.check(lam_pad, dt, (M, 64), "lam_pad")
    kw = dict(dtype=dt, device=e.device)
    out = FBv2(*(torch.empty((M, n, R), **kw)
                 for n in (512, 512, 512, 8, 8, 8)))
    _build.launch("fb_sweep", dt, e, lam_pad, float(cfg.evengen),
                  out.fw_pre, out.fw_post, out.bw, out.fw_pre_f,
                  out.fw_post_f, out.bw_f, M, R)
    fb_sweeps.launches += 1
    return out


fb_sweeps.launches = 0


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
                  cfg: ModelConfig):
    """(b12 [B,M,7,2], accum [B,M,7,2,2], pair [B,M,2,2]) read straight
    from the v2 sweep tensors (ops.stats.stats)."""
    return stats_mod.stats(st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f,
                           total, B, cfg)


def chromosome_scan_v2(fb: FamilyBatch, dists: torch.Tensor,
                       cfg: ModelConfig, params: RuntimeParams,
                       ratemat=None):
    """engine.chromosome_scan on the feature-leading pipeline; returns an
    engine.ScanResult whose sweep fields are [B, M, NS, S] views."""
    from ..engine import ScanResult
    from ..hmm.probes import haplo_update_mask

    dtype = fb.ms.dtype
    B, _, M, _ = fb.md.shape
    S, NS = cfg.numtypes, cfg.numshifts
    st = prep_slots(fb, dtype)
    e = emission(st, M, cfg)
    fb2 = fb_sweeps(e, dists, cfg, params, ratemat=ratemat)
    del e
    total_r = combined_loglik_v2(fb2, st.sh)
    b12, accum, pair = stats_from_v2(st, fb2, total_r, B, cfg)
    turn_w = turn_weights(fb2, st.sh, fb.descendants.to(dtype), cfg, B)
    hmask = haplo_update_mask(fb, cfg)

    def to_std(x):      # [M, X, R] -> [B, M, NS, S] view
        return x[:, :, :B].unflatten(1, (NS, S)).permute(3, 0, 1, 2)

    def to_std_f(x):    # [M, NS, R] -> [B, M, NS] view
        return x[:, :, :B].permute(2, 0, 1)

    coh = torch.full((B, M, cfg.numslots), 0.5, dtype=dtype,
                     device=total_r.device)
    return ScanResult(total=total_r[:B], haplo_b12=b12, haplo_mask=hmask,
                      inf_accum=accum, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=to_std(fb2.fw_pre),
                      bw=to_std(fb2.bw), fw_pre_f=to_std_f(fb2.fw_pre_f),
                      bw_f=to_std_f(fb2.bw_f))
