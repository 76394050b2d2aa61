"""Adjacent-marker phase coherence on the card: the wrappers of
``csrc/coherence.cu``.

``hmm.probes.phase_coherence`` routes a CPU tensor to its plain twin
``phase_coherence_reference`` and a CUDA tensor to ``coherence`` (kernel
#10).  The kernel takes the classic sweeps, the interval eigenvalues and
the emission blocks and computes all seven slots' coherence columns and
their shared pair total in one launch, with no [B, M, NS, S] emission
stored; the JAX package runs the same stage as XLA
(``cnf2freq_tpu/hmm/probes.py`` ``phase_coherence``).
``engine_ext.coherence_ext`` does the same for SELFING's extended sweeps
[B, M, 3, NS, S]: ``coherence_ext`` (kernel #14) on the card,
``coherence_ext_reference`` (``engine_ext.coherence_slot_ext`` per slot,
as the JAX package's ``engine_ext.coherence_slot_ext``) on the CPU.
There is no fallback: a refused argument or a failed launch raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import ModelConfig


def coherence(fw_pre: torch.Tensor, bw: torch.Tensor,
              fw_pre_f: torch.Tensor, bw_f: torch.Tensor, lam: torch.Tensor,
              froot: torch.Tensor, pb0: torch.Tensor, pb1: torch.Tensor,
              flag2ignore: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """C [B, M, 7] in fw_pre's dtype from the sweeps fw_pre, bw
    [B, M, 8, 64] and fw_pre_f, bw_f [B, M, 8], the eigenvalues lam
    [M-1, 64], the blocks froot [B, M, 2, 2] and pb0, pb1
    [B, M, 2, 8, 8, 2], and the canonical-path masks flag2ignore [B]; the
    last marker column is 0.5.  CUDA tensors only (views are copied to
    contiguous ones): every argument's type and shape is checked before
    any device, and all of them before the launch."""
    _build.check_config(cfg)
    B, M = fw_pre.shape[:2]
    dt = fw_pre.dtype
    args = [x.contiguous() for x in (fw_pre, bw, fw_pre_f, bw_f, lam,
                                     froot, pb0, pb1)]
    f2 = flag2ignore.to(torch.int32).contiguous()
    shapes = ((B, M, 8, 64), (B, M, 8, 64), (B, M, 8), (B, M, 8),
              (max(M - 1, 0), 64), (B, M, 2, 2), (B, M, 2, 8, 8, 2),
              (B, M, 2, 8, 8, 2))
    names = ("fw_pre", "bw", "fw_pre_f", "bw_f", "lam", "froot", "pb0",
             "pb1")
    specs = [(x, dt, shape, name) for x, shape, name in
             zip(args, shapes, names)] + [(f2, torch.int32, (B,),
                                           "flag2ignore")]
    for spec in specs:
        _build.check_form(*spec)
    for spec in specs:
        _build.check(*spec)
    out = torch.empty((B, M, 7), dtype=dt, device=fw_pre.device)
    if B and M:
        _build.launch("coherence", dt, *args, f2, out, B, M)
        coherence.launches += 1
    return out


coherence.launches = 0


def coherence_ext_reference(fbres, blocks_v, fb, cfg: ModelConfig,
                            lam: torch.Tensor, C: torch.Tensor):
    """The plain twin of ``coherence_ext``, on any device: C [B, M, 7],
    the stack of ``engine_ext.slot_coherence_ext`` over the slots, from
    the extended sweeps (``fbres``), each value's blocks, the family
    batch's canonical-path masks, lam [M-1, 64] and the coupling C
    [B, M-1, V, V]."""
    from ..engine_ext import slot_coherence_ext
    return torch.stack([slot_coherence_ext(fbres, blocks_v, fb, cfg, lam, C,
                                           slot)
                        for slot in range(cfg.numslots)], dim=-1)


def coherence_ext(fw_pre: torch.Tensor, bw: torch.Tensor,
                  fw_pre_f: torch.Tensor, bw_f: torch.Tensor,
                  lam: torch.Tensor, C: torch.Tensor, froot, pb0, pb1,
                  flag2ignore: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """SELFING's coherence C [B, M, 7] in fw_pre's dtype (kernel #14, one
    launch for all seven slots) from the extended sweeps fw_pre, bw
    [B, M, 3, 8, 64] and fw_pre_f, bw_f [B, M, 8], the eigenvalues lam
    [M-1, 64], the coupling C [B, M-1, 3, 3] (row = from), each HBD
    status's blocks (froot, pb0, pb1: sequences of 3 tensors
    [B, M, 2, 2] and [B, M, 2, 8, 8, 2]) and the canonical-path masks
    flag2ignore [B]; the last marker column is 0.5.  CUDA tensors only
    (views are copied to contiguous ones): every argument's type and
    shape is checked before any device, and all of them before the
    launch."""
    V = _build.check_ext_config(cfg)
    if not cfg.selfing:
        raise NotImplementedError("coherence_ext: the SELFING model only")
    B, M = fw_pre.shape[:2]
    dt = fw_pre.dtype
    blocks = [list(x) for x in (froot, pb0, pb1)]
    if any(len(x) != V for x in blocks):
        raise ValueError(f"froot, pb0, pb1: {V} tensors each")
    args = [x.contiguous() for x in (fw_pre, bw, fw_pre_f, bw_f, lam, C)]
    blocks = [[x.contiguous() for x in xs] for xs in blocks]
    f2 = flag2ignore.to(torch.int32).contiguous()
    shapes = ((B, M, V, 8, 64), (B, M, V, 8, 64), (B, M, 8), (B, M, 8),
              (max(M - 1, 0), 64), (B, max(M - 1, 0), V, V))
    names = ("fw_pre", "bw", "fw_pre_f", "bw_f", "lam", "C")
    specs = [(x, dt, shape, name) for x, shape, name in
             zip(args, shapes, names)]
    for name, shape, xs in (("froot", (B, M, 2, 2), blocks[0]),
                            ("pb0", (B, M, 2, 8, 8, 2), blocks[1]),
                            ("pb1", (B, M, 2, 8, 8, 2), blocks[2])):
        specs += [(x, dt, shape, f"{name}[{v}]") for v, x in enumerate(xs)]
    specs.append((f2, torch.int32, (B,), "flag2ignore"))
    for spec in specs:
        _build.check_form(*spec)
    for spec in specs:
        _build.check(*spec)
    out = torch.empty((B, M, 7), dtype=dt, device=fw_pre.device)
    if B and M:
        _build.launch("coherence_ext", dt, *args, *blocks[0], *blocks[1],
                      *blocks[2], f2, out, B, M)
        coherence_ext.launches += 1
    return out


coherence_ext.launches = 0
