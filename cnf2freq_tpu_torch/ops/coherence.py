"""Adjacent-marker phase coherence on the card: the wrapper of
``csrc/coherence.cu``.

``hmm.probes.phase_coherence`` routes a CPU tensor to its plain twin
``phase_coherence_reference`` and a CUDA tensor here.  The kernel takes
the classic sweeps, the interval eigenvalues and the emission blocks
and computes all seven slots' coherence columns and their shared pair
total in one launch, with no [B, M, NS, S] emission stored; the JAX
package runs the same stage as XLA (``cnf2freq_tpu/hmm/probes.py``
``phase_coherence``).  There is no fallback: a refused argument or a
failed launch raises.
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
