"""Marker-axis padding for the marker-blocked scan (port of
``pad_markers`` from ``cnf2freq_tpu/parallel/mesh.py``; the device mesh
of that module is not ported yet)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hmm.family import FamilyBatch


def pad_markers(fb: FamilyBatch, m_target: int) -> FamilyBatch:
    """Pad the marker axis to m_target with inert trailing markers
    (all-unknown genotypes, zero error, neutral phase weight, relhaplo 0.5
    where the batch carries it): the tensor form of the reference's
    mandatory trailing dummy marker (demo.sh:22-23).  With zero inter-marker distance the transition is
    the identity and the padded emissions are state-constant, so real
    markers' posteriors are unchanged; callers slice results back to the
    real length.  Takes numpy arrays or tensors."""
    M = fb.md.shape[2]
    pad = m_target - M
    if pad <= 0:
        return fb

    def padm(x, val):
        if torch.is_tensor(x):
            tail = torch.full(x.shape[:2] + (pad,) + x.shape[3:], val,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=2)
        widths = [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 3)
        return np.pad(np.asarray(x), widths, constant_values=val)

    relh = fb.relh
    if relh is not None:
        # the RELSKEWSTATES coupling of the padded intervals: no skew
        relh = padm(relh[:, None], 0.5)[:, 0]
    return dataclasses.replace(fb, md=padm(fb.md, 0), ms=padm(fb.ms, 0.0),
                               hw=padm(fb.hw, 0.5), relh=relh)
