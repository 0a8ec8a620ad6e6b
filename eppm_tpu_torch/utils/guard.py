"""Validation of a produced flow field (counterpart of the checks in
``eppm_tpu/utils/guard.py``): finite values, the share of unknown-flow
sentinels, the largest magnitude and, given both frames, the photometric
warp error against the zero-flow baseline (the GT-free gate of the
repo's benchmarks).  Computed on the flow's device, read back to the
host once."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import UNKNOWN_FLOW_THRESH

__all__ = ["FlowGuardError", "FlowSanity", "flow_sanity", "check_flow"]


class FlowGuardError(RuntimeError):
    """A produced flow field failed validation."""

    def __init__(self, msg: str, report: "FlowSanity"):
        super().__init__(f"{msg}: {report}")
        self.report = report


@dataclass(frozen=True)
class FlowSanity:
    """Structural health report for one flow field."""

    finite_frac: float      # fraction of finite values
    unknown_frac: float     # fraction of UNKNOWN_FLOW-sentinel pixels
    max_mag: float          # max |flow| over finite, known pixels
    warp_ratio: Optional[float]  # warp_error / zero-flow warp_error

    def __str__(self) -> str:
        wr = "n/a" if self.warp_ratio is None else f"{self.warp_ratio:.3f}"
        return (
            f"finite={self.finite_frac:.4f} unknown={self.unknown_frac:.4f} "
            f"max|f|={self.max_mag:.1f} warp_ratio={wr}"
        )


def _warp_error(img1: torch.Tensor, img2: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
    """Mean |img1(x) - img2(x + flow)|, bilinear, float64, as a 0-dim
    tensor (``metrics.warp_error`` on the device)."""
    h, w = img1.shape[:2]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=img1.device),
        torch.arange(w, dtype=torch.float64, device=img1.device),
        indexing="ij")
    fx = (xs + flow[..., 0]).clamp(0, w - 1)
    fy = (ys + flow[..., 1]).clamp(0, h - 1)
    x0 = fx.floor().long().clamp(0, w - 1)
    y0 = fy.floor().long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    warped = (img2[y0, x0] * (1 - ax) * (1 - ay)
              + img2[y0, x1] * ax * (1 - ay)
              + img2[y1, x0] * (1 - ax) * ay
              + img2[y1, x1] * ax * ay)
    return (img1 - warped).abs().mean()


def flow_sanity(flow: torch.Tensor, img1: Optional[torch.Tensor] = None,
                img2: Optional[torch.Tensor] = None) -> FlowSanity:
    """The health report of ``flow`` (H, W, 2); given both frames (on the
    flow's device, uint8 or float in [0, 1]) also the warp error over the
    zero-flow one (< 1: the flow explains some of the motion)."""
    f = flow
    finite = torch.isfinite(f)
    fz = torch.where(finite, f, 0.0)
    inside = finite & (fz.abs() <= UNKNOWN_FLOW_THRESH)
    known = inside.all(-1)
    mags = (fz[..., 0] * fz[..., 0] + fz[..., 1] * fz[..., 1]).sqrt()
    stats = [finite.double().mean(), 1.0 - known.double().mean(),
             torch.where(known, mags.double(), -torch.inf).max()
             if known.numel() else torch.tensor(-torch.inf)]
    if img1 is not None and img2 is not None:
        a1, a2 = img1.double(), img2.double()
        big = a1.max() > 1.5  # uint8-range frames
        a1 = torch.where(big, a1 / 255.0, a1)
        a2 = torch.where(big, a2 / 255.0, a2)
        wf = torch.where(inside, f, 0.0)
        we = _warp_error(a1, a2, wf.double())
        we0 = _warp_error(a1, a2, torch.zeros_like(wf, dtype=torch.float64))
        stats.append(we / we0.clamp_min(1e-12))
    vals = torch.stack([s.to(f.device, torch.float64) for s in stats])
    vals = vals.tolist()  # the one read back to the host
    max_mag = vals[2] if vals[2] != float("-inf") else float("inf")
    return FlowSanity(vals[0], vals[1], max_mag,
                      vals[3] if len(vals) > 3 else None)


def check_flow(flow: torch.Tensor, img1: Optional[torch.Tensor] = None,
               img2: Optional[torch.Tensor] = None, *,
               max_unknown_frac: float = 0.5, max_mag: Optional[float] = None,
               max_warp_ratio: Optional[float] = None) -> FlowSanity:
    """Validate ``flow``; raise ``FlowGuardError`` on failure.  The
    defaults are loose (a hole-filled field has ~0 unknowns; 50% means
    the pipeline failed); ``max_warp_ratio`` (with both frames) is a
    quality gate, e.g. 0.6 as the repo's benchmarks gate."""
    rep = flow_sanity(flow, img1, img2)
    if rep.finite_frac < 1.0:
        raise FlowGuardError("non-finite flow values", rep)
    if rep.unknown_frac > max_unknown_frac:
        raise FlowGuardError(f"unknown-flow fraction > {max_unknown_frac}",
                             rep)
    if max_mag is not None and rep.max_mag > max_mag:
        raise FlowGuardError(f"flow magnitude > {max_mag}", rep)
    if (max_warp_ratio is not None and rep.warp_ratio is not None
            and rep.warp_ratio > max_warp_ratio):
        raise FlowGuardError(f"warp ratio > {max_warp_ratio}", rep)
    return rep
