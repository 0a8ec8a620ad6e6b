"""Flow-quality metrics in NumPy (copies of ``eppm_tpu/metrics.py``,
which the port cannot import).

``flow_error`` follows ``bao_calc_flow_error`` (basic/bao_flow_tools.cpp:
64-141): a ground-truth pixel counts when either component is nonzero and
not the unknown sentinel; EPE is the mean L2 endpoint error, AAE the mean
angle between (u, v, 1) vectors in degrees (with the reference's pi =
3.14159).  ``bad_pixel_rate`` follows ``bao_calc_flow_error_percentage``
(:114-141), whose validity rule differs: either component known.
``warp_error`` is a ground-truth-free proxy: the mean absolute difference
between frame 1 and frame 2 sampled bilinearly along the flow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .config import UNKNOWN_FLOW_THRESH

_PI = 3.14159  # the reference's value of pi (flow_tools.cpp:88,103)

__all__ = ["flow_error", "bad_pixel_rate", "warp_error"]


def flow_error(
    flow: np.ndarray, gt: np.ndarray, border: int = 0
) -> Tuple[float, float]:
    """Return (EPE, AAE degrees) of ``flow`` vs ``gt`` (both (H, W, 2))."""
    flow = np.asarray(flow, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if border > 0:
        flow = flow[border:-border, border:-border]
        gt = gt[border:-border, border:-border]
    u, v = flow[..., 0], flow[..., 1]
    gu, gv = gt[..., 0], gt[..., 1]
    valid = ((np.abs(gu) > 0) & (np.abs(gu) <= UNKNOWN_FLOW_THRESH)) | (
        (np.abs(gv) > 0) & (np.abs(gv) <= UNKNOWN_FLOW_THRESH)
    )
    if not valid.any():
        return 0.0, 0.0
    du, dv = u - gu, v - gv
    epe = float(np.sqrt(du * du + dv * dv)[valid].mean())
    cos_val = (u * gu + v * gv + 1.0) / (
        np.sqrt(u * u + v * v + 1.0) * np.sqrt(gu * gu + gv * gv + 1.0)
    )
    ang = np.arccos(np.clip(cos_val, -1.0, 1.0))
    aae = float(ang[valid].mean() * 180.0 / _PI)
    return epe, aae


def bad_pixel_rate(flow: np.ndarray, gt: np.ndarray, thresh: float = 3.0,
                   return_error_map: bool = False):
    """Fraction of valid pixels with EPE > ``thresh`` (flow_tools.cpp:
    114-141); with ``return_error_map`` also the per-pixel EPE map, zero
    where the ground truth is unknown (the reference's ``err_map``)."""
    flow = np.asarray(flow, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    gu, gv = gt[..., 0], gt[..., 1]
    valid = (np.abs(gu) <= UNKNOWN_FLOW_THRESH) | (
        np.abs(gv) <= UNKNOWN_FLOW_THRESH
    )
    epe = np.sqrt(((flow - gt) ** 2).sum(-1))
    rate = float((epe[valid] > thresh).mean()) if valid.any() else 0.0
    if return_error_map:
        return rate, np.where(valid, epe, 0.0)
    return rate


def warp_error(img1: np.ndarray, img2: np.ndarray, flow: np.ndarray) -> float:
    """Mean |img1(x) - img2(x + flow)| with bilinear sampling."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    h, w = img1.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = np.clip(xs + flow[..., 0], 0, w - 1)
    fy = np.clip(ys + flow[..., 1], 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    warped = (
        img2[y0, x0] * (1 - ax) * (1 - ay)
        + img2[y0, x1] * ax * (1 - ay)
        + img2[y1, x0] * (1 - ax) * ay
        + img2[y1, x1] * ax * ay
    )
    return float(np.abs(img1 - warped).mean())
