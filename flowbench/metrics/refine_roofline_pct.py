"""``refine_roofline_pct`` (layer: the fine levels' cost, ``ops/dense.py::
dense_refine_flow`` over kernel A): the least time for the AD + census
cost of level 0's refine passes (``stats.refine_cost_work``, counted
from the configuration and the frame size, against the published float32
and memory peaks), over the passes' device ms measured as stages (the
median of each stage's replays, summed).  Fronto-parallel passes only:
a run whose passes take plane hypotheses, or that refines by gathers,
has nothing to read."""

import statistics

from ..stats import refine_cost_work, roofline_pct


def read(run):
    c = run.config
    if not run.stages or c["refine_impl"] != "dense":
        return None
    n = c["dense_refine_passes"]
    if c["dense_pass1_planes"] or (n > 1 and c["dense_pass2_planes"]):
        return None
    names = [f"L0.pass{i + 1}" for i in range(n)]
    if any(k not in run.stages for k in names):
        return None
    cost = c["cost"]
    r2 = c["dense_pass2_patch_radius"] or cost["patch_radius"]
    s2 = c["dense_pass2_tap_stride"] or cost["patch_stride"]
    shape2 = c["dense_pass2_cand_shape"] or c["dense_cand_shape"]
    radius = c["dense_search_radius"]
    works = [refine_cost_work(run.height, run.width, cost["patch_radius"],
                              cost["patch_stride"], radius,
                              c["dense_cand_shape"])]
    works += [refine_cost_work(run.height, run.width, r2, s2, radius, shape2)
              ] * (n - 1)
    ms = sum(statistics.median(run.stages[k]) for k in names)
    return roofline_pct(works, ms)
