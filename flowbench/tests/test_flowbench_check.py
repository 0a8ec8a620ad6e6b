"""The comparison's sampling: a pool compares every flow served for the
drawn entries; a warm traffic's first pairs are followed by the
reference on its own flows, never on the port's."""

import numpy as np
import torch

from flowbench import check

CPU = torch.device("cpu")


class Frames:
    """Pair i's frames hold i; a warm traffic when ``warm``."""

    def __init__(self, warm, chain=3, pairs=1):
        self.warm, self.check_chain, self.check_pairs = warm, chain, pairs

    def pair(self, i):
        f = np.full((2, 3, 3), i, np.uint8)
        return i % 4 if not self.warm else i, f, f


def step(a, b, init):
    """A warm step: the init flow plus the pair's index; cold: the index."""
    base = torch.zeros((2, 3, 2)) if init is None else init
    return base + float(a[0, 0, 0])


def port_flows(n, wrong_at=None):
    """The port's flows, each the sum of indices so far; ``wrong_at``
    shifts one flow and, through the warm start, every flow after it."""
    out, acc = [], np.zeros((2, 3, 2), np.float32)
    for i in range(n):
        acc = acc + i + (1.0 if i == wrong_at else 0.0)
        out.append(acc.copy())
    return out


def test_sound_warm_window_matches():
    got = check.compare(11, Frames(True), port_flows(8), list(range(8)), step,
                        CPU)
    assert got.worst == {"differ_pct": 0.0, "mean_abs_px": 0.0}
    assert got.pairs[:3] == [0, 1, 2] and got.flows == 4


def test_chain_runs_on_the_references_own_flows():
    # a flow gone wrong at pair 1 carries into pair 2 through the warm
    # start: a step from the port's flow 1 would agree at pair 2, the
    # reference's own chain does not
    flows = port_flows(3, wrong_at=1)
    got = check.compare(11, Frames(True, chain=3, pairs=0), flows,
                        [0, 1, 2], step, CPU)
    assert got.pairs == [0, 1, 2]
    assert got.worst["differ_pct"] == 100.0


def test_pool_compares_every_flow_of_a_drawn_entry():
    flows = [np.full((2, 3, 2), i % 4, np.float32) for i in range(8)]
    flows[5][0, 0, 0] = 9.0                      # entry 1, served twice
    keys = [i % 4 for i in range(8)]
    seen = []
    for seed in range(40):
        got = check.compare(seed, Frames(False, pairs=1), flows, keys, step,
                            CPU)
        seen.append((got.pairs, got.flows, got.worst["differ_pct"]))
    assert all(n == 2 for _, n, _ in seen)
    assert {tuple(p) for p, _, _ in seen} == {(0,), (1,), (2,), (3,)}
    assert all((d > 0) == (p == [1]) for p, _, d in seen)
