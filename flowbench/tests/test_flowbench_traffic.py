"""The traffic: the same from the same seed, different across seeds, the
same kinds and sizes from every seed."""

import numpy as np
import pytest
import torch

from flowbench import generator, spec

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 12345


def small_pool(name):
    s = dict(spec.traffic(name), height=72, width=96)
    # the motions scaled to the size; the kinds and counts kept
    s["scenes"] = [dict(sc, **({"fg": [4, 8], "bg_max": 3}
                               if sc["kind"] == "layered" else {}))
                   for sc in s["scenes"]]
    return s


@pytest.mark.parametrize("name", ["layered-1080p-pool16",
                                  "middlebury-480x640-pool16"])
def test_pool_same_seed_same_frames(name):
    a = generator.make(small_pool(name), BIG_SEED, CPU, 1.0)
    b = generator.make(small_pool(name), BIG_SEED, CPU, 1.0)
    c = generator.make(small_pool(name), BIG_SEED + 1, CPU, 1.0)
    assert len(a.pairs) == 16
    for (x1, x2), (y1, y2) in zip(a.pairs, b.pairs):
        assert np.array_equal(x1, y1) and np.array_equal(x2, y2)
    assert any(not np.array_equal(x1, z1)
               for (x1, _), (z1, _) in zip(a.pairs, c.pairs))
    for f1, f2 in a.pairs:
        assert f1.dtype == np.uint8 and f1.shape == (72, 96, 3)
        assert f2.shape == f1.shape and not np.array_equal(f1, f2)


def test_pool_cycles():
    p = generator.make(small_pool("middlebury-480x640-pool16"), 3, CPU, 1.0)
    assert p.pair(0)[0] == 0 and p.pair(17)[0] == 1
    assert p.pair(16)[1] is p.pairs[0][0]


def test_video_same_seed_and_ping_pong():
    s = dict(spec.traffic("video-1080p-pan"), height=60, width=80)
    s["boxes"] = [dict(b) for b in s["boxes"]]
    a = generator.make(s, BIG_SEED, CPU, 2.0)
    b = generator.make(s, BIG_SEED, CPU, 2.0)
    c = generator.make(s, 5, CPU, 2.0)
    n = 12 * 2 + 2
    assert a.frames.shape == (n, 60, 80, 3)
    assert np.array_equal(a.frames, b.frames)
    assert not np.array_equal(a.frames, c.frames)
    assert [a.index(i) for i in (0, n - 1, n, 2 * n - 2, 2 * n - 1)] == [
        0, n - 1, n - 2, 0, 1]
    # the background pans (3, 2) a frame: frame k+1 at p + (2, 3) is
    # frame k at p, away from the boxes
    k0, k1 = a.frames[0].astype(int), a.frames[1].astype(int)
    agree = (k1[2:, 3:] == k0[:-2, :-3]).all(-1).mean()
    assert agree > 0.5


def test_unknown_kind_refused():
    with pytest.raises(spec.NotFound, match="scene kind 'spiral'.*layered"):
        generator.make({"generator": "pool", "height": 8, "width": 8,
                        "scenes": [{"kind": "spiral", "count": 1}]}, 0, CPU,
                       1.0)
    with pytest.raises(spec.NotFound, match="traffic generator.*video"):
        generator.make({"generator": "stream"}, 0, CPU, 1.0)


@pytest.mark.parametrize("name", ["pool", "video"])
def test_generators_found_by_name(name):
    assert generator.kind(name).__module__ == f"flowbench.generators.{name}"


@pytest.mark.parametrize("name", ["translation", "affine", "rotation", "zoom",
                                  "piecewise", "layered"])
def test_scene_kinds_found_by_name(name):
    img1, img2 = generator.scene(name)(
        generator.device_generator(3, CPU), np.random.default_rng(3),
        {"u": [1, 2], "v": [1, 2], "offset": [-1, 1], "slope": [-2, 2],
         "degrees": [-1, 1], "zoom": [0.98, 1.02], "regions": 3,
         "uv": [-2, 2], "bg_max": 2, "fg": [3, 5], "boxes": 2},
        24, 32, CPU)
    assert img1.shape == img2.shape == (24, 32, 3)
    assert img1.dtype == torch.float32
    assert 0 <= float(img1.min()) and float(img1.max()) <= 1


def test_warm_traffic_declares_itself():
    s = dict(spec.traffic("video-1080p-pan"), height=40, width=56)
    v = generator.make(s, 1, CPU, 1.0)
    assert v.warm and v.check_chain == s["check_chain"]
    assert not generator.make(small_pool("layered-1080p-pool16"), 1, CPU,
                              1.0).warm
