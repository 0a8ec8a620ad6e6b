"""The upstream deployment, ``UPSTREAM_CONFIG`` (linchaobao/EPPM's own
binary's settings: PatchMatch over 100-tap patches, the gathered
plane-fitting refine, the WMF-then-fill occlusion order), on the CPU:

* the benchmark's configuration file holds it field for field, the
  command line's ``--set`` keys make it, and it departs from
  ``DEFAULT_CONFIG`` in the binary's keys only;
* ``compute_flow`` under it equals the benchmark's plain reference
  (``flowbench/reference``) bit for bit at 96x128, and holds the repo's
  contract against ``eppm_tpu``'s ``compute_flow_jit`` at 96x160;
* traced, its ``occlusion`` stage holds ``occlusion.wmf`` and
  ``occlusion.fill`` in that order, the other stages are
  ``flowbench/stages.py``'s, and ``DEFAULT_CONFIG`` marks what it marked;
* the benchmark's readers of its spans give the hand-computed values on
  a made-up stretch, and nothing where the spans are missing."""

import dataclasses
import functools
import json
import types

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.config import EPPMConfig as JaxConfig
from eppm_tpu.config import config_fingerprint as jax_fingerprint
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.cli import apply_overrides
from eppm_tpu_torch.config import (DEFAULT_CONFIG, UPSTREAM_CONFIG,
                                   _from_dict, config_fingerprint)
from eppm_tpu_torch.pipeline import compute_flow
from eppm_tpu_torch.utils import trace
from eppm_tpu_torch.utils.trace import Span
from flowbench import reference, spans, spec
from flowbench.metrics import (gather_refine_roofline_pct,
                               gather_refine_span_ms, occlusion_wmf_span_ms)
from flowbench.stages import stages as bench_stages
from flowbench.trace import Run
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# the command line's form of the preset (README.md)
UPSTREAM_SETS = [
    "match_engine=patchmatch", "refine_impl=gather", "cost.patch_stride=2",
    "pyramid.auto_depth_dim=0", "refine.lr_diff_thresh=0",
    "refine.stat_collapse_guard=0.0", "refine.wmf_coarse_iters=20",
    "refine.wmf_fill_first=False", "refine.fill_patch_radius=0",
    "refine.fill_linear_baseline=0", "refine.fill_photometric_thresh=0.0",
    "refine.fill_median_rounds=0",
]


def flat(cfg, prefix=""):
    """The config tree as {dotted key: value}."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_config_file_cli_and_keys():
    conf = spec.config("eppm_upstream")
    want = json.loads(json.dumps(dataclasses.asdict(UPSTREAM_CONFIG)))
    assert conf["config"] == want
    assert conf["reduced"] == []
    assert apply_overrides(DEFAULT_CONFIG, UPSTREAM_SETS) == UPSTREAM_CONFIG
    a, b = flat(DEFAULT_CONFIG), flat(UPSTREAM_CONFIG)
    assert {k for k in a if a[k] != b[k]} == {
        s.split("=")[0] for s in UPSTREAM_SETS}
    # no field added: the JAX package's tree of the same values hashes alike
    jcfg = _from_dict(JaxConfig, dataclasses.asdict(UPSTREAM_CONFIG))
    assert jax_fingerprint(jcfg) == config_fingerprint(UPSTREAM_CONFIG)


@functools.lru_cache(maxsize=None)
def traced(cfg, h, w):
    """(flow, trace) of ``compute_flow`` under ``cfg`` on an h x w pair,
    tracing on."""
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(h, w, 3, -2, seed=0))
    trace.TRACER.__init__()
    trace.enable()
    try:
        flow = compute_flow(f1, f2, cfg)
        return flow, trace.collect()
    finally:
        trace.disable()
        trace.TRACER.__init__()


def test_equals_the_plain_reference_96x128():
    got, _ = traced(UPSTREAM_CONFIG, 96, 128)
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(96, 128, 3, -2,
                                                        seed=0))
    rcfg = reference.config_from_dict(dataclasses.asdict(UPSTREAM_CONFIG))
    assert torch.equal(got, reference.compute_flow(f1, f2, rcfg))
    inner = got.numpy()[16:-16, 16:-16]
    assert np.abs(inner - [3.0, -2.0]).max(axis=-1).mean() < 0.5


def test_contract_with_jax_96x160():
    jcfg = _from_dict(JaxConfig, dataclasses.asdict(UPSTREAM_CONFIG))
    f1, f2 = shifted_pair(96, 160, -4, 2, seed=3)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, jcfg))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                       UPSTREAM_CONFIG)
    assert_contract(got.numpy(), want)


def stage_names(tr, top_only):
    marked = sorted((s for s in tr.spans if not s.host),
                    key=lambda s: (s.start_ns, s.id))
    ids = {s.id for s in marked}
    return [s.name for s in marked if not (top_only and s.parent in ids)]


def test_legacy_marks_nest_in_the_occlusion_stage():
    _, tr = traced(UPSTREAM_CONFIG, 96, 128)
    names = stage_names(tr, top_only=False)
    i = names.index("occlusion")
    assert names[i:i + 3] == ["occlusion", "occlusion.wmf", "occlusion.fill"]
    (occ,) = tr.named("occlusion")
    kids = sorted(tr.children(occ), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["occlusion.wmf", "occlusion.fill"]
    assert kids[0].start_ns >= occ.start_ns and kids[1].end_ns == occ.end_ns
    # the stages one level down are the benchmark's copy's
    chain = []
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(24, 32, 1, 0, 0))
    bench_stages(f1, f2, UPSTREAM_CONFIG,
                 lambda name, fn, *a: chain.append(name) or fn(*a))
    assert stage_names(tr, top_only=True) == chain


def test_default_marks_are_unchanged():
    _, tr = traced(DEFAULT_CONFIG, 48, 64)
    assert stage_names(tr, top_only=False) == [
        "prepare", "match", "lr_check", "outliers", "occlusion",
        "L1.upsample", "L1.pass1", "L1.pass2", "L1.smooth",
        "L0.upsample", "L0.pass1", "L0.pass2", "L0.smooth", "final_smooth"]


def stretch(names_ms, pairs=(1, 2, 3)):
    """A made-up span stretch: each pair holds device spans of these
    (name, ms) and a ``graph`` span; pair p's spans last p times as
    long."""
    out, i = [], 0
    for p in pairs:
        t = 0
        for name, ms in list(names_ms) + [("graph", 1.0)]:
            i += 1
            ns = int(ms * p * 1e6)
            out.append(Span(i, name, t, t + ns, None, p, "device:cuda:0"))
            t += ns
    return spans.Stretch(types.SimpleNamespace(spans=out), list(pairs))


def run_of(config, s, h=480, w=640):
    run = Run([1.0], 1.0, 1.0, json.loads(json.dumps(
        dataclasses.asdict(config))), h, w)
    run.spans = s
    return run


UPSTREAM_SPANS = [("occlusion", 0.5), ("occlusion.wmf", 2.0),
                  ("occlusion.fill", 0.25), ("L1.gather_refine", 1.5),
                  ("L1.smooth", 0.5), ("L0.gather_refine", 4.0)]


def test_readers_give_the_hand_values():
    run = run_of(UPSTREAM_CONFIG, stretch(UPSTREAM_SPANS))
    # the median pair (p = 2) of the summed spans
    assert gather_refine_span_ms.read(run) == 2 * (1.5 + 4.0)
    assert occlusion_wmf_span_ms.read(run) == 2 * 2.0
    # kernel E's operations a (candidate, table, pixel): 100 taps of 82,
    # 4 chunks of 2, the division and max 2; 3 minima over the 4 tables;
    # 9 candidates at 480x640 and 240x320, over 67 TFLOP/s (the bytes,
    # 44 a pixel a launch, bound less)
    least_ms = 9 * (4 * (100 * 82 + 4 * 2 + 2) + 3) * (
        480 * 640 + 240 * 320) / 67e12 * 1e3
    pct = gather_refine_roofline_pct.read(run)
    assert abs(pct - 100 * least_ms / 11.0) < 1e-9
    assert 0 < pct < 100


def test_readers_give_nothing_without_their_spans():
    parent_like = [(n, ms) for n, ms in UPSTREAM_SPANS
                   if not n.startswith("occlusion.")]
    run = run_of(UPSTREAM_CONFIG, stretch(parent_like))
    assert occlusion_wmf_span_ms.read(run) is None
    assert gather_refine_span_ms.read(run) is not None
    dense = run_of(DEFAULT_CONFIG, stretch([("L0.pass1", 3.0),
                                            ("occlusion", 1.0)]))
    assert gather_refine_span_ms.read(dense) is None
    assert gather_refine_roofline_pct.read(dense) is None
    assert occlusion_wmf_span_ms.read(dense) is None
    off_card = run_of(UPSTREAM_CONFIG, None)
    for reader in (gather_refine_span_ms, gather_refine_roofline_pct,
                   occlusion_wmf_span_ms):
        assert reader.read(off_card) is None
    unequal = stretch(UPSTREAM_SPANS)
    unequal.equal = False
    assert gather_refine_span_ms.read(run_of(UPSTREAM_CONFIG,
                                             unequal)) is None
