"""Traffic generators, one module each, found by the ``"generator"`` of a
traffic file (``generator.kind``): each exposes ``make(spec, seed,
device, seconds)``."""
