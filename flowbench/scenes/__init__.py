"""Scene kinds of a pool, one module each, found by a scene's ``"kind"``
(``generator.scene``): each exposes ``render(g, rng, spec, h, w,
device)``, the pair's two frames as float32 (H, W, 3) in [0, 1]."""
