"""``eppm_tpu_torch.ops.resize.pyramid_dims`` against the JAX package's
``eppm_tpu.ops.resize.pyramid_dims``: the per-level sizes, truncated, for
the shapes and pyramid settings the repo's configurations use."""

import pytest

from eppm_tpu.ops import resize as jresize

from eppm_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("h,w", [(480, 640), (436, 1024), (375, 1242),
                                 (1080, 1920), (2160, 3840), (7, 11)])
@pytest.mark.parametrize("max_depth,ratio", [(3, 0.5), (4, 0.5), (0, 0.5),
                                             (5, 0.75)])
def test_pyramid_dims_match_jax(h, w, max_depth, ratio):
    got = tresize.pyramid_dims(h, w, max_depth, ratio)
    assert got == jresize.pyramid_dims(h, w, max_depth, ratio)
    assert len(got) == max(max_depth, 1) and got[0] == (h, w)
