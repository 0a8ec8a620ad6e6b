"""The multi-device path of the port (counterpart of ``eppm_tpu/
parallel/``): a (batch, y, x) mesh of torch devices driven by one
controller, halo exchange between tiles, and ``compute_flow_sharded``."""

from .halo import halo_exchange_1d, halo_exchange_2d
from .sharded import (Mesh, check_tileable, compute_flow_sharded, make_mesh,
                      pad_to_tileable)
