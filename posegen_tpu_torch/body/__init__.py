"""Body models (port of posegen_tpu/body/): linear blend skinning and SMPL.
`models.py` (SMPL-X, MANO, FLAME) and `transfer.py` are not ported yet."""

from posegen_tpu_torch.body.lbs import (  # noqa: F401
    batch_rigid_transform,
    blend_shapes,
    lbs,
    vertices2joints,
)
from posegen_tpu_torch.body.smpl import SMPLModel, load_smpl_model, make_random_model  # noqa: F401
