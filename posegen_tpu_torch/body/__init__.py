"""Body models (port of posegen_tpu/body/): linear blend skinning, SMPL,
SMPL-X / MANO / FLAME (`models.py`) and the parameter-transfer fit
(`transfer.py`)."""

from posegen_tpu_torch.body.lbs import (  # noqa: F401
    batch_rigid_transform,
    blend_shapes,
    lbs,
    vertices2joints,
)
from posegen_tpu_torch.body.models import (  # noqa: F401
    FLAMEModel,
    MANOModel,
    SMPLXModel,
    SMPLX_JOINT_NAMES,
    VERTEX_IDS,
    load_flame_model,
    load_mano_model,
    load_smplx_model,
)
from posegen_tpu_torch.body.smpl import SMPLModel, load_smpl_model, make_random_model  # noqa: F401
