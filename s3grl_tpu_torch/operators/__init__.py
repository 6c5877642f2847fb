from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.operators.pos import precompute_pos
from s3grl_tpu_torch.operators.sop import precompute_sop

__all__ = ["OperatorDataset", "precompute_pos", "precompute_sop"]
