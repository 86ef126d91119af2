from dldkd_tpu_torch.models.components import (AttentionBlock,
                                               LinearInputProj,
                                               TrainablePositionalEncoding)
from dldkd_tpu_torch.models.dldkd import DLDKD, Branch

__all__ = ["AttentionBlock", "Branch", "DLDKD", "LinearInputProj",
           "TrainablePositionalEncoding"]
