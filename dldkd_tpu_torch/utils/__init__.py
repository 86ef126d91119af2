from dldkd_tpu_torch.utils.logging import MetricsWriter, setup_logging
from dldkd_tpu_torch.utils.meters import AverageMeter
from dldkd_tpu_torch.utils.preemption import PreemptionGuard
from dldkd_tpu_torch.utils.provenance import make_code_zip

__all__ = ["AverageMeter", "MetricsWriter", "PreemptionGuard",
           "make_code_zip", "setup_logging"]
