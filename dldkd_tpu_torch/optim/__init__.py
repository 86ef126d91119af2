from dldkd_tpu_torch.optim import schedules
from dldkd_tpu_torch.optim.bert_adam import BertAdam, default_wd_mask
from dldkd_tpu_torch.optim.ema import ema_init, ema_swap, ema_update

__all__ = ["BertAdam", "default_wd_mask", "schedules",
           "ema_init", "ema_update", "ema_swap"]
