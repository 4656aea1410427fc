from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import make_schedule
