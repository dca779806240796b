"""Optimizer substrate: AdamW, the cosine schedule, global-norm clipping."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
