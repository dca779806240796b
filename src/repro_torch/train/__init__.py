"""Training and serving loops: the train step (loss -> grads -> clip -> LR
-> AdamW), the fault-tolerant Trainer, and the serving entry points."""
from repro_torch.train.loop import Trainer, make_train_state, make_train_step  # noqa: F401
from repro_torch.train.serve import greedy_generate, make_serve_step  # noqa: F401
