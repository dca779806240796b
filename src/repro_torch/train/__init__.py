"""Training: the train step (loss -> grads -> clip -> LR -> AdamW) and the
fault-tolerant Trainer."""
from repro_torch.train.loop import Trainer, make_train_state, make_train_step  # noqa: F401
