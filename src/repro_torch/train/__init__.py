"""Training substrate: optimizer, loop, fault tolerance."""
from .fault import PreemptionHandler, StepWatchdog, retry  # noqa: F401
from .optimizer import (OptimizerConfig, adamw_update,  # noqa: F401
                        compress_grads, init_opt_state, lr_schedule)
from .train_loop import TrainConfig, Trainer, make_train_step  # noqa: F401
