from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .train_step import make_eval_step, make_train_step
