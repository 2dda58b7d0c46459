from .ema import ema_init, ema_update  # noqa: F401
from .optim import ClippedAdam, cosine_lr  # noqa: F401
from .state import TrainState, create_train_state  # noqa: F401
from .step import StepDraws, StepMetrics, draw_step, make_train_step  # noqa: F401
