from .checkpoint import (  # noqa: F401
    load_content,
    load_content_args,
    save_content,
    save_netg,
)
from .ema import ema_init, ema_update  # noqa: F401
from .loop import build_adam_state, build_models, train  # noqa: F401
from .optim import ClippedAdam, cosine_lr  # noqa: F401
from .pso_optim import AdaptivePSO, PSODraws, PSOState  # noqa: F401
from .pso_step import (  # noqa: F401
    PSOTrainState,
    create_pso_train_state,
    make_pso_epoch_end,
    make_pso_train_step,
    pad_epoch_losses,
)
from .state import TrainState, create_train_state  # noqa: F401
from .step import StepDraws, StepMetrics, draw_step, make_train_step  # noqa: F401
from .zero1 import Zero1Adam  # noqa: F401
