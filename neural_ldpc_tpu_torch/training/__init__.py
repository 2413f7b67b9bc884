from .loss import multi_iteration_loss
from .lr_schedule import LearningRate
from .train_loop import TrainConfig, Trainer, make_eval_step, make_train_step
