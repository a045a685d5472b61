"""Score-network training (DSM + optimizer + EMA)."""

from .score import (
    Optimizer, ScoreTrainer, ScoreTrainState, make_eval_loss, make_optimizer,
    make_score_train_step,
)

__all__ = ["Optimizer", "ScoreTrainState", "ScoreTrainer", "make_eval_loss",
           "make_optimizer", "make_score_train_step"]
