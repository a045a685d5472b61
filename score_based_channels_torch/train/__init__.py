"""Score-network training (DSM + optimizer + EMA)."""

from .score import (
    Optimizer, ScoreTrainer, ScoreTrainState, TrainChunkRunner,
    make_eval_loss, make_optimizer, make_score_train_step, make_score_update,
)

__all__ = ["Optimizer", "ScoreTrainState", "ScoreTrainer", "TrainChunkRunner",
           "make_eval_loss", "make_optimizer", "make_score_train_step",
           "make_score_update"]
