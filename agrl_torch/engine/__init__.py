"""Engine: the train step (`trainer`), the Evaluator (`evaluator`) and the
live-model FeatureExtractor (`export`)."""

from agrl_torch.engine.trainer import make_train_step

__all__ = ["make_train_step"]
