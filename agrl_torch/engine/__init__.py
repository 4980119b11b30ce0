"""Engine: the train step (`trainer`), the Evaluator and the eval forward
(`evaluator`), and serving (`export`: the FeatureExtractor and the
torch.export artifact)."""

from agrl_torch.engine.trainer import make_train_step

__all__ = ["make_train_step"]
