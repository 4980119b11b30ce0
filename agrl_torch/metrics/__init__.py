"""Host-side (NumPy) ranking metrics: copies of agrl_tpu/metrics, which
the Evaluator's host path runs and the device scorers are held against."""

from agrl_torch.metrics.distance import compute_distance_matrix
from agrl_torch.metrics.rank import evaluate_rank
from agrl_torch.metrics.rerank import re_ranking

__all__ = ["compute_distance_matrix", "evaluate_rank", "re_ranking"]
