"""DINOv2's frozen-feature evaluations (counterpart of the JAX package's
`evals/`): metrics, feature extraction, k-NN, the linear-probe grid and
the logistic-regression sweep."""

from .metrics import MetricAccumulator, build_metric, real_accuracy, topk_accuracy
from .features import ModelWithIntermediateLayers, extract_features
from .knn import knn_classify
from .linear import LinearProbeGrid
from .log_regression import logreg_sweep
