"""Classification / regression / ranking metrics.

Same formula set as the reference `Metrics.py` (confusion-matrix-derived
rates `Metrics.py:136-176`, sklearn regression scores `:188-216`,
ranking hitrate `:242-250`, AUC `:252-260`), including the binarization
polarity quirk Q9: for `fnat` / `bin_class` higher is better (value >
threshold -> 1), for rmsd-type targets lower is better (value <
threshold -> 1) (`Metrics.py:26-31`).

The port's own copy of ``deeprank_gnn_tpu/train/metrics.py``; scikit-learn
is imported only inside the functions that use it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

INVERSE_TARGETS = ("fnat", "bin_class")


def get_binary(values: Sequence[float], threshold: float, target: str) -> List[int]:
    """Binarize values with target-dependent polarity (`Metrics.py:10-32`)."""
    if target in INVERSE_TARGETS:
        return [1 if x > threshold else 0 for x in values]
    return [1 if x < threshold else 0 for x in values]


def get_comparison(prediction, ground_truth, binary=True, classes=(0, 1)):
    """FP/FN/TP/TN from the confusion matrix (`Metrics.py:35-66`)."""
    from sklearn.metrics import confusion_matrix

    cm = confusion_matrix(ground_truth, prediction, labels=list(classes))
    false_positive = cm.sum(axis=0) - np.diag(cm)
    false_negative = cm.sum(axis=1) - np.diag(cm)
    true_positive = np.diag(cm)
    true_negative = cm.sum() - (false_positive + false_negative + true_positive)
    if binary:
        return (
            false_positive[1],
            false_negative[1],
            true_positive[1],
            true_negative[1],
        )
    return false_positive, false_negative, true_positive, true_negative


def _safe_ratio(num, den):
    try:
        with np.errstate(divide="ignore", invalid="ignore"):
            val = num / den
        return val
    except Exception:
        return None


class Metrics:
    """Metric bundle over prediction/target vectors (`Metrics.py:69-260`)."""

    def __init__(self, prediction, y, target, threshold=4, binary=True):
        self.prediction = list(prediction)
        self.y = list(y)
        self.binary = binary
        self.target = target
        self.threshold = threshold

        if binary:
            pred_b = get_binary(self.prediction, threshold, target)
            y_b = get_binary(self.y, threshold, target)
            fp, fn, tp, tn = get_comparison(pred_b, y_b, True, classes=(0, 1))
        else:
            if target == "capri_class":
                classes = (1, 2, 3, 4, 5)
            elif target == "bin_class":
                classes = (0, 1)
            else:
                raise ValueError("target must be capri_class or bin_class")
            fp, fn, tp, tn = get_comparison(
                self.prediction, self.y, False, classes=classes
            )

        self.sensitivity = _safe_ratio(tp, tp + fn)
        self.specificity = _safe_ratio(tn, tn + fp)
        self.precision = _safe_ratio(tp, tp + fp)
        self.NPV = _safe_ratio(tn, tn + fn)
        self.FPR = _safe_ratio(fp, fp + tn)
        self.FNR = _safe_ratio(fn, tp + fn)
        self.FDR = _safe_ratio(fp, tp + fp)
        self.accuracy = (tp + tn) / (tp + fp + fn + tn)

        self.explained_variance = None
        self.max_error = None
        self.mean_absolute_error = None
        self.mean_squared_error = None
        self.root_mean_squared_error = None
        self.mean_squared_log_error = None
        self.median_squared_log_error = None
        self.r2_score = None

        if target in ("fnat", "irmsd", "lrmsd"):
            from sklearn import metrics as skm

            self.explained_variance = skm.explained_variance_score(
                self.y, self.prediction
            )
            self.max_error = skm.max_error(self.y, self.prediction)
            self.mean_absolute_error = skm.mean_absolute_error(
                self.y, self.prediction
            )
            mse = skm.mean_squared_error(self.y, self.prediction)
            self.mean_squared_error = mse
            self.root_mean_squared_error = float(np.sqrt(mse))
            try:
                self.mean_squared_log_error = skm.mean_squared_log_error(
                    self.y, self.prediction
                )
            except ValueError:
                print(
                    "WARNING: Mean Squared Logarithmic Error cannot be used "
                    "when targets contain negative values."
                )
            self.median_squared_log_error = skm.median_absolute_error(
                self.y, self.prediction
            )
            self.r2_score = skm.r2_score(self.y, self.prediction)

    def format_score(self):
        """Rank predictions (higher-better for fnat/bin_class, Q9)."""
        idx = np.argsort(self.prediction)
        if self.target in INVERSE_TARGETS:
            idx = idx[::-1]
        ground_truth_bool = np.array(get_binary(self.y, self.threshold, self.target))
        return idx, ground_truth_bool

    def hitrate(self):
        idx, ground_truth_bool = self.format_score()
        return np.cumsum(ground_truth_bool[idx])

    def auc(self):
        from sklearn.metrics import roc_auc_score

        idx, ground_truth_bool = self.format_score()
        return roc_auc_score(ground_truth_bool, idx)
