"""Python-side running averages.

Parity: python/paddle/fluid/average.py (WeightedAverage) and the JAX
package's average module — pure host bookkeeping, no program mutation.
"""
import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(var):
    return isinstance(var, (int, float)) or (
        isinstance(var, np.ndarray) and var.shape == (1,))


def _is_number_or_matrix(var):
    return _is_number(var) or isinstance(var, np.ndarray)


class WeightedAverage(object):
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
