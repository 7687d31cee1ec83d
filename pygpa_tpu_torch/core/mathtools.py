"""Elementwise maths (counterpart of pygpa_tpu/core/mathtools.py)."""
import math


def wrap_to_pi(x):
    """Wrap all values of x to the interval [-pi, pi) (floor modulo,
    as pygpa_tpu.core.mathtools.wrap_to_pi)."""
    return (x + math.pi) % (2 * math.pi) - math.pi
