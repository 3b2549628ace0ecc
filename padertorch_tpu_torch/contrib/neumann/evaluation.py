"""Nested evaluation-result aggregation.

Copy of ``padertorch_tpu/contrib/neumann/evaluation.py``.

Reference parity: ``padertorch/contrib/neumann/evaluation.py:13``
(``compute_means``).
"""
import numpy as np

__all__ = ['compute_means']


def compute_means(results):
    """Mean over examples of (possibly nested) numeric metric dicts.

    >>> compute_means({'a': {'pesq': 1.0, 'nested': {'x': 2.0}},
    ...                'b': {'pesq': 3.0, 'nested': {'x': 4.0}}})
    {'pesq': 2.0, 'nested': {'x': 3.0}}
    """
    collected = {}

    def collect(d, out):
        for k, v in d.items():
            if isinstance(v, dict):
                collect(v, out.setdefault(k, {}))
            elif isinstance(v, (int, float, np.number, np.ndarray)):
                out.setdefault(k, []).append(np.mean(v))

    for example_result in results.values():
        collect(example_result, collected)

    def reduce(out):
        return {
            k: reduce(v) if isinstance(v, dict) else float(np.mean(v))
            for k, v in out.items()
        }

    return reduce(collected)
