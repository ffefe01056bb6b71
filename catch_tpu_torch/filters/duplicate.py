# Copied from catch_tpu/filters/duplicate.py.
"""Exact duplicate removal, preserving first-occurrence order.

Parity: reference catch/filter/duplicate_filter.py:16-27.
"""

from collections import OrderedDict

from catch_tpu_torch.filters.base import BaseFilter

__all__ = ["DuplicateFilter"]


class DuplicateFilter(BaseFilter):
    """Removes exact duplicate probes (by sequence)."""

    def _filter(self, input):
        return list(OrderedDict.fromkeys(input))
