# Copied from catch_tpu/filters/dominating_set.py.
"""Dominating-set baseline filter (used by design_naively).

Parity: reference catch/filter/dominating_set_filter.py:41-92 —
build a redundancy graph and reduce dominating set to set cover
(each probe's set = itself plus all probes redundant to it).
"""

from collections import defaultdict
import logging

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.filters import naive_redundant
from catch_tpu_torch.ops import set_cover

logger = logging.getLogger(__name__)

__all__ = ["DominatingSetFilter"]


class DominatingSetFilter(BaseFilter):
    """Selects probes via a dominating-set reduction to set cover."""

    def __init__(self, are_redundant_fn=None):
        if are_redundant_fn is None:
            are_redundant_fn = \
                naive_redundant.redundant_shift_and_mismatch_count(
                    shift=0, mismatch_thres=0)
        self.are_redundant_fn = are_redundant_fn

    def _filter(self, input):
        input = list(input)
        sets = defaultdict(set)
        for i in range(len(input)):
            if i % 100 == 0:
                logger.info("Making set for candidate probe %d of %d",
                            i + 1, len(input))
            probe_a = input[i]
            sets[i].add(probe_a)
            for j in range(i + 1, len(input)):
                probe_b = input[j]
                if self.are_redundant_fn(probe_a, probe_b):
                    sets[i].add(probe_b)
                    sets[j].add(probe_a)

        set_ids_in_cover = set_cover.approx(sets)
        return [input[i] for i in sorted(set_ids_in_cover)]
