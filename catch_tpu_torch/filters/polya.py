# Copied from catch_tpu/filters/polya.py.
"""Removes probes containing long poly(A) / poly(T) stretches.

Parity: reference catch/filter/polya_filter.py:18-71: drop probes
with >= ``length`` A's (or T's) in a row tolerating <= ``mismatches``
mismatches; an exact-run prescreen of ``min_exact_length_to_consider``
bases limits the expensive LCS checks (and is part of the behavioral
contract: probes without the exact run are kept).
"""

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.probe import Probe

__all__ = ["PolyAFilter"]


class PolyAFilter(BaseFilter):
    """Removes probes with poly(A) or poly(T) runs."""

    def __init__(self, length, mismatches, min_exact_length_to_consider=6):
        self.length = length
        self.mismatches = mismatches
        self.min_exact_length_to_consider = min_exact_length_to_consider

    def _filter(self, input):
        if len(input) == 0:
            return input

        exact_a = "A" * self.min_exact_length_to_consider
        exact_t = "T" * self.min_exact_length_to_consider

        probe_len = max(len(p) for p in input)
        a_stretch = Probe.from_str("A" * probe_len)
        t_stretch = Probe.from_str("T" * probe_len)

        out = []
        for p in input:
            keep = True
            if exact_a in p.seq_str or exact_t in p.seq_str:
                for stretch in (a_stretch, t_stretch):
                    lcf_len = p.longest_common_substring_length(
                        stretch, self.mismatches)
                    if lcf_len >= self.length:
                        keep = False
                        break
            if keep:
                out.append(p)
        return out
