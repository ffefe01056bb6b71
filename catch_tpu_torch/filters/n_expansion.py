# Copied from catch_tpu/filters/n_expansion.py.
"""Expands 'N' bases in probes into unambiguous bases.

Parity: reference catch/filter/n_expansion_filter.py:42-106.
Probes with no 'N' pass through; probes with n <= limit N's expand to
4^n probes (first-N-first order, expanding each N over A/T/C/G in that
order); beyond the limit, randomly chosen N's are replaced with random
unambiguous bases first.
"""

import random

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.probe import Probe

__all__ = ["NExpansionFilter"]

_REAL_BASES = ["A", "T", "C", "G"]


class NExpansionFilter(BaseFilter):
    """Expands 'N' bases within probes."""

    def __init__(self, limit_n_expansion_randomly=3):
        """
        Args:
            limit_n_expansion_randomly: expand at most this many N's
                (randomly chosen); replace the rest with random
                unambiguous bases. None expands all N's.
        """
        self.limit_n_expansion_randomly = limit_n_expansion_randomly

    def _filter(self, input):
        output = []
        for p in input:
            num_n = p.seq_str.count("N")
            if num_n == 0:
                output.append(p)
                continue

            p_seq_init = p.seq_str
            limit = self.limit_n_expansion_randomly
            if limit is not None and num_n > limit:
                occurrences = [i for i, base in enumerate(p_seq_init)
                               if base == "N"]
                seq_list = list(p_seq_init)
                while len(occurrences) > limit:
                    occ = random.choice(occurrences)
                    seq_list[occ] = random.choice(_REAL_BASES)
                    occurrences.remove(occ)
                p_seq_init = "".join(seq_list)

            expanded = [p_seq_init]
            while any("N" in s for s in expanded):
                updated = []
                for s in expanded:
                    n_pos = s.find("N")
                    if n_pos == -1:
                        updated.append(s)
                        continue
                    s_list = list(s)
                    for b in _REAL_BASES:
                        s_list[n_pos] = b
                        updated.append("".join(s_list))
                expanded = updated

            output.extend(Probe.from_str(s) for s in expanded)
        return output
