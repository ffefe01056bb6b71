# Copied from catch_tpu/filters/reverse_complement.py.
"""Adds the reverse complement of each probe, interleaved.

Parity: reference catch/filter/reverse_complement_filter.py:18-34,
including the FASTA header contract (``probe_<id> | from target
sequence`` / ``probe_<rcid> | reverse complement of probe_<id>``).
"""

from catch_tpu_torch.filters.base import BaseFilter

__all__ = ["ReverseComplementFilter"]


class ReverseComplementFilter(BaseFilter):
    """Returns each input probe followed by its reverse complement."""

    def _filter(self, input):
        output = []
        for p in input:
            p.header = "probe_%s | from target sequence" % p.identifier()
            output.append(p)
            p_rc = p.reverse_complement()
            p_rc.header = "probe_%s | reverse complement of probe_%s" % (
                p_rc.identifier(), p.identifier())
            output.append(p_rc)
        return output
