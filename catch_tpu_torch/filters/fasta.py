# Copied from catch_tpu/filters/fasta.py.
"""Keeps only probes whose sequence appears in a given FASTA file.

Parity: reference catch/filter/fasta_filter.py:19-66: output
probes are reordered to match the file's sequence order; headers
containing "reverse complement" can be skipped.  Used with
--skip-set-cover to re-process an existing design.
"""

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.utils import seq_io

__all__ = ["FastaFilter"]


class FastaFilter(BaseFilter):
    """Selects only probes equal to a sequence in a FASTA file."""

    def __init__(self, fasta_path, skip_reverse_complements=False):
        self.fasta_path = fasta_path
        self.skip_reverse_complements = skip_reverse_complements

    def _filter(self, input):
        fasta = seq_io.read_fasta(self.fasta_path)
        seqs_to_keep = {}
        for i, (header, seq) in enumerate(fasta.items()):
            if self.skip_reverse_complements and \
                    "reverse complement" in header:
                continue
            seqs_to_keep[seq] = i

        filtered = []
        for p in input:
            if p.seq_str in seqs_to_keep:
                filtered.append((seqs_to_keep[p.seq_str], p))
        filtered.sort(key=lambda t: t[0])
        return [p for _, p in filtered]
