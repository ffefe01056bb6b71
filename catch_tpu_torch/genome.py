# Copied from catch_tpu/genome.py.
"""Genome: an immutable collection of chromosome sequences.

Capability parity with the reference Genome
(reference catch/genome.py:9-143): size (optionally counting only
unambiguous A/T/C/G), fragmentation for clustering (with
``include_full_end`` taking the final ``fragment_length`` nt for a short
tail), construction from one sequence or an ordered chromosome map, and
hashing/equality by sequence content.
"""

from collections import OrderedDict

__all__ = ["Genome"]

_UNAMBIG = ("A", "T", "C", "G")


class Genome:
    """Immutable genome as a list of chromosome sequence strings."""

    def __init__(self, seqs, chrs=None):
        """
        Args:
            seqs: list of sequences (chromosomes) making up this genome
            chrs: OrderedDict mapping chromosome labels to sequences;
                required when len(seqs) > 1
        """
        if len(seqs) > 1 and chrs is None:
            raise ValueError(
                "chrs must be given when a genome has multiple sequences")
        self.seqs = seqs
        self.chrs = chrs
        self._hash = None
        self._size = None
        self._size_unambig = None

    def divided_into_chrs(self):
        return len(self.seqs) > 1

    def size(self, only_unambig=False):
        """Total genome length; only A/T/C/G when only_unambig."""
        if only_unambig:
            if self._size_unambig is None:
                self._size_unambig = sum(
                    seq.count(b) for seq in self.seqs for b in _UNAMBIG)
            return self._size_unambig
        if self._size is None:
            self._size = sum(len(seq) for seq in self.seqs)
        return self._size

    def break_into_fragments(self, fragment_length, include_full_end=False):
        """Return a new Genome with sequences split into fragments.

        When include_full_end is set and the final fragment of a sequence
        would be short, the final fragment is instead the last
        ``fragment_length`` nt of the sequence.
        """
        def fragments(seq):
            for i in range(0, len(seq), fragment_length):
                frag = seq[i:i + fragment_length]
                if include_full_end and len(frag) < fragment_length:
                    yield seq[max(0, len(seq) - fragment_length):]
                else:
                    yield frag

        out = OrderedDict()
        if self.chrs is None:
            assert len(self.seqs) == 1
            for i, frag in enumerate(fragments(self.seqs[0])):
                out[str(i)] = frag
        else:
            for name, seq in self.chrs.items():
                for i, frag in enumerate(fragments(seq)):
                    out[f"{name}-{i}"] = frag
        return Genome.from_chrs(out)

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(tuple(self.seqs))
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Genome) and \
            self.seqs == other.seqs and self.chrs == other.chrs

    @staticmethod
    def from_chrs(seqs_by_chr):
        for seq in seqs_by_chr.values():
            if not isinstance(seq, str):
                raise TypeError("Sequences must be strings")
        return Genome(list(seqs_by_chr.values()), seqs_by_chr)

    @staticmethod
    def from_one_seq(seq):
        if not isinstance(seq, str):
            raise TypeError("seq must be a string")
        return Genome([seq])
