# Copied from catch_tpu/probe.py.
"""Probe: an immutable oligo sequence, byte-array backed.

Capability parity with the reference Probe class
(reference catch/probe.py:38-353): mismatch counting (including
shifted offsets), longest-common-substring length, reverse complement
(non-ACGT bases map to themselves), adapter prepend/append, k-mer
construction, the randomized shared-k-mer heuristic with memoization,
and the probe identifier (final 10 hex chars of the SHA-224 of the
sequence, so output FASTA headers match reference headers bit-for-bit).

Design difference: sequences are stored as uint8 ASCII arrays (one byte
per base) rather than numpy 'U1' (4 bytes/char).  This is the same
encoding the TPU engine consumes (catch_tpu/ops/encode.py), so handing a
batch of probes to the device is a single stack+pad, no re-encoding.
"""

import hashlib

import numpy as np

__all__ = ["Probe"]

# Byte-level reverse-complement LUT: A<->T, C<->G, everything else itself.
_RC_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")]:
    _RC_LUT[ord(_a)] = ord(_b)
    _RC_LUT[ord(_b)] = ord(_a)


def seq_to_bytes(seq_str):
    """Encode a sequence string to a uint8 ASCII array."""
    return np.frombuffer(seq_str.encode("ascii"), dtype=np.uint8).copy()


class Probe:
    """Immutable sequence representing a probe/bait."""

    __slots__ = ("seq_bytes", "seq_str", "is_flanking_n_string", "header",
                 "_kmers", "_kmers_rand_choices", "_hash")

    def __init__(self, seq):
        """
        Args:
            seq: probe sequence as a str, uint8 np.array (ASCII codes),
                or 'U1' np.array (accepted for compatibility)
        """
        if isinstance(seq, str):
            self.seq_str = seq
            self.seq_bytes = seq_to_bytes(seq)
        elif isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
            self.seq_bytes = seq
            self.seq_str = seq.tobytes().decode("ascii")
        elif isinstance(seq, np.ndarray):
            self.seq_str = "".join(seq)
            self.seq_bytes = seq_to_bytes(self.seq_str)
        else:
            raise TypeError("seq must be a str or np.ndarray")
        self.is_flanking_n_string = False
        self.header = None
        self._kmers = {}
        self._kmers_rand_choices = {}
        self._hash = None

    @property
    def seq(self):
        """Sequence as a numpy 'U1' array (reference-compatible view)."""
        return np.array(list(self.seq_str), dtype="U1")

    def mismatches(self, other):
        """Count mismatches with another equal-length probe."""
        return self.mismatches_at_offset(other, 0)

    def mismatches_at_offset(self, other, offset):
        """Count mismatches with `other` shifted by `offset` bp."""
        if len(self.seq_bytes) != len(other.seq_bytes):
            raise ValueError("Sequences must be of same length")
        if abs(offset) >= len(other.seq_bytes):
            raise ValueError("Invalid offset value " + str(offset))
        a, b = self.seq_bytes, other.seq_bytes
        if offset == 0:
            return int(np.sum(a != b))
        elif offset < 0:
            return int(np.sum(a[:offset] != b[-offset:]))
        else:
            return int(np.sum(a[offset:] != b[:-offset]))

    def min_mismatches_within_shift(self, other, max_shift):
        return min(self.mismatches_at_offset(other, o)
                   for o in range(-max_shift, max_shift + 1))

    def longest_common_substring_length(self, other, k):
        """Length of longest common substring with <= k mismatches."""
        from catch_tpu_torch.utils import lcs
        length, _, _ = lcs.k_lcf(self.seq_bytes, other.seq_bytes, k)
        return length

    def reverse_complement(self):
        """Reverse complement; non-ACGT bases map to themselves."""
        return Probe(_RC_LUT[self.seq_bytes[::-1]])

    def with_prepended_str(self, s):
        return Probe(s + self.seq_str)

    def with_appended_str(self, s):
        return Probe(self.seq_str + s)

    def construct_kmers(self, k, include_positions=False):
        """All k-mers of this probe in positional order."""
        s = self.seq_str
        if include_positions:
            return [(s[i:i + k], i) for i in range(len(s) - k + 1)]
        return [s[i:i + k] for i in range(len(s) - k + 1)]

    def shares_some_kmers(self, other, k=20, num_kmers_to_test=10,
                          memoize_kmers=True, return_kmer=False):
        """Randomized test of whether self and other share any k-mer.

        Samples num_kmers_to_test k-mers (with multiplicity weighting)
        from self and checks membership in other's k-mer set.  False
        negatives occur with probability
        (1 - N/(len-k+1))^num_kmers_to_test for N shared k-mers
        (reference contract: reference catch/probe.py:184-299).
        """
        if memoize_kmers:
            if k not in other._kmers:
                other._kmers[k] = set(other.construct_kmers(k))
            key = (k, num_kmers_to_test)
            if key not in self._kmers_rand_choices:
                kmers_list = self.construct_kmers(k)
                rand = np.random.choice(kmers_list, size=num_kmers_to_test,
                                        replace=True)
                self._kmers_rand_choices[key] = set(rand)
            shared = self._kmers_rand_choices[key] & other._kmers[k]
            if shared:
                return next(iter(shared)) if return_kmer else True
            return False
        else:
            positions = np.random.randint(
                0, len(self.seq_bytes) - k + 1, num_kmers_to_test)
            for pos in positions:
                kmer = self.seq_str[pos:pos + k]
                if kmer in other.seq_str:
                    return kmer if return_kmer else True
            return False

    def identifier(self, length=10):
        """Final `length` hex chars of the SHA-224 of the sequence."""
        return hashlib.sha224(self.seq_str.encode()).hexdigest()[-length:]

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(self.seq_str)
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Probe) and self.seq_str == other.seq_str

    def __len__(self):
        return len(self.seq_bytes)

    def __getitem__(self, i):
        return self.seq_str[i]

    def __str__(self):
        return self.seq_str

    def __repr__(self):
        return self.seq_str

    @staticmethod
    def from_str(seq_str):
        return Probe(seq_str)
