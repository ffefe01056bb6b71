# Copied from catch_tpu/ops/encode.py.
"""Sequence encoding for the TPU engine.

Sequences and probes are byte strings over an arbitrary uppercase
alphabet (real genomes use A/C/G/T/N after seq_io normalization; the
test-suite convention of contrived alphabets like 'ABCDEFGH...' must
also work, mirroring the reference's tests).  We therefore build a
*dynamic* alphabet: each distinct byte observed maps to a small positive
code; code 0 is reserved as PAD and never matches anything (its one-hot
row is all zeros).

'N' semantics fall out of byte equality, exactly as in the reference
(which compares characters with ``!=``; reference catch/probe.py:84-88):
N matches N and mismatches everything else.
"""

import numpy as np

__all__ = ["Alphabet", "make_alphabet", "encode_bytes", "pad_and_stack"]


class Alphabet:
    """Mapping from sequence bytes to dense codes (0 = PAD, never matches)."""

    def __init__(self, lut, size):
        self.lut = lut          # (256,) uint8: byte -> code (0 if unseen)
        self.size = size        # number of real codes (codes are 1..size)

    def encode(self, seq_bytes):
        """uint8 ASCII array -> uint8 code array."""
        return self.lut[seq_bytes]

    def encode_str(self, s):
        return self.encode(np.frombuffer(s.encode("ascii"), dtype=np.uint8))


def make_alphabet(byte_arrays):
    """Build an Alphabet covering every byte in the given uint8 arrays."""
    seen = np.zeros(256, dtype=bool)
    for arr in byte_arrays:
        if len(arr):
            seen[np.unique(arr)] = True
    codes = np.flatnonzero(seen)
    lut = np.zeros(256, dtype=np.uint8)
    lut[codes] = np.arange(1, len(codes) + 1, dtype=np.uint8)
    return Alphabet(lut, len(codes))


def encode_bytes(s):
    """Sequence string -> uint8 ASCII array."""
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8)


def pad_and_stack(code_arrays, width=None, pad_value=0):
    """Stack 1-D code arrays into a (N, width) matrix, PAD-filled."""
    if width is None:
        width = max((len(a) for a in code_arrays), default=0)
    out = np.full((len(code_arrays), width), pad_value, dtype=np.uint8)
    for i, a in enumerate(code_arrays):
        out[i, :len(a)] = a
    return out


def next_pow2(x):
    """Smallest power of two >= x (min 1); used for shape bucketing."""
    if x <= 1:
        return 1
    return 1 << (int(x - 1).bit_length())
