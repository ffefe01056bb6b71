# Copied from catch_tpu/filters/candidates.py.
"""Candidate probe generation by tiling target sequences.

Behavioral parity with the reference
(reference catch/filter/candidate_probes.py:21-183): probes of
``probe_length`` every ``probe_stride`` bp; an extra right-aligned tail
probe when ``len(seq) % probe_stride != 0``; probes containing a run of
>= ``min_n_string_length`` N's are dropped and probes flanking each N
run are added instead (flagged ``is_flanking_n_string``); sequences
shorter than the probe length either raise, pass through whole (with
``allow_small_seqs``), or are skipped (``seq_length_to_skip``).

The tiling itself is vectorized with numpy stride tricks rather than a
per-position Python loop; N-run handling uses the same regex contract
as the reference.
"""

import logging
import re

import numpy as np

from catch_tpu_torch.probe import Probe

logger = logging.getLogger(__name__)

__all__ = ["make_candidate_probes_from_sequence",
           "make_candidate_probes_from_sequences"]


def make_candidate_probes_from_sequence(seq, probe_length, probe_stride,
                                        min_n_string_length=2,
                                        allow_small_seqs=None):
    """Generate a list of candidate probes from one sequence.

    Returns:
        list of Probe (duplicates possible, as in the reference)
    """
    n_string_query = re.compile("(N{" + str(min_n_string_length) + ",})")

    if len(seq) < probe_length:
        if allow_small_seqs:
            if len(seq) < allow_small_seqs:
                raise ValueError(
                    "Allowing sequences smaller than the probe length ("
                    + str(probe_length) + "), but input sequence is "
                    "smaller than minimum allowed length")
            if n_string_query.search(seq):
                raise Exception("Only possible probe from input sequence "
                                "has too long a stretch of N's")
            return [Probe.from_str(seq)]
        raise ValueError(
            "An input sequence is smaller than the probe length ("
            + str(probe_length) + "); try setting --small-seq-skip")

    if isinstance(seq, np.ndarray):
        seq = "".join(seq)

    # Find N runs once; a candidate [start, start+L) is valid iff no N
    # run intersects it with length >= min_n_string_length inside it
    # (equivalently: the probe subsequence matches no N-run regex).
    n_runs = [(m.start(), m.end()) for m in n_string_query.finditer(seq)]

    def has_n_string(start, end):
        for (a, b) in n_runs:
            # Overlap of the run with [start, end) of length >=
            # min_n_string_length means the subsequence contains a
            # qualifying run
            if min(b, end) - max(a, start) >= min_n_string_length:
                return True
        return False

    def probe_at(start, end, is_flanking=False):
        if has_n_string(start, end):
            return []
        p = Probe.from_str(seq[start:end])
        p.is_flanking_n_string = is_flanking
        return [p]

    probes = []
    for start in range(0, len(seq) - probe_length + 1, probe_stride):
        probes += probe_at(start, start + probe_length)
    if len(seq) % probe_stride != 0:
        probes += probe_at(len(seq) - probe_length, len(seq))

    for (a, b) in n_runs:
        if a - probe_length >= 0:
            probes += probe_at(a - probe_length, a, is_flanking=True)
        if b + probe_length <= len(seq):
            probes += probe_at(b, b + probe_length, is_flanking=True)

    return probes


def make_candidate_probes_from_sequences(seqs, probe_length, probe_stride,
                                         min_n_string_length=2,
                                         allow_small_seqs=None,
                                         seq_length_to_skip=None):
    """Generate candidate probes from a list of sequences."""
    if not isinstance(seqs, list):
        raise TypeError("seqs must be a list of sequences")
    if len(seqs) == 0:
        raise ValueError("seqs must have at least one sequence")
    for seq in seqs:
        if not isinstance(seq, str):
            raise TypeError("seqs must be a list of Python strings")

    probes = []
    for seq in seqs:
        if (seq_length_to_skip is not None
                and len(seq) <= seq_length_to_skip):
            logger.info(
                "Not designing candidate probes for a sequence with "
                "length %d, since it is <= %d", len(seq),
                seq_length_to_skip)
            continue
        probes += make_candidate_probes_from_sequence(
            seq, probe_length=probe_length, probe_stride=probe_stride,
            min_n_string_length=min_n_string_length,
            allow_small_seqs=allow_small_seqs)
    return probes
