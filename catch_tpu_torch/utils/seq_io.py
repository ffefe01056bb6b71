# Copied from catch_tpu/utils/seq_io.py.
"""FASTA reading/writing with reference-identical normalization.

Parity with reference catch/utils/seq_io.py:85-252: sequences are
uppercased, degenerate bases (Y/R/W/S/M/K/B/D/H/V) replaced with 'N',
gaps ('-') stripped, and input order preserved (input order affects the
design output, so order preservation matters for reproducibility).
``iterate_fasta`` streams records (for avoided genomes at human-genome
scale) and, per the reference, only replaces degenerate bases.
``write_probe_fasta`` writes ``probe_<identifier>`` headers (SHA-224
suffix) when a probe has no explicit header.
"""

from collections import OrderedDict
import gzip
import logging
import re

from catch_tpu_torch.genome import Genome

logger = logging.getLogger(__name__)

_DEGENERATE = re.compile("[YRWSMKBDHV]")


def _open(fn):
    if fn.endswith(".gz"):
        return gzip.open(fn, "rt")
    return open(fn, "r")


def read_fasta(fn, replace_degenerate=True, skip_gaps=True,
               make_uppercase=True):
    """Read a FASTA file into an OrderedDict name -> sequence.

    An empty line resets the current record (reference parity:
    reference catch/utils/seq_io.py:137-139).
    """
    logger.info("Reading fasta file %s", fn)
    m = OrderedDict()
    curr = ""
    with _open(fn) as f:
        for line in f:
            line = line.rstrip()
            if len(line) == 0:
                curr = ""
                continue
            if curr == "":
                assert line.startswith(">")
            if line.startswith(">"):
                curr = line[1:]
                m[curr] = []
            else:
                if make_uppercase:
                    line = line.upper()
                if replace_degenerate:
                    line = _DEGENERATE.sub("N", line)
                if skip_gaps:
                    line = line.replace("-", "")
                m[curr].append(line)
    return OrderedDict((name, "".join(parts)) for name, parts in m.items())


def iterate_fasta(fn, replace_degenerate=True):
    """Stream sequences from a FASTA file one at a time."""
    def process(f):
        parts = []
        for line in f:
            line = line.rstrip()
            if len(line) == 0:
                continue
            if line.startswith(">"):
                if parts:
                    yield "".join(parts)
                parts = []
            else:
                if replace_degenerate:
                    line = _DEGENERATE.sub("N", line)
                parts.append(line)
        if parts:
            yield "".join(parts)

    with _open(fn) as f:
        yield from process(f)


def read_genomes_from_fasta(fn):
    """Read a FASTA file as a list of single-sequence Genomes."""
    logger.debug("Reading fasta %s; assuming one sequence per genome", fn)
    return [Genome.from_one_seq(seq) for seq in read_fasta(fn).values()]


def write_probe_fasta(probes, out_fn):
    """Write probes as FASTA; headers are probe.header or probe_<id>."""
    with open(out_fn, "w") as f:
        for p in probes:
            if p.header:
                f.write(">" + p.header + "\n")
            else:
                f.write(">probe_%s\n" % p.identifier())
            f.write(p.seq_str + "\n")
