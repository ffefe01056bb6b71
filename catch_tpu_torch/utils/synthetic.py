# Copied from catch_tpu/utils/synthetic.py.
"""Synthetic benchmark corpora.

Deterministic, seeded generators for workload-shaped inputs the offline
benchmark suite needs: most importantly an influenza-A-like segmented
corpus (8 segments, ~13.6 kb per genome, subtype-structured divergence)
sized to design_large on ~10k influenza genomes.  Real influenza
downloads are unavailable offline, so the phylogenetic shape
— a few deeply diverged subtype clades, tight within-subtype identity —
is reproduced synthetically: it is exactly that shape that exercises
cluster-and-design-separately, MinHash near-duplicate collapsing, and
the per-cluster device pipeline the way the real workload does.
"""

import os

import numpy as np

__all__ = ["influenza_like_segments", "write_segment_fastas",
           "IAV_SEGMENT_LENGTHS"]

# Influenza A genome segments (PB2, PB1, PA, HA, NP, NA, M, NS) at
# their approximate reference lengths; total ~13.6 kb.
IAV_SEGMENT_LENGTHS = (2341, 2341, 2233, 1778, 1565, 1413, 1027, 890)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate_rows(rows, rate, rng):
    """Substitute a `rate` fraction of positions (per row) with random
    bases.  Draws replacement bases uniformly from ACGT, so the
    effective divergence is 3/4 of `rate` (a draw can match the
    original base) — callers pass nominal rates with that in mind."""
    mask = rng.random(rows.shape) < rate
    n_mut = int(mask.sum())
    rows[mask] = _BASES[rng.integers(0, 4, size=n_mut)]
    return rows


def influenza_like_segments(n_genomes=10000, n_subtypes=12, seed=0,
                            subtype_divergence=0.16,
                            within_divergence=0.025,
                            segment_lengths=IAV_SEGMENT_LENGTHS):
    """Generate a segmented, subtype-structured corpus.

    Returns (segments, subtype_of) where segments is a list (one entry
    per genome segment) of uint8 arrays shaped (n_genomes, seg_len) of
    ACGT bytes, and subtype_of is the int array assigning each genome
    to its subtype clade.  Genome g is row g of every segment (the
    segments of one genome share a subtype, as in a real reassortment-
    free population).

    Divergence structure: each subtype's founder mutates from a common
    ancestor at `subtype_divergence` (nominal; effective ~3/4 of it),
    and each genome mutates from its subtype founder at
    `within_divergence` — i.e. ~12% between subtypes and ~2% within,
    matching the clade structure influenza-A clustering sees.  Fully
    deterministic in (seed, shape) arguments.
    """
    rng = np.random.default_rng(seed)
    sizes = np.full(n_subtypes, n_genomes // n_subtypes, dtype=np.int64)
    sizes[:n_genomes % n_subtypes] += 1
    subtype_of = np.repeat(np.arange(n_subtypes), sizes)

    segments = []
    for L in segment_lengths:
        ancestor = _BASES[rng.integers(0, 4, size=L)]
        out = np.empty((n_genomes, L), dtype=np.uint8)
        row = 0
        for st in range(n_subtypes):
            founder = _mutate_rows(ancestor.copy()[None, :],
                                   subtype_divergence, rng)[0]
            block = np.broadcast_to(founder,
                                    (sizes[st], L)).copy()
            _mutate_rows(block, within_divergence, rng)
            out[row:row + sizes[st]] = block
            row += sizes[st]
        segments.append(out)
    return segments, subtype_of


def write_segment_fastas(segments, subtype_of, out_dir, prefix="seg",
                         force=False):
    """Write one FASTA per segment (the convention for segmented
    species: each segment is its own dataset).

    Returns the list of file paths.  Existing files are reused unless
    `force` (generation is deterministic, so a cached corpus written
    with the same arguments is identical).
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for si, seg in enumerate(segments):
        path = os.path.join(out_dir, "%s%d.fasta" % (prefix, si + 1))
        paths.append(path)
        if os.path.exists(path) and not force:
            continue
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for g in range(seg.shape[0]):
                f.write(">genome%05d subtype%02d segment%d\n"
                        % (g, subtype_of[g], si + 1))
                f.write(seg[g].tobytes().decode())
                f.write("\n")
        os.replace(tmp, path)
    return paths
