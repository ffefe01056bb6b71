"""catch_tpu_torch's CUDA kernels against their plain-PyTorch twins, on
the card.

Every test here needs a CUDA device and skips without one.  The card's
host has no JAX, so this file imports neither jax nor catch_tpu, and it
runs there without tests/conftest.py (which imports jax):

    python -m pytest --noconftest -o markers=cuda -q tests/test_torch_cuda.py

The inputs cover the paths the ebola175 smoke run (chip_smoke.py) does
not: the window fast path, islands, several chromosomes, sequences
shorter than the probes, merge groups that cross the kernel's 1024-row
blocks at every boundary case, and empty inputs.  Every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from catch_tpu_torch.filters.candidates import (
    make_candidate_probes_from_sequences)
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops.cover import CoverModel, ProbeSearcher

BASES = np.array(list("ACGT"))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and w.device.type == "cuda"
        assert torch.equal(g, w)


def _genomes(seed, n_chrs, short):
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, size=1200)
    out = []
    for _ in range(5):
        seq = base.copy()
        m = rng.random(len(seq)) < 0.04
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        bounds = np.linspace(0, len(seq), n_chrs + 1).astype(int)
        chrs = ["".join(seq[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
        if short:
            chrs += ["".join(seq[100:150]), "".join(seq[300:370])]
        out.append(chrs)
    return out


@pytest.mark.parametrize("model_kw,ext,n_chrs,short,k_seed", [
    (dict(mismatches=2, lcf_thres=60), 30, 1, False, None),
    (dict(mismatches=0, lcf_thres=60), 0, 1, False, None),
    (dict(mismatches=2, lcf_thres=80), 0, 1, False, None),
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10, 1,
     False, None),
    (dict(mismatches=2, lcf_thres=60), 20, 3, False, None),
    (dict(mismatches=0, lcf_thres=80), 5, 1, True, 20),
], ids=["m2_l60_e30", "m0", "fast_m2_l80", "island25", "multichrom",
        "k0_short_seqs"])
def test_kernels_equal_twins(cuda, model_kw, ext, n_chrs, short, k_seed):
    genomes = _genomes(11, n_chrs, short)
    seqs = [s for g in genomes for s in g]
    probes = list(dict.fromkeys(make_candidate_probes_from_sequences(
        [g[0] for g in genomes], probe_length=80, probe_stride=40)))
    searcher = ProbeSearcher(probes, CoverModel(**model_kw))
    if k_seed is not None:
        searcher.k_seed = k_seed
    univ, off = [], []
    for j, g in enumerate(genomes):
        pos = 0
        for s in g:
            univ.append(j)
            off.append(pos)
            pos += len(s)
    st, total, _ = si.prepare_corpus(searcher, seqs, univ, off,
                                     np.arange(len(probes)), cuda)
    kj, s = si.join_params_stride(searcher)
    n_samples = -(-total // s)

    q = si.rolling_hash(st["mega"], n_samples, s, kj, total - kj)
    _assert_equal([q], [si._rolling_hash_plain(st["mega"], n_samples, s,
                                               kj, total - kj)])
    tbl = si.build_table(st["codes"], kj)

    pc, ac = si.lookup_expand(*tbl, q, s)
    _assert_equal((pc, ac), si._lookup_expand_plain(*tbl, q, s))
    assert pc.numel() > 0

    island = model_kw.get("island_of_exact_match", 0)
    args = dict(K=int(searcher.K_static), k_seed=int(searcher.k_seed),
                lcf=int(searcher.lcf_static),
                seed_req=max(int(searcher.k_seed), island),
                fast_ok=bool(searcher.fast_ok), ext=ext, nU=len(genomes))
    vt = (st["mega"], st["codes"], st["lens"], pc, ac, st["seq_starts"],
          st["seq_ends"], st["seq_lens"], st["chrom_off"], st["univ_of_seq"])
    spans = si.verify_windows(*vt, **args)
    _assert_equal(spans, si._verify_windows_plain(*vt, **args))
    assert spans[0].numel() > 0

    merged = si.segmented_merge(*spans)
    _assert_equal(merged, si._segmented_merge_plain(*spans))
    union_in = (merged[0] % len(genomes), merged[1], merged[2])
    _assert_equal(si.segmented_merge(*union_in),
                  si._segmented_merge_plain(*union_in))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2049, 5000,
                               (1 << 20) + 1025])
def test_segmented_merge_block_boundaries(cuda, n):
    """Groups that start, end and run across the 1024-row blocks, and
    (at the largest n) more block aggregates than one carry chunk."""
    rng = np.random.default_rng(n)
    k = np.sort(rng.integers(0, max(1, n // 3000), size=n))
    s = rng.integers(0, 1 << 20, size=n)
    e = s + rng.integers(1, 400, size=n)
    s[::997] = 0
    e[::997] = 1 << 20        # long spans that swallow their group
    k, s, e = (torch.from_numpy(x).to(cuda) for x in (k, s, e))
    _assert_equal(si.segmented_merge(k, s, e),
                  si._segmented_merge_plain(k, s, e))


def test_empty_inputs(cuda):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    assert all(x.numel() == 0 for x in si.segmented_merge(e, e, e))
    assert si.rolling_hash(torch.zeros(4, dtype=torch.uint8, device=cuda),
                           0, 1, 2, 0).numel() == 0
    tbl = torch.tensor([5, 9, si.HMAX], dtype=torch.int64, device=cuda)
    q = torch.tensor([1, 2, si.HMAX], dtype=torch.int64, device=cuda)
    p, a = si.lookup_expand(tbl, tbl, tbl, q, 3)
    assert p.numel() == a.numel() == 0


def test_design_on_cuda_equals_cpu(cuda):
    """The whole slice on the card gives the CPU twins' probe set."""
    from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
    from catch_tpu_torch.genome import Genome

    genomes = [Genome.from_one_seq(g[0]) for g in _genomes(4, 1, False)]
    probes = make_candidate_probes_from_sequences(
        [g.seqs[0] for g in genomes], probe_length=80, probe_stride=40)
    out = {}
    for dev in ("cpu", "cuda"):
        f = SetCoverFilter(2, 60, cover_extension=25, device=dev)
        out[dev] = [p.seq_str for p in f.filter(
            [list(probes)], [genomes], input_is_grouped=True)[0]]
    assert out["cuda"] == out["cpu"] and out["cpu"]
