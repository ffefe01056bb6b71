"""The plain reference against the committed goldens of reference CATCH,
a brute-force reading of the cover model, and the program at a small
size on the CPU."""
import os
import random

import numpy as np
import pytest

from bench_port import reference as R
from bench_port.tests.conftest import ROOT

GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
FIXTURE = os.path.join(ROOT, "bench_port", "data",
                       "zaire_ebolavirus.fasta.gz")


@pytest.fixture(scope="module")
def ebola():
    return R.read_fasta(FIXTURE)


def golden(name):
    return [s for _, s in R.read_fasta(os.path.join(GOLDEN, name))]


def test_fixture_is_the_tests_copy():
    assert R.read_fasta(os.path.join(ROOT, "tests", "data",
                                     "zaire_ebolavirus.fasta.gz")) == \
        R.read_fasta(FIXTURE)


def test_ebola5_m0_equals_reference_catch(ebola):
    # -m 0 is exact in reference CATCH: the probe set must be equal
    genomes = [[s] for _, s in ebola[:5]]
    got, _ = R.design(genomes, R.Model(100, 50, 0, 100, 0))
    want = golden("ref_ebola5_m0.fasta")
    assert len(want) == 426
    assert set(got) == set(want)


def test_ebola10_m2_count_and_full_coverage(ebola):
    # reference CATCH seeds -m 2 by Monte Carlo: at most its 128 probes,
    # and every coverable position covered
    genomes = [[s] for _, s in ebola[:10]]
    model = R.Model(100, 50, 2, 60, 50)
    got, universe = R.design(genomes, model)
    assert len(golden("ref_ebola10_m2.fasta")) == 128
    assert 64 < len(got) <= 128
    gap, size = R.coverage_gap(got, genomes, model, universe=universe)
    assert gap == 0 and size == int(universe.sum())
    assert R.coverage_gap(golden("ref_ebola10_m2.fasta"), genomes, model,
                          universe=universe)[0] == 0


def brute_spans(probes, seqs, model):
    """Every alignment of every probe, read by the model's definition."""
    seed, fast = R.seed_length(model)
    L, K = model.probe_length, model.mismatches
    out = set()
    for pi, p in enumerate(probes):
        for si, s in enumerate(seqs):
            n = len(s)
            thres = min(L, model.lcf_thres, n)
            for a in range(-(L - 1), n):
                lo, hi = max(0, -a), min(L, n - a)
                mism = [j for j in range(lo, hi) if p[j] != s[a + j]]
                if fast and (n >= L or (K == 0 and n >= seed)):
                    if hi - lo - len(mism) >= max(thres - K, seed):
                        b0, b1 = a + lo, a + hi
                    else:
                        continue
                    out.add((pi, si, max(0, b0 - model.cover_extension),
                             min(n, b1 + model.cover_extension)))
                    continue
                P = [lo - 1] + mism + [hi] * (K + 1)
                for t in range(len(mism) + 1):
                    w0, w1 = P[t] + 1, P[t + K + 1]
                    runs = [P[u + 1] - P[u] - 1 for u in range(t, t + K + 1)]
                    if w1 - w0 >= thres and max(runs) >= seed and thres > 0:
                        out.add((pi, si,
                                 max(0, w0 + a - model.cover_extension),
                                 min(n, w1 + a + model.cover_extension)))
    return out


@pytest.mark.parametrize("m,lcf,k", [(2, 20, 15), (1, 30, 12), (0, 30, 20),
                                     (3, 30, 10)])
def test_spans_equal_a_brute_force_reading(m, lcf, k):
    rng = random.Random(m * 100 + lcf)
    base = "".join(rng.choice("ACGT") for _ in range(300))

    def mutate(s, rate):
        return "".join(c if rng.random() > rate else rng.choice("ACGTN")
                       for c in s)
    seqs = [mutate(base, 0.03), mutate(base[40:260], 0.05),
            "NN" + mutate(base[:90], 0.02)]
    probes = list(dict.fromkeys(
        mutate(base[i:i + 30], 0.04) for i in range(0, 270, 17)))
    model = R.Model(30, 15, m, lcf, 7, kmer_probe_map_k=k)
    p, s, a, b = R.spans(probes, seqs, model, chunk=64, budget=97)
    got = set(zip(p.tolist(), s.tolist(), a.tolist(), b.tolist()))
    assert got == brute_spans(probes, seqs, model)


def test_tiles_follow_the_program():
    from catch_tpu_torch.filters.candidates import (
        make_candidate_probes_from_sequence)
    rng = np.random.default_rng(3)
    for n, runs in ((437, [(50, 53), (300, 340)]), (400, []),
                    (251, [(0, 5)]), (380, [(200, 201), (375, 380)])):
        seq = list("".join(rng.choice(list("ACGT"), n)))
        for a, b in runs:
            seq[a:b] = "N" * (b - a)
        seq = "".join(seq)
        want = [p.seq_str for p in make_candidate_probes_from_sequence(
            seq, 100, 50)]
        assert R.tiles(seq, 100, 50) == want


def test_design_equals_the_program_on_a_small_draw(ebola, tmp_path):
    from catch_tpu_torch.cli import design
    with_n = [i for i, (_, s) in enumerate(ebola) if "NN" in s][:3]
    idx = with_n + [i for i in range(20, 40) if i not in with_n][:9]
    path = tmp_path / "g.fasta"
    path.write_text("".join(f">{ebola[i][0]}\n{ebola[i][1]}\n" for i in idx))
    out = tmp_path / "p.fasta"
    design.main(design.init_and_parse_args(
        [str(path), "-o", str(out), "-pl", "100", "-m", "2", "-l", "60",
         "-e", "50", "--device", "cpu"], "basic"))
    got = [s for _, s in R.read_fasta(str(out))]
    want, _ = R.design([[ebola[i][1]] for i in idx],
                       R.Model(100, 50, 2, 60, 50))
    assert got == want
