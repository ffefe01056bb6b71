"""The comparison that decides `correct`, driven through the rest of a
run (run.run_cell) on the CPU at a small size, past the look for a
card: a sound run is correct, and the control and each fault that a
design job can have come out not correct.  One card holds each cell,
so no exchange between cards can be left out.  Besides the cells of
BENCHMARK.json, the design_large configuration that waits for a cell
(zaire-ebola-large under its traffic all1525) is driven the same way."""
import json
import os

import pytest

from bench_port import run

CELLS = ["ebola175-m2", "ebola1525-large"]
WAITING = {"ebola1525-large": ("zaire-ebola-large", "all1525")}


def parts(name):
    if name not in WAITING:
        return run.load_cell(name)[1:]
    loaded = []
    for folder, key in zip(("configs", "traffic"), WAITING[name]):
        with open(os.path.join(run.HERE, folder, key + ".json")) as f:
            loaded.append(json.load(f))
    return loaded[0], loaded[1], [], []


def cell_run(name, control=False, seed=2**31 + 7):
    config, tr, e2e, layer = parts(name)
    tr = dict(tr, jobs=1, check_jobs=1)
    config = dict(config, corpus=dict(config["corpus"], n_genomes=8))
    return run.run_cell(config, tr, e2e, layer, seed=seed, seconds=0.01,
                        trace=False, device="cpu", control=control)


def the_gap(res):
    c = res["checks"]
    return c["uncovered_bp" if "uncovered_bp" in c
             else "worst_genome_uncovered_bp"]


def the_count(res):
    c = res["checks"]
    return c["probes_differing" if "probes_differing" in c
             else "probes_over_reference"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = cell_run(name)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] == 1
    assert list(res)[-1] == "checks"
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_fails(seed):
    # -m 3 where the configuration states 2 mismatches
    res = cell_run("ebola175-m2", control=True, seed=seed)
    assert not res["correct"]
    assert res["checks"]["probes_differing"]["value"] > 0
    assert res["checks"]["uncovered_bp"]["value"] > 0


def test_the_large_control_fails():
    # -m 6 where the configuration states 5 mismatches
    res = cell_run("ebola1525-large", control=True)
    assert not res["correct"]
    near = res["checks"]["near_miss_bp"]
    assert near["value"] > near["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced(monkeypatch, name):
    from catch_tpu_torch.utils import seq_io
    write = seq_io.write_probe_fasta

    def altered(probes, out_fn):
        write(probes, out_fn)
        with open(out_fn) as f:
            lines = f.read().split("\n")
        lines[1] = lines[1][:50] + ("C" if lines[1][50] != "C" else "G") + \
            lines[1][51:]
        with open(out_fn, "w") as f:
            f.write("\n".join(lines))
    monkeypatch.setattr(seq_io, "write_probe_fasta", altered)
    res = cell_run(name)
    assert not res["correct"] and res["failed"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out(monkeypatch, name):
    from catch_tpu_torch.cli import design
    read = design._read_dataset

    def half(path):
        genomes, records = read(path)
        return genomes[:len(genomes) // 2], records[:len(records) // 2]
    monkeypatch.setattr(design, "_read_dataset", half)
    res = cell_run(name)
    assert not res["correct"]
    assert the_gap(res)["value"] > the_gap(res)["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_solver_whose_state_stops_after_one_step(monkeypatch, name):
    from catch_tpu_torch.ops import set_cover
    solve = set_cover.solve_instance

    def one_step(*args, **kwargs):
        return solve(*args, **kwargs)[:1]
    monkeypatch.setattr(set_cover, "solve_instance", one_step)
    res = cell_run(name)
    assert not res["correct"]
    assert the_gap(res)["value"] > the_gap(res)["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_set_cover_that_keeps_every_candidate(monkeypatch, name):
    from catch_tpu_torch.filters import set_cover_filter
    monkeypatch.setattr(set_cover_filter.SetCoverFilter, "_filter",
                        lambda self, input, target_genomes_grouped: input)
    res = cell_run(name)
    assert not res["correct"]
    assert the_count(res)["value"] > the_count(res)["limit"]
