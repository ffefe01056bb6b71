"""design_large: the reference designs the job as design.py would
(tiling, duplicate removal, cover spans, greedy set cover over every
candidate); it does not redo design_large's clustering and MinHash
near-duplicate filter, so the program's probes are held to what those
may change, not to the same list.

- foreign_probes: the program's probes that are no candidate of the
  job (a tile of one of its sequences);
- worst_genome_uncovered_bp: the most positions of one genome's
  universe (the positions of it that some candidate covers) that the
  program's probes leave uncovered beyond what the coverage allows;
  the near-duplicate filter's own gaps stay small in every genome, a
  genome that the design never saw does not;
- near_miss_bp: positions of the universe that the program's probes
  leave uncovered under the stated mismatches but cover at one
  mismatch more: what a hybridization model looser than the stated
  one leaves behind (the near-duplicate filter's own gaps lie mostly
  elsewhere);
- probes_over_reference: the program's probe count over the
  reference's, which an over-picking solver, a filter that keeps too
  little or a clustering that splits the genomes drives up.
"""
from bench_port import reference


def numbers(config, job, device):
    model = reference.Model(**config["model"])
    looser = reference.Model(**dict(config["model"],
                                    mismatches=model.mismatches + 1))
    got = [s for _, s in reference.read_fasta(job.out)]
    genomes = job.genomes()
    want, universe = reference.design(genomes, model, device)
    tiles = set(reference.candidates([s for g in genomes for s in g],
                                     model))
    per_genome = reference.coverage_gap(got, genomes, model, device,
                                        universe=universe, per_genome=True)
    left = universe & ~reference.covered(got, genomes, model, device)
    near = int((left & reference.covered(got, genomes, looser,
                                         device)).sum())
    return {"foreign_probes": sum(p not in tiles for p in got),
            "worst_genome_uncovered_bp": int(per_genome.max()),
            "near_miss_bp": near,
            "probes_over_reference": len(got) / max(len(want), 1)}
