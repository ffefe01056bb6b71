"""design: the reference designs the job itself (tiling, duplicate
removal, cover spans, greedy set cover) from its genomes.

- probes_differing: places where the program's probe list and the
  reference's differ (0 when they are the same probes in the same
  order);
- uncovered_bp: positions of the reference's universe that the
  program's probes leave uncovered beyond what the coverage allows.
"""
import itertools

from bench_port import reference


def numbers(config, job, device):
    model = reference.Model(**config["model"])
    got = [s for _, s in reference.read_fasta(job.out)]
    genomes = job.genomes()
    want, universe = reference.design(genomes, model, device)
    differing = sum(a != b for a, b in itertools.zip_longest(got, want))
    gap, _ = reference.coverage_gap(got, genomes, model, device,
                                    universe=universe)
    return {"probes_differing": differing, "uncovered_bp": gap}
