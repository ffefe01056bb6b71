"""The cells' jobs, made from the seed by the generator that the
traffic file names (bench_port/generators/<generator>.py).

A cell's configuration names its corpus and sizes; its traffic file
(bench_port/traffic/<traffic>.json) names the generator, the number of
jobs, the environment of the route and how many jobs the check samples.
Everything follows from the seed: job j's draw comes from
SeedSequence([seed, j]), so the same seed gives the same jobs, and every
job of a run differs.
"""
import os
import types

import numpy as np

from bench_port import plugins, reference


class Job:
    def __init__(self, index, inputs, out, args=()):
        self.index = index
        self.inputs = inputs
        self.out = out
        self.args = list(args)
        self.seconds = None
        self.error = None

    def genomes(self):
        """The job's genomes as the reference reads them: one genome a
        record, each a list of one sequence."""
        return [[s] for path in self.inputs
                for _, s in reference.read_fasta(path)]


def make_jobs(root, config, traffic, seed, workdir, n_jobs):
    """Write n_jobs jobs under workdir; returns the Jobs."""
    gen = plugins.load("generators", traffic["generator"])
    spec = types.SimpleNamespace(root=root, config=config, traffic=traffic,
                                 cache={})
    jobs = []
    for j in range(n_jobs):
        d = os.path.join(workdir, f"job{j:04d}")
        os.makedirs(d)
        rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                             int(j)]))
        inputs, args = gen.make(spec, rng, d)
        jobs.append(Job(j, inputs, os.path.join(d, "probes.fasta"), args))
    return jobs
