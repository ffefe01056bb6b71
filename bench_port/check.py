"""The comparison that decides `correct`: each sampled job's probe set
against the plain reference (reference.py), worked out again from the
job's genomes by the check that the configuration names
(bench_port/checks/<check>.py), each number held to its limit in the
configuration."""
import numpy as np

from bench_port import plugins


def sample(jobs, n, seed):
    """n of the completed jobs drawn from the seed, the longest of them
    among them."""
    done = [j for j in jobs if j.seconds is not None and j.error is None]
    if not done:
        return []
    longest = max(done, key=lambda j: j.seconds)
    rest = [j for j in done if j is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1 << 20]))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) \
        if n > 1 and rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def compare(config, jobs, device):
    """(numbers, rejected): each number's worst over the jobs, beside its
    limit, and how many jobs broke a limit."""
    numbers = plugins.load("checks", config["check"]).numbers
    limits = config["limits"]
    worst = {k: None for k in limits}
    rejected = 0
    for job in jobs:
        nums = numbers(config, job, device)
        bad = False
        for k, v in nums.items():
            if worst[k] is None or v > worst[k]:
                worst[k] = v
            if v > limits[k]:
                bad = True
        rejected += bad
    return {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}, \
        rejected
