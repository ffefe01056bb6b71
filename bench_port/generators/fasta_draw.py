"""fasta_draw: each job is the configuration's corpus.n_genomes records
of its FASTA (corpus.file, normalised as CATCH reads it), drawn without
replacement by the job's generator in the order drawn; where that is
every record, all of them in an order the generator shuffles.  One
dataset, one genome a record."""
import os

from bench_port import reference


def _write(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


def make(spec, rng, job_dir):
    """(input FASTA paths, extra CLI arguments) of one job."""
    corpus = spec.config["corpus"]
    if "records" not in spec.cache:
        spec.cache["records"] = reference.read_fasta(
            os.path.join(spec.root, corpus["file"]))
    records = spec.cache["records"]
    n = corpus["n_genomes"]
    if n >= len(records):
        idx = rng.permutation(len(records))
    else:
        idx = rng.choice(len(records), size=n, replace=False)
    path = os.path.join(job_dir, "genomes.fasta")
    _write(path, [records[i] for i in idx])
    return [path], []
