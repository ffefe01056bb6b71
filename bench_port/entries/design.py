"""design: catch_tpu_torch.cli.design.main in this process, with the
CLI's defaults of the configuration's args_type ('basic' as design.py,
'large' as design_large.py); the job's FASTA files in, its probe FASTA
out."""
import contextlib
import io


def run(config, job, extra, device):
    from catch_tpu_torch.cli import design
    argv = list(job.inputs) + ["-o", job.out] + list(config["args"]) + \
        list(job.args) + list(extra) + ["--device", device]
    with contextlib.redirect_stdout(io.StringIO()):
        design.main(design.init_and_parse_args(argv, config["args_type"]))
