"""The device check: a name becomes a torch.device, or an error.

There is no fallback.  Asking for ``cuda`` where PyTorch sees no CUDA
device raises; the CPU runs only when it is asked for by name.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device):
    """torch.device for `device` (a name or a torch.device).

    Raises RuntimeError for a CUDA device when CUDA is not available,
    and ValueError for any type other than cpu or cuda.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was requested but torch.cuda is not "
                "available (torch %s, CUDA %s)"
                % (torch.__version__, torch.version.cuda))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}; "
                         "use 'cuda' or 'cpu'")
    return dev
