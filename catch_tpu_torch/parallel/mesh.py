"""The device mesh: an ordered tuple of places.

Port of catch_tpu/parallel/mesh.py.  A *place* is what a mesh device is
to catch_tpu: a torch.device that holds one shard of the sharded data
and one replica of the replicated data.  Work launched for a place runs
on that device's current CUDA stream.  Two places may name the same
card (see make_mesh); they then share the card's current stream, so
their kernels run one after another and every read of another place's
buffer is ordered by the stream itself.  Places on distinct cards
exchange data only through torch copies (`Tensor.to`, `copy_`), which
order the two devices' streams.
"""

import os

import torch

from catch_tpu_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "visible_places"]


class Mesh:
    """A 1-D mesh: `places` (tuple of torch.device), `size`, and `lead`,
    the first place, where results are joined."""

    def __init__(self, places):
        self.places = tuple(torch.device(p) for p in places)
        if not self.places:
            raise ValueError("a mesh needs at least one place")
        if len({p.type for p in self.places}) > 1:
            raise ValueError(f"places of more than one type: {self.places}")

    @property
    def size(self):
        return len(self.places)

    @property
    def lead(self):
        return self.places[0]

    def __repr__(self):
        return f"Mesh({', '.join(str(p) for p in self.places)})"


def visible_places(device="cuda"):
    """The places a mesh led by `device` ('cuda', 'cuda:<i>' or 'cpu')
    can span: one per CUDA card, `device`'s card first and the others
    after it in index order (wrapping round), or the one CPU.

    CATCH_TPU_VIRTUAL_DEVICES=<n> is the test harness's switch, the
    counterpart of XLA's --xla_force_host_platform_device_count: with it
    n places are visible, place i on card i % torch.cuda.device_count()
    (or all on the CPU).  It is read here and nowhere else.
    """
    lead = resolve_device(device)
    n_cards = torch.cuda.device_count()
    real = ([torch.device("cuda", (lead.index + i) % n_cards)
             for i in range(n_cards)]
            if lead.type == "cuda" else [lead])
    virtual = os.environ.get("CATCH_TPU_VIRTUAL_DEVICES")
    if virtual:
        n = int(virtual)
        if n < 1:
            raise ValueError("CATCH_TPU_VIRTUAL_DEVICES must be at least 1")
        return [real[i % len(real)] for i in range(n)]
    return real


def make_mesh(n_devices=None, device="cuda"):
    """A Mesh over the first `n_devices` places visible from `device`
    (default: all of them), led by `device`.  Asking for more than are
    visible raises ValueError."""
    places = visible_places(device)
    if n_devices is None:
        n_devices = len(places)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    if n_devices > len(places):
        raise ValueError(
            f"requested {n_devices} devices, only {len(places)} available")
    return Mesh(places[:n_devices])

