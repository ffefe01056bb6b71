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

With a process group (parallel/distributed.py), a mesh spans every
rank's places in rank order, as jax.devices() orders them by process.
A rank holds tensors only on its own places (`own`, `local_places`),
and the first of them, `lead`, is where the rank joins its results;
`ranks` says which rank owns each place.  Places of distinct ranks
exchange data only through distributed's host-staged collectives.
"""

import os

import torch

from catch_tpu_torch.device import resolve_device
from catch_tpu_torch.parallel import distributed

__all__ = ["Mesh", "make_mesh", "visible_places", "place_count"]


class Mesh:
    """A 1-D mesh: `places` (tuple of torch.device, every rank's), `size`,
    `ranks` (the rank that owns each place, non-decreasing), `rank` (this
    process's), `own` (the indices of its places), `local_places` and
    `lead`, its first place, where its results are joined.  Without
    `ranks` every place is the one process's."""

    def __init__(self, places, ranks=None, rank=0):
        self.places = tuple(torch.device(p) for p in places)
        if not self.places:
            raise ValueError("a mesh needs at least one place")
        if len({p.type for p in self.places}) > 1:
            raise ValueError(f"places of more than one type: {self.places}")
        self.ranks = (tuple(int(r) for r in ranks) if ranks is not None
                      else (rank,) * len(self.places))
        if len(self.ranks) != len(self.places) or list(self.ranks) != sorted(
                self.ranks):
            raise ValueError(f"ranks {self.ranks} for {len(self.places)} "
                             "places, not one each in rank order")
        self.rank = rank
        self.own = tuple(i for i, r in enumerate(self.ranks) if r == rank)
        if not self.own:
            raise ValueError(f"a mesh without a place of rank {rank}")

    @property
    def size(self):
        return len(self.places)

    @property
    def local_places(self):
        return tuple(self.places[i] for i in self.own)

    @property
    def lead(self):
        return self.places[self.own[0]]

    @property
    def spans_ranks(self):
        return self.ranks[0] != self.ranks[-1]

    def counts(self):
        """The number of places of each rank of the group."""
        n = [0] * max(distributed.process_count(), self.ranks[-1] + 1)
        for r in self.ranks:
            n[r] += 1
        return n

    def __repr__(self):
        if not self.spans_ranks:
            return f"Mesh({', '.join(str(p) for p in self.places)})"
        return "Mesh(%s)" % ", ".join(
            f"rank {r}: {p}" for r, p in zip(self.ranks, self.places))


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


def _global_places(device):
    """(places, ranks): every rank's visible_places(device) in rank order
    and the rank of each; one collective where a group is initialized."""
    places = visible_places(device)
    if not distributed.is_initialized():
        return places, [0] * len(places)
    names = distributed.all_gather_object([str(p) for p in places])
    return ([torch.device(p) for ps in names for p in ps],
            [r for r, ps in enumerate(names) for _ in ps])


def place_count(device="cuda"):
    """The places visible from `device` on every rank together, as
    jax.device_count() counts the global devices; a collective where a
    group is initialized."""
    return len(_global_places(device)[0])


def make_mesh(n_devices=None, device="cuda"):
    """A Mesh over the first `n_devices` places visible from `device`
    (default: all of them), led by `device`.  Asking for more than are
    visible raises ValueError.

    With a process group, every rank calls it alike: the places are
    every rank's in rank order, `n_devices` counts them all, and the
    mesh must hold a place of every rank (ValueError otherwise)."""
    places, ranks = _global_places(device)
    if n_devices is None:
        n_devices = len(places)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    if n_devices > len(places):
        raise ValueError(
            f"requested {n_devices} devices, only {len(places)} available")
    ranks = ranks[:n_devices]
    missing = sorted(set(range(distributed.process_count())) - set(ranks))
    if missing:
        raise ValueError(f"a mesh of {n_devices} places holds no place of "
                         f"ranks {missing}")
    return Mesh(places[:n_devices], ranks, distributed.process_index())

