"""Probe filters of the port."""

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
from catch_tpu_torch.filters.reverse_complement import ReverseComplementFilter
from catch_tpu_torch.filters.n_expansion import NExpansionFilter
from catch_tpu_torch.filters.polya import PolyAFilter
from catch_tpu_torch.filters.fasta import FastaFilter
from catch_tpu_torch.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu_torch.filters.adapter import AdapterFilter
from catch_tpu_torch.filters.naive_redundant import NaiveRedundantFilter
from catch_tpu_torch.filters.dominating_set import DominatingSetFilter
