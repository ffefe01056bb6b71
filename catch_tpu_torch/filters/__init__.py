"""Probe filters of the port."""

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
