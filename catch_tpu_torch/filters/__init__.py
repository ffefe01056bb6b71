"""Probe filters of the port: the two that the design slice runs."""

from catch_tpu_torch.filters.base import BaseFilter
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
