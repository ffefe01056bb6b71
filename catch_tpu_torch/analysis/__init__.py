"""Probe-set quality-control analysis."""

from catch_tpu_torch.analysis.coverage import Analyzer
