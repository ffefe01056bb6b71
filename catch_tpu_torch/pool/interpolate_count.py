# Copied from catch_tpu/pool/interpolate_count.py.
"""Interpolate probe counts at fractional parameter values.

Capability parity with the reference
(reference catch/pool/interpolate_count.py:33-328): probe counts
were computed on a grid of parameter values; the parameter search
explores points between them.

Standard (2-parameter, mismatches x cover_extension) mode: find the
minimal-"area" axis-aligned rectangle whose four corners are computed
grid points enclosing the query (cover_extension scaled by 1/10 in the
area, with 0.001 pseudocounts on each dimension), then interpolate
bilinearly.  Rectangles are memoized per unit cell of the query point.
The reference's direction-split interpolation code (its :189-226) is
algebraically plain linear interpolation, implemented directly here.

ND mode: scipy LinearNDInterpolator with rescaling, one interpolator
memoized per dataset.
"""

import logging
import math

import numpy as np

logger = logging.getLogger(__name__)


def _round_up(x, b):
    """Round float x up to the nearest multiple of int b."""
    return int(math.ceil(float(x) / b)) * b


def _round_down(x, b):
    """Round float x down to the nearest multiple of int b."""
    return int(math.floor(float(x) / b)) * b


def _lerp(lo_val, hi_val, lo, hi, x):
    if hi == lo:
        assert lo_val == hi_val
        return lo_val
    f = float(x - lo) / (hi - lo)
    return lo_val + f * (hi_val - lo_val)


def _make_interp_probe_count_for_dataset_standard_fn(
        probe_counts, cover_extension_scale=1.0 / 10):
    """Bilinear interpolation over the (mismatches, cover_extension)
    grid; see module docstring."""
    memoized_rectangles = {dataset: {} for dataset in probe_counts}

    def find_min_rectangle(dataset, mismatches, cover_extension):
        points = set(probe_counts[dataset].keys())
        ms = sorted({p[0] for p in points})
        ces = sorted({p[1] for p in points})
        m_los = [m for m in ms if m <= mismatches]
        m_his = [m for m in ms if m >= mismatches]
        ce_los = [c for c in ces if c <= cover_extension]
        ce_his = [c for c in ces if c >= cover_extension]
        best, best_area = None, float("inf")
        for m_lo in m_los:
            for m_hi in m_his:
                for ce_lo in ce_los:
                    for ce_hi in ce_his:
                        if ((m_lo, ce_lo) in points
                                and (m_lo, ce_hi) in points
                                and (m_hi, ce_lo) in points
                                and (m_hi, ce_hi) in points):
                            width = m_hi - m_lo
                            height = (ce_hi - ce_lo) * cover_extension_scale
                            area = (width + 0.001) * (height + 0.001)
                            if area < best_area:
                                best_area = area
                                best = (m_lo, m_hi, ce_lo, ce_hi)
        return best

    def interp_probe_count_for_dataset(dataset, param_vals):
        mismatches, cover_extension = param_vals
        cell = (_round_down(mismatches, 1), _round_up(mismatches, 1),
                _round_down(cover_extension, 1),
                _round_up(cover_extension, 1))
        if cell in memoized_rectangles[dataset]:
            rect = memoized_rectangles[dataset][cell]
        else:
            rect = find_min_rectangle(dataset, mismatches, cover_extension)
            if rect is None:
                raise Exception(
                    "Unable to find rectangular bounding box around "
                    "(mismatches, cover_extension)=(%f, %f) for dataset "
                    "%s" % (mismatches, cover_extension, dataset))
            memoized_rectangles[dataset][cell] = rect

        m_lo, m_hi, ce_lo, ce_hi = rect
        counts = probe_counts[dataset]
        count_at_ce_lo = _lerp(counts[(m_lo, ce_lo)], counts[(m_hi, ce_lo)],
                               m_lo, m_hi, mismatches)
        count_at_ce_hi = _lerp(counts[(m_lo, ce_hi)], counts[(m_hi, ce_hi)],
                               m_lo, m_hi, mismatches)
        return _lerp(count_at_ce_lo, count_at_ce_hi, ce_lo, ce_hi,
                     cover_extension)

    return interp_probe_count_for_dataset


def _make_interp_probe_count_for_dataset_nd_fn(probe_counts):
    """scipy LinearNDInterpolator per dataset (memoized)."""
    from scipy import interpolate

    interp_memoized = {}

    def interp_probe_count_for_dataset(dataset, param_vals):
        if dataset in interp_memoized:
            nd_fn = interp_memoized[dataset]
        else:
            points = np.array(list(probe_counts[dataset].keys()))
            values = np.array(list(probe_counts[dataset].values()))
            nd_fn = interpolate.LinearNDInterpolator(points, values,
                                                     rescale=True)
            interp_memoized[dataset] = nd_fn
        try:
            return nd_fn(np.array(param_vals))[0]
        except ValueError:
            raise ValueError(param_vals, dataset, probe_counts[dataset])

    return interp_probe_count_for_dataset


def _make_total_probe_count_across_datasets_fn(probe_counts,
                                               interp_fn_type="standard"):
    """Sum per-dataset interpolated counts over a packed parameter
    vector x (datasets iterated in sorted order — the packing
    convention)."""
    assert interp_fn_type in ["standard", "nd"]
    if interp_fn_type == "standard":
        interp_fn = _make_interp_probe_count_for_dataset_standard_fn
    else:
        interp_fn = _make_interp_probe_count_for_dataset_nd_fn
    interp_probe_count_for_dataset = interp_fn(probe_counts)

    def total_probe_count_across_datasets(x):
        num_datasets = len(probe_counts)
        assert len(x) % num_datasets == 0
        num_params = int(len(x) / num_datasets)
        s = 0
        for i, dataset in enumerate(sorted(probe_counts.keys())):
            param_vals = [x[num_params * i + j] for j in range(num_params)]
            s += interp_probe_count_for_dataset(dataset, param_vals)
        return s

    return total_probe_count_across_datasets
