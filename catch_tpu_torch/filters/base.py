# Copied from catch_tpu/filters/base.py.
"""Abstract filter base class.

API parity with the reference BaseFilter
(reference catch/filter/base_filter.py:37-180): ``filter(input,
target_genomes, input_is_grouped, num_processes)`` with the
``requires_probe_groupings`` escape hatch and ``_filter`` arity
introspection.

Design difference: the reference parallelizes per-group ``_filter``
calls across a fork-based process pool (base_filter.py:111-165); here
host-bound filters run their groups on a THREAD pool (the vectorized
numpy bodies release the GIL, so threads give real parallelism without
fork semantics), while device-using filters take the
``requires_probe_groupings`` path and use the device as the parallel
resource.  Results are returned in input order regardless of
completion order — the reference's determinism contract.
``num_processes`` caps the pool as in the reference (min(cpu, 8)
default).
"""

from concurrent.futures import ThreadPoolExecutor
import inspect
import os

__all__ = ["BaseFilter",
           "set_max_num_processes_for_filter_over_groupings"]

# Global worker cap for the grouped-filter thread pool (the analogue
# of the reference's module setter, base_filter.py:12-29); None means
# the min(cpu, 8) default.
_max_num_processes = None


def set_max_num_processes_for_filter_over_groupings(n):
    """Cap the grouped-filter thread pool (--max-num-processes)."""
    global _max_num_processes
    _max_num_processes = n


class BaseFilter:
    """Abstract filter for processing candidate probes.

    Subclasses implement ``_filter(input)`` or
    ``_filter(input, target_genomes)`` returning the processed probes.
    """

    # True when the filter consumes the accelerator: the designer's
    # cross-stage group pipeline serializes such filters on a lock
    # (one device, many host threads) — see ProbeDesigner.
    device_bound = False

    @property
    def group_local(self):
        """Whether group g's output depends only on group g's input —
        the condition for running whole filter CHAINS per group
        concurrently.  One-argument per-group filters are group-local
        by construction; filters that see target genomes (grouping-
        aware or not — e.g. AdapterFilter's votes span all groupings)
        must opt in explicitly."""
        if getattr(self, "requires_probe_groupings", False):
            return False
        return len(inspect.signature(self._filter).parameters) == 1

    def filter(self, input, target_genomes=None, input_is_grouped=False,
               num_processes=None):
        """Perform the filtering.

        Args:
            input: probes, or a list of per-group probe lists when
                input_is_grouped is True
            target_genomes: list of groupings of Genomes
            input_is_grouped: whether input is grouped
            num_processes: worker cap for the grouped thread pool
                (overrides the module-level setter; default
                min(cpu, 8))

        Returns:
            probes (or per-group probe lists) after the filter
        """
        _filter_params = inspect.signature(self._filter).parameters
        wants_genomes = len(_filter_params) == 2

        pass_groupings = getattr(self, "requires_probe_groupings", False)

        if pass_groupings:
            assert input_is_grouped is True
            if wants_genomes:
                return self._filter(input, target_genomes)
            return self._filter(input)

        if input_is_grouped:
            def one(probes):
                if wants_genomes:
                    return self._filter(probes, target_genomes)
                return self._filter(probes)

            if len(input) <= 1:
                return [one(probes) for probes in input]
            workers = (num_processes or _max_num_processes
                       or min(os.cpu_count() or 1, 8))
            workers = max(1, min(workers, len(input)))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                return list(pool.map(one, input))
        if wants_genomes:
            return self._filter(input, target_genomes)
        return self._filter(input)

    def _filter(self, input):
        raise NotImplementedError("subclasses must implement _filter")
