# Copied from catch_tpu/pool/param_search.py.
"""Search for per-dataset parameter values under a probe budget.

Capability parity with the reference
(reference catch/pool/param_search.py:25-749): minimize
sum_d w_d * sum_j c_j * v_{dj}^2 subject to total probes <=
max_total_count, enforced with a logarithmic barrier whose weight eps
decays 10 -> 0.01 by factors of 10, each round solved with
scipy.optimize.fmin_tnc (approximate gradients).  The standard search
(mismatches, cover_extension) rounds the solution to grid multiples
(down when within eps of the lower multiple, else up), verifies the
constraint, then greedily decreases single parameters while the
constraint holds and the loss improves.  The ND search interpolates
with scipy and does not round.

Like the reference, the initial guess is random (run multiple times and
take the lowest loss).
"""

import logging

import numpy as np

from catch_tpu_torch.pool import interpolate_count as ic

logger = logging.getLogger(__name__)

__all__ = ["standard_search", "higher_dimensional_search",
           "CannotSatisfyProbeCountConstraintError"]


class CannotSatisfyProbeCountConstraintError(Exception):
    """The search yielded a probe count exceeding the constraint."""


_CONSTRAINT_ADVICE = (
    "The total probe count based on parameter values found in the "
    "search (%d) exceeds the given limit (%d). This is likely to happen "
    "if the range of the precomputed parameter values is not as large "
    "as it needs to be to satisfy the constraint. That is, one or more "
    "parameter values may need to be more loose to obtain %d probes. To "
    "fix this, try inputting probe counts for a larger range (in "
    "particular, less stringent choices) of parameter values. Also, "
    "note that the search interpolates probe counts between precomputed "
    "parameter values (%d may be an interpolated count) and, if the "
    "precomputed parameter values are too sparse (i.e., too few actual "
    "probe counts were input), it may be underestimating the true "
    "number of probes required.")


def _make_loss_fn(probe_counts, max_total_count, coeffs, weights,
                  interp_fn_type="standard"):
    """Loss = weighted L2 of parameters + barrier on total probes."""
    total_probe_count = ic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type=interp_fn_type)

    def loss(x, *func_args):
        num_datasets = len(probe_counts)
        assert len(x) % num_datasets == 0
        num_params = int(len(x) / num_datasets)
        assert len(coeffs) == num_params

        xs = np.asarray(x, dtype=np.float64).reshape(
            num_datasets, num_params)
        w = np.asarray([weights[d] for d in sorted(probe_counts.keys())],
                       dtype=np.float64)
        quad = float(np.sum(
            w[:, None] * np.asarray(coeffs)[None, :] * xs * xs))

        eps = func_args[0]
        count = total_probe_count(x)
        if np.isnan(count):
            # Outside the convex hull of the computed grid the ND
            # interpolator has no value; push the optimizer back hard.
            logger.warning(
                "Search left the convex hull of the computed parameter "
                "grid; no probe count can be interpolated there")
            barrier = 10000000
        elif count >= max_total_count:
            # Past the limit the log barrier is undefined; a steep
            # finite slope keeps the approximate gradient pointing back
            # toward feasibility.  The constants (9999 offset, 10000
            # slope) define the optimization landscape and match the
            # reference's (param_search.py:94-114) for parity.
            barrier = 9999 + 10000.0 * np.log(
                count - max_total_count + 1)
        else:
            barrier = -1.0 * eps * np.log(max_total_count - count + 1)
        return quad + barrier

    return loss


def _make_param_bounds_standard(probe_counts, step_size=0.001):
    """Bounds ensuring a bounding rectangle exists for any point inside
    (reference :129-180)."""
    bounds = []
    for dataset in sorted(probe_counts.keys()):
        params = probe_counts[dataset].keys()
        for p in params:
            assert len(p) == 2
        cover_extensions = [k[1] for k in params]
        ce_lo = min(cover_extensions)
        ce_hi = max(cover_extensions)
        mismatches_valid = [m for m in (k[0] for k in params)
                            if (m, ce_lo) in params and (m, ce_hi) in params]
        bounds.append((min(mismatches_valid),
                       max(mismatches_valid) - step_size))
        bounds.append((ce_lo, ce_hi - step_size))
    return bounds


def _make_param_bounds_nd(probe_counts, step_size=0.001):
    """Per-parameter min/max bounds (reference :183-212)."""
    bounds = []
    for dataset in sorted(probe_counts.keys()):
        params = list(probe_counts[dataset].keys())
        num_params = len(params[0])
        for j in range(num_params):
            lo = min(p[j] for p in params)
            hi = max(p[j] for p in params) - step_size
            bounds.append((lo, hi))
    return bounds


def _make_initial_guess(probe_counts, bounds, num_params):
    """Random guess within bounds (or a random computed grid point when
    bounds is None) — reference :215-265."""
    num_datasets = len(probe_counts)
    if bounds is not None:
        assert len(bounds) % num_datasets == 0
        assert num_params == int(len(bounds) / num_datasets)

    x0 = np.zeros(num_datasets * num_params)
    for i, dataset in enumerate(sorted(probe_counts.keys())):
        if bounds is not None:
            for j in range(num_params):
                lo, hi = bounds[num_params * i + j]
                x0[num_params * i + j] = np.random.uniform(lo, hi)
        else:
            param_vals = list(probe_counts[dataset])
            guess = param_vals[np.random.randint(len(param_vals))]
            for j in range(num_params):
                x0[num_params * i + j] = guess[j]
    return x0


def _optimize_loss(probe_counts, loss_fn, bounds, x0, initial_eps=10.0,
                   step_size=0.001, interp_fn_type="standard"):
    """Barrier-weight continuation: minimize with fmin_tnc while
    decaying eps 10 -> 0.01 by 0.1 (reference :268-318)."""
    from scipy import optimize

    count_fn = ic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type=interp_fn_type)
    sol = x0
    eps = initial_eps
    while eps >= 0.01:
        logger.info(
            "Barrier round at eps=%f (starting point interpolates to "
            "%f probes)", eps, count_fn(x0))
        sol, _, rc = optimize.fmin_tnc(
            loss_fn, x0, bounds=bounds, args=(eps,), approx_grad=True,
            epsilon=step_size, disp=1, maxfun=2500)
        if rc in (0, 1, 2):
            logger.info("  barrier round converged")
        else:
            logger.info("  barrier round did NOT converge (rc=%s)", rc)
        x0 = sol
        eps *= 0.1
    return sol


def _total_probe_count_without_interp(params, probe_counts):
    """Exact total count when params are grid keys (sanity check)."""
    num_datasets = len(probe_counts)
    assert len(params) % num_datasets == 0
    num_params = int(len(params) / num_datasets)
    s = 0
    for i, dataset in enumerate(sorted(probe_counts.keys())):
        p = tuple(params[num_params * i + j] for j in range(num_params))
        s += probe_counts[dataset][p]
    return s


def _round_params(params, probe_counts, max_total_count, loss_coeffs,
                  weights, mismatches_eps=0.01, cover_extension_eps=0.1,
                  mismatches_round=1, cover_extension_round=1,
                  bounds=None):
    """Round to grid multiples (down if within eps), assert the
    constraint, then greedily decrease single parameters while the
    constraint holds and the loss improves (reference :362-520)."""
    num_datasets = len(probe_counts)
    assert len(params) == 2 * num_datasets
    assert len(loss_coeffs) == 2

    def snap(v, multiple, eps):
        # Round up to the grid multiple, except when v sits within eps
        # of the multiple below it (floating-point slack from the
        # continuous search), which rounds down.
        floor_v = ic._round_down(v, multiple)
        return floor_v if v - floor_v < eps else ic._round_up(v, multiple)

    params_rounded = []
    for i in range(num_datasets):
        params_rounded.append(
            snap(params[2 * i], mismatches_round, mismatches_eps))
        params_rounded.append(
            snap(params[2 * i + 1], cover_extension_round,
                 cover_extension_eps))

    total_probe_count = ic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type="standard")
    tpc = total_probe_count(params_rounded)
    if tpc > max_total_count:
        raise CannotSatisfyProbeCountConstraintError(
            _CONSTRAINT_ADVICE % (tpc, max_total_count, max_total_count,
                                  tpc))

    loss_fn = _make_loss_fn(probe_counts, max_total_count, loss_coeffs,
                            weights, interp_fn_type="standard")
    # Greedy tightening: repeatedly take the single-parameter decrement
    # that lowers the loss the most while keeping the count feasible.
    while True:
        best_loss = loss_fn(params_rounded, 0)
        best = None
        for i in range(len(params_rounded)):
            if params_rounded[i] == 0:
                continue
            step = (mismatches_round if i % 2 == 0
                    else cover_extension_round)
            trial = list(params_rounded)
            trial[i] -= step
            if bounds is not None and trial[i] < bounds[i][0]:
                continue
            if total_probe_count(trial) >= max_total_count:
                continue
            trial_loss = loss_fn(trial, 0)
            if trial_loss < best_loss:
                best_loss, best = trial_loss, trial
        if best is None:
            break
        params_rounded = best
    return params_rounded


def _log_params_by_dataset(params, probe_counts, type="float"):
    for i, dataset in enumerate(sorted(probe_counts.keys())):
        mismatches, cover_extension = params[2 * i], params[2 * i + 1]
        if type == "float":
            logger.info("%s: (%f, %f)", dataset, mismatches,
                        cover_extension)
        elif type == "int":
            logger.info("%s: (%d, %d)", dataset, mismatches,
                        cover_extension)
        else:
            raise ValueError("Unknown type %s", type)


def standard_search(probe_counts, max_total_count,
                    verify_without_interp=False, round_params=None,
                    loss_coeffs=None, dataset_weights=None):
    """Search over (mismatches, cover_extension); see module docstring.

    Returns:
        ({dataset: (mismatches, cover_extension)}, total probe count,
        loss)
    """
    if loss_coeffs:
        assert len(loss_coeffs) == 2
        loss_coeffs = tuple(loss_coeffs)
    else:
        loss_coeffs = (1.0, 1.0 / 100.0)
    if dataset_weights:
        for d in probe_counts.keys():
            assert d in dataset_weights
    else:
        dataset_weights = {d: 1.0 for d in probe_counts.keys()}
    if round_params:
        mismatches_round, cover_extension_round = round_params
    else:
        mismatches_round, cover_extension_round = 1, 1

    loss_fn = _make_loss_fn(probe_counts, max_total_count, loss_coeffs,
                            dataset_weights, interp_fn_type="standard")
    bounds = _make_param_bounds_standard(probe_counts)
    x0 = _make_initial_guess(probe_counts, bounds, 2)

    x_sol = _optimize_loss(probe_counts, loss_fn, bounds, x0,
                           interp_fn_type="standard")

    count_fn = ic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type="standard")
    logger.info("Continuous solution per dataset:")
    _log_params_by_dataset(x_sol, probe_counts, "float")
    logger.info("Continuous solution interpolates to %f probes",
                count_fn(x_sol))

    opt_params = _round_params(
        x_sol, probe_counts, max_total_count, loss_coeffs,
        dataset_weights, mismatches_round=mismatches_round,
        cover_extension_round=cover_extension_round, bounds=bounds)

    logger.info("Rounded solution per dataset:")
    _log_params_by_dataset(opt_params, probe_counts, "int")
    opt_params_count = count_fn(opt_params)
    opt_params_loss = loss_fn(opt_params, 0)
    logger.info("Rounded solution: %d probes, loss %f",
                opt_params_count, opt_params_loss)

    if verify_without_interp:
        exact = _total_probe_count_without_interp(opt_params,
                                                  probe_counts)
        logger.info("Exact (non-interpolated) count at the rounded "
                    "solution: %d", exact)
        assert opt_params_count == exact

    opt_params_dict = {}
    for i, dataset in enumerate(sorted(probe_counts.keys())):
        opt_params_dict[dataset] = (opt_params[2 * i],
                                    opt_params[2 * i + 1])
    return (opt_params_dict, opt_params_count, opt_params_loss)


def higher_dimensional_search(param_names, probe_counts, max_total_count,
                              loss_coeffs=None, dataset_weights=None):
    """Search over arbitrarily many parameters (no rounding).

    Returns:
        ({dataset: params tuple}, total probe count, loss)
    """
    num_params = len(param_names)
    if loss_coeffs is None:
        logger.warning("Using a default coefficient of 1 for each "
                       "parameter in the loss function")
        loss_coeffs = tuple(1.0 for _ in range(num_params))
    else:
        assert len(loss_coeffs) == num_params
        loss_coeffs = tuple(loss_coeffs)
    if dataset_weights:
        for d in probe_counts.keys():
            assert d in dataset_weights
    else:
        dataset_weights = {d: 1.0 for d in probe_counts.keys()}

    loss_fn = _make_loss_fn(probe_counts, max_total_count, loss_coeffs,
                            dataset_weights, interp_fn_type="nd")
    bounds = _make_param_bounds_nd(probe_counts)
    x0 = _make_initial_guess(probe_counts, bounds, num_params)

    x_sol = _optimize_loss(probe_counts, loss_fn, bounds, x0,
                           interp_fn_type="nd")

    x_sol_dict = {}
    for i, dataset in enumerate(sorted(probe_counts.keys())):
        x_sol_dict[dataset] = tuple(x_sol[num_params * i + j]
                                    for j in range(num_params))

    x_sol_count = ic._make_total_probe_count_across_datasets_fn(
        probe_counts, interp_fn_type="nd")(x_sol)
    x_sol_loss = loss_fn(x_sol, 0)

    if x_sol_count > max_total_count:
        raise CannotSatisfyProbeCountConstraintError(
            _CONSTRAINT_ADVICE % (x_sol_count, max_total_count,
                                  max_total_count, x_sol_count))

    return (x_sol_dict, x_sol_count, x_sol_loss)
