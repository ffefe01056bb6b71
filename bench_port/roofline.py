# Copied from chip_smoke.py (HBM_BYTES_PER_S, OPS_PER_S, bound, step_work and the kernel works of compare()'s cases and k12's incremental work).
"""The least time of a kernel call on one H100, from its shapes.

A call's work is (bytes, operations) that its inputs need: each input
byte read once, each output byte written once, and the operations the
algorithm must do.  Its least time is the larger of bytes over the
card's memory bandwidth and operations over its float32 rate outside
the tensor cores (NVIDIA's H100 SXM data sheet, at the full 700 W),
whatever the card's power limit; the benchmark prints the limit beside
each share.  Each work function takes the wrapper's arguments and its
result and returns the work, or a function of no arguments that gives
it once the traced window has closed (where the count lives on the
card, so that reading it would wait for it inside the window).
"""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound_s(work):
    """Least seconds of (bytes, operations)."""
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def step_work(U, M, P, S, nU, ivl_bytes, pair_bytes):
    """(bytes, operations) of one greedy step with a full recompute:
    `covered`, the prefix, and the interval, pair, set and universe
    arrays once."""
    return (U + 4 * (U + 1) + ivl_bytes * M + pair_bytes * P + 13 * S
            + 8 * nU, U + M + P + S)


def _build_table(args, kwargs, out):
    codes, kj = args[0], args[1]
    P, L = codes.shape
    W = L - kj + 1
    return (P * L + 8 * P * W + 4 * P, 2 * kj * P * W)


def _rolling_hash(args, kwargs, out):
    codes, n_out, stride, kj = args[:4]
    read = min(codes.numel(), max(0, (n_out - 1) * stride + kj))
    return (read + 8 * n_out, 2 * kj * n_out)


def _lookup_expand(args, kwargs, out):
    ent, cnt, q = args[:3]
    P, W = ent.shape
    n_q, n_pairs = q.numel(), out[0].numel()

    def later():
        return (8 * P * W + 4 * P + 8 * n_q + 16 * n_pairs,
                int(cnt.sum()) * max(1, (n_q - 1).bit_length()) + n_pairs)
    return later


def _verify_windows(args, kwargs, out):
    mega, codes, pc = args[0], args[1], args[3]
    n_pairs, L = pc.numel(), codes.shape[1]
    return (min(mega.numel(), n_pairs * L) + codes.numel() + 16 * n_pairs
            + 24 * out[0].numel(), n_pairs * L)


def _segmented_merge(args, kwargs, out):
    n_in, n_out = args[0].numel(), out[0].numel()
    return (24 * (n_in + n_out), n_in)


def _pack_merged(args, kwargs, out):
    n, b_pos = args[0].numel(), args[3]
    out_bytes = (4 + b_pos) * n + 24 * out[1].numel()
    return (24 * n + out_bytes, out_bytes)


def _assemble(args, kwargs, out):
    n, nU, S = args[0].numel(), args[3].numel() - 1, args[4]
    P = out[4].numel()
    return (32 * n + 8 * (nU + 1) + 4 * (2 * P + 1) + 4 * (S + 1),
            n + P + S)


def _init_covered(args, kwargs, out):
    n, U = args[0].numel(), args[2]
    return (8 * n + U, n + U)


def _greedy_steps_v2(args, kwargs, out):
    """The smaller of a full recompute every step and the incremental
    step's own work (the recompute once, each step's score pass), over
    the steps that picked.  The chosen sets' positions, which the
    incremental step also reads and writes, are left out: the least
    time is a little low, never high."""
    state, consts = args[0], args[1]
    U = state["covered"].numel()
    M, P = consts["ivl_start"].numel(), consts["univ_of_pair"].numel()
    S, nU = consts["cost"].numel(), consts["can_uncover"].numel()
    picks = out[2]

    def later():
        n = int(picks.sum())
        full = step_work(U, M, P, S, nU, 8, 8)
        full = (n * full[0], n * full[1])
        incr = (U + 4 * (U + 1) + 8 * M + 8 * P + 4
                + n * (8 * P + 13 * S + 8 * nU),
                U + M + P + n * (P + S))
        return min(full, incr, key=bound_s)
    return later


# Kernel wrappers by module and name, with their work functions.
WORK = {
    ("catch_tpu_torch.ops.scan_instance", "build_table"): _build_table,
    ("catch_tpu_torch.ops.scan_instance", "rolling_hash"): _rolling_hash,
    ("catch_tpu_torch.ops.scan_instance", "lookup_expand"): _lookup_expand,
    ("catch_tpu_torch.ops.scan_instance", "verify_windows"): _verify_windows,
    ("catch_tpu_torch.ops.scan_instance", "segmented_merge"):
        _segmented_merge,
    ("catch_tpu_torch.ops.scan_instance", "pack_merged"): _pack_merged,
    ("catch_tpu_torch.ops.scan_instance", "assemble"): _assemble,
    ("catch_tpu_torch.ops.set_cover", "init_covered"): _init_covered,
    ("catch_tpu_torch.ops.set_cover", "greedy_steps_v2"): _greedy_steps_v2,
}
