"""The MinHash kernels of clustering and the near-duplicate filter.

K7 minhash_caps (csrc/minhash_caps.cu) evaluates the capped-union
MinHash estimator of catch_tpu/utils/cluster.py for every (query,
representative) pair of two signature matrices, with one shared device
function and four outputs:

  minhash_dists   float32 distances 1 - cap/N      (_row_dists_kernel,
                                                    _block_dists_kernel)
  minhash_codes   uint8 threshold codes 0/1/2      (_block_codes_kernel)
  minhash_caps    uint8 (N <= 255) or int32 counts (_pair_caps_jit)
  minhash_assign  best representative per query    (_assign_to_reps_jit)

K8 minhash_sig (csrc/minhash_sig.cu) computes the near-duplicate
filter's signature matrix from k-mer codes and the (a, b) table of
catch_tpu/utils/lsh.py (the kernel of _minhash_sig_kernel_factory).

Signatures are int32 (hash values lie below 2^31 - 1) with ascending
rows; the CUDA wrappers check the order of every matrix they are given
and raise on an unsorted row.  Left out from catch_tpu, as workarounds
for the TPU: the power-of-two padding of queries and representatives
and the copy of row 0 used as row padding.

Every kernel wrapper runs its plain-PyTorch twin (same module, name
suffixed _plain) for CPU tensors and its kernel for CUDA tensors, and
counts its kernel launches in an integer attribute `launches`.  The
wrappers are registered in scan_instance.KERNELS.
"""

import torch

from catch_tpu_torch import _build
from catch_tpu_torch.ops import scan_instance as si

__all__ = ["minhash_dists", "minhash_codes", "minhash_caps",
           "minhash_assign", "minhash_sig", "MERSENNE_P"]

MERSENNE_P = 2**31 - 1

# A block stages 32 representative rows and at least one query row of
# N + 1 int32 in shared memory (csrc/minhash_caps.cu): 33 * (N + 1) * 4
# bytes of the 227 KB a block may use.
_MAX_N = 1536

# Blocks of the row-order check (minhash_order_kernel): each writes one
# flag byte, read back in one copy (MH_ORDER_MAX_BLOCKS).
_ORDER_BLOCKS = 264

# Representatives a group of the assign kernel holds (MH_LANES): one
# 64-bit key a group and query goes to its reduction.
_GROUP = 32


# ----------------------------------------------------------------------
# K7 minhash_caps
# ----------------------------------------------------------------------

def _check_pair(qs, rs):
    """N of two int32 signature matrices of equal width, and whether
    they lie on the CPU; on CUDA, N must be at most _MAX_N."""
    si._require(qs, torch.int32, "qs")
    si._require(rs, torch.int32, "rs")
    if qs.dim() != 2 or rs.dim() != 2 or qs.shape[1] != rs.shape[1]:
        raise ValueError("qs and rs must be [Q, N] and [R, N] signatures")
    N = qs.shape[1]
    if N < 1:
        raise ValueError("signatures must not be empty")
    if si._on_cpu(qs, rs):
        return N, True
    if N > _MAX_N:
        raise ValueError(f"signature length {N} exceeds the kernel's "
                         f"{_MAX_N}")
    return N, False


def _walk(entry, qs, rs, *args):
    """Call csrc/minhash_caps.cu's entry point `entry` on qs and rs, with
    `args` after their pointers and row counts and before the flag
    arguments.  The one call checks that every row of qs and rs ascends
    (minhash_order_kernel, one pass over both), launches the kernels
    and waits for the flags, its only synchronisation; an unsorted row
    raises ValueError."""
    N = qs.shape[1]
    words = (qs.shape[0] + rs.shape[0]) * N
    blocks = min(_ORDER_BLOCKS, -(-words // 1024)) if N > 1 else 0
    flags = torch.empty(max(blocks, 1), dtype=torch.uint8, device=qs.device)
    rc = getattr(_build.library(), entry)(
        _build.ptr(qs), qs.shape[0], _build.ptr(rs), rs.shape[0], *args,
        _build.ptr(flags), blocks, _build.stream_of(qs))
    for bit, name in ((1, "qs"), (2, "rs")):
        if rc < 0 and -rc & bit:
            raise ValueError(f"{name} holds a row that is not ascending; "
                             "the kernel walks sorted signatures")
    _build.check(rc, entry)


@_build.on_own_device
def minhash_dists(qs, rs):
    """float32 [Q, R] capped-union MinHash distances 1 - cap/N of every
    query row against every representative row, bitwise equal to
    catch_tpu's 1.0 - cap.astype(float32) / N as XLA compiles it:
    fma(-cap, float32(1/N), 1.0) with one rounding."""
    N, cpu = _check_pair(qs, rs)
    if cpu:
        return _minhash_dists_plain(qs, rs)
    out = torch.empty((qs.shape[0], rs.shape[0]), dtype=torch.float32,
                      device=qs.device)
    _walk("ct_minhash_dists", qs, rs, N, _build.ptr(out))
    minhash_dists.launches += 1
    return out


minhash_dists.launches = 0


@_build.on_own_device
def minhash_codes(qs, rs, cap_thr, cap_early):
    """uint8 [Q, R] adjacency codes: 0 where cap < cap_thr, 1 where
    cap >= cap_thr, 2 where also cap >= cap_early."""
    N, cpu = _check_pair(qs, rs)
    if cpu:
        return _minhash_codes_plain(qs, rs, cap_thr, cap_early)
    out = torch.empty((qs.shape[0], rs.shape[0]), dtype=torch.uint8,
                      device=qs.device)
    _walk("ct_minhash_codes", qs, rs, N, int(cap_thr), int(cap_early),
          _build.ptr(out))
    minhash_codes.launches += 1
    return out


minhash_codes.launches = 0


@_build.on_own_device
def minhash_caps(qs, rs):
    """[Q, R] capped intersection counts, uint8 for N <= 255 and int32
    above (a count reaches N)."""
    N, cpu = _check_pair(qs, rs)
    if cpu:
        return _minhash_caps_plain(qs, rs)
    wide = N > 255
    out = torch.empty((qs.shape[0], rs.shape[0]),
                      dtype=torch.int32 if wide else torch.uint8,
                      device=qs.device)
    _walk("ct_minhash_caps", qs, rs, N, int(wide), _build.ptr(out))
    minhash_caps.launches += 1
    return out


minhash_caps.launches = 0


@_build.on_own_device
def minhash_assign(qs, rs, n_reps, cap_thr):
    """Best representative among the first n_reps rows of rs for every
    query: (int64 [Q] index of the largest cap, first on ties; bool [Q]
    whether that cap reaches cap_thr).  With n_reps = 0 every index is
    0 and no query is within the threshold."""
    N, cpu = _check_pair(qs, rs)
    if not 0 <= n_reps <= rs.shape[0]:
        raise ValueError(f"n_reps={n_reps} is outside [0, {rs.shape[0]}]")
    if cpu:
        return _minhash_assign_plain(qs, rs, n_reps, cap_thr)
    Q = qs.shape[0]
    best = torch.empty(Q, dtype=torch.int64, device=qs.device)
    ok = torch.empty(Q, dtype=torch.bool, device=qs.device)
    groups = -(-int(n_reps) // _GROUP)
    part = torch.empty(Q * groups if groups > 1 else 0, dtype=torch.int64,
                       device=qs.device)
    _walk("ct_minhash_assign", qs, rs, int(n_reps), N, int(cap_thr),
          _build.ptr(best), _build.ptr(ok), _build.ptr(part))
    minhash_assign.launches += 1
    return best, ok


minhash_assign.launches = 0


def _capped_counts_plain(qs, rs):
    """int64 [Q, R] capped counts: the column scan of catch_tpu's
    _block_dists_kernel written out, over blocks of query rows so that
    the broadcast [rows, R, N] stays small."""
    (Q, N), R = qs.shape, rs.shape[0]
    dev = qs.device
    out = torch.empty((Q, R), dtype=torch.int64, device=dev)
    rows = max(1, (1 << (22 if dev.type == "cpu" else 27)) // max(1, R * N))
    for q0 in range(0, Q, rows):
        A = qs[q0:q0 + rows, None, :]
        cm = torch.zeros((A.shape[0], R), dtype=torch.int64, device=dev)
        cap = torch.zeros_like(cm)
        for j in range(N):
            v = rs[None, :, j, None]
            lt = (A < v).sum(-1)
            eq = (A == v).any(-1)
            ok = eq & (lt + j - cm + 1 <= N)
            cm += eq
            cap += ok
        out[q0:q0 + rows] = cap
    return out


def _minhash_dists_plain(qs, rs):
    """Plain-PyTorch twin of minhash_dists: fma(-cap, 1/N, 1) rounded
    once to float32.  In float64 the product of cap and the float32
    reciprocal and the difference from 1 are exact for N < 2^20, so
    the one rounding is the last cast."""
    cap = _capped_counts_plain(qs, rs).to(torch.float64)
    return (1.0 - cap * _f32_reciprocal(qs.shape[1])).to(torch.float32)


def _f32_reciprocal(N):
    """The float32 nearest 1/N, as a Python float."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(float(N), dtype=torch.float32))


def _minhash_codes_plain(qs, rs, cap_thr, cap_early):
    """Plain-PyTorch twin of minhash_codes."""
    cap = _capped_counts_plain(qs, rs)
    wt = cap >= cap_thr
    return wt.to(torch.uint8) + (wt & (cap >= cap_early)).to(torch.uint8)


def _minhash_caps_plain(qs, rs):
    """Plain-PyTorch twin of minhash_caps."""
    return _capped_counts_plain(qs, rs).to(
        torch.int32 if qs.shape[1] > 255 else torch.uint8)


def _minhash_assign_plain(qs, rs, n_reps, cap_thr):
    """Plain-PyTorch twin of minhash_assign (argmax takes the first
    maximum)."""
    Q = qs.shape[0]
    if n_reps == 0:
        return (torch.zeros(Q, dtype=torch.int64, device=qs.device),
                torch.zeros(Q, dtype=torch.bool, device=qs.device))
    cap = _capped_counts_plain(qs, rs[:n_reps])
    return torch.argmax(cap, 1), cap.amax(1) >= cap_thr


# ----------------------------------------------------------------------
# K8 minhash_sig
# ----------------------------------------------------------------------

@_build.on_own_device
def minhash_sig(codes, ab):
    """int32 [U, H] MinHash signature matrix: entry (u, h) is the least
    (a_h * codes[u, j] + b_h) mod (2^31 - 1) over j.

    Args:
        codes: int32 [U, n] k-mer codes, each below 2^31 - 1, n >= 1
        ab: int32 [H, 2] hash parameters, a in [1, 2^31 - 1] and b in
            [0, 2^31 - 1]
    """
    si._require(codes, torch.int32, "codes")
    si._require(ab, torch.int32, "ab")
    if codes.dim() != 2 or ab.dim() != 2 or ab.shape[1] != 2:
        raise ValueError("codes must be [U, n] and ab [H, 2]")
    U, n = codes.shape
    if n < 1:
        raise ValueError("every point needs at least one k-mer")
    if si._on_cpu(codes, ab):
        return _minhash_sig_plain(codes, ab)
    H = ab.shape[0]
    out = torch.empty((U, H), dtype=torch.int32, device=codes.device)
    lib = _build.library()
    _build.check(lib.ct_minhash_sig(
        _build.ptr(codes), U, n, _build.ptr(ab), H, _build.ptr(out),
        _build.stream_of(codes)), "minhash_sig")
    minhash_sig.launches += 1
    return out


minhash_sig.launches = 0


def _minhash_sig_plain(codes, ab):
    """Plain-PyTorch twin of minhash_sig: int64 arithmetic, one hash
    function at a time (the product stays below 2^62)."""
    x = codes.to(torch.int64)
    ab64 = ab.to(torch.int64)
    out = torch.empty((codes.shape[0], ab.shape[0]), dtype=torch.int32,
                      device=codes.device)
    for h in range(ab.shape[0]):
        out[:, h] = ((x * ab64[h, 0] + ab64[h, 1]) % MERSENNE_P).amin(1)
    return out


si.KERNELS.update(minhash_dists=minhash_dists, minhash_codes=minhash_codes,
                  minhash_caps=minhash_caps, minhash_assign=minhash_assign,
                  minhash_sig=minhash_sig)
