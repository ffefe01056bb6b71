// K8 minhash_sig: the MinHash signature matrix of the near-duplicate
// filter, sig[u, h] = min over j of (a_h * codes[u, j] + b_h) mod (2^31 - 1).
//
// Replaces catch_tpu/utils/lsh.py's signature program (the kernel of
// _minhash_sig_kernel_factory, :257, with _modmul_affine_u32, :223).  The
// TPU's vector units have no 64-bit multiply, so catch_tpu splits the
// product into 16-bit limbs with Mersenne folds.  The card multiplies
// 64-bit integers natively, and the plain product is exact: a <= 2^31 - 1
// and x < 2^31 - 1, so a * x < 2^62 and a * x + b < 2^63 fit in uint64.
// Each value equals numpy's uint64 path (lsh.py:380-391) bit for bit.
//
// One thread per (u, h): the threads of a warp share the row u (read
// through L1) and write neighbouring outputs of the (U, H) matrix.
//
// Bound on the card: integer work, U * n * H products, remainders and
// minima, against U * n + 2H + U * H words of memory.  The 64-bit
// remainder is a multi-instruction sequence; staging rows in shared
// memory and looping over h inside a thread is left for later.
#include "common.cuh"

#define CT_MERSENNE_P 2147483647ull

__global__ void minhash_sig_kernel(const int32_t* __restrict__ codes,
                                   int64_t U, int n,
                                   const int32_t* __restrict__ ab, int H,
                                   int32_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= U * H) return;
    const int64_t u = i / H;
    const int h = (int)(i % H);
    const uint64_t a = (uint32_t)ab[2 * h], b = (uint32_t)ab[2 * h + 1];
    const int32_t* row = codes + u * n;
    uint64_t m = ~0ull;
    for (int j = 0; j < n; ++j) {
        const uint64_t v = (a * (uint32_t)row[j] + b) % CT_MERSENNE_P;
        m = v < m ? v : m;
    }
    out[i] = (int32_t)m;
}

extern "C" int ct_minhash_sig(const void* codes, int64_t U, int n,
                              const void* ab, int H, void* out,
                              void* stream) {
    if (U > 0 && H > 0) {
        minhash_sig_kernel<<<ct_blocks(U * H, 256), 256, 0,
                             ct_stream(stream)>>>(
            (const int32_t*)codes, U, n, (const int32_t*)ab, H,
            (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
