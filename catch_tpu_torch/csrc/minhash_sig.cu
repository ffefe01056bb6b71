// K8 minhash_sig: the MinHash signature matrix of the near-duplicate
// filter, sig[u, h] = min over j of (a_h * codes[u, j] + b_h) mod (2^31 - 1).
//
// Replaces catch_tpu/utils/lsh.py's signature program (the kernel of
// _minhash_sig_kernel_factory, :257, with _modmul_affine_u32, :223).  The
// TPU's vector units have no 64-bit multiply, so catch_tpu splits the
// product into 16-bit limbs with Mersenne folds.  Here the product and
// the sum are one 32 x 32 -> 64-bit multiply-add, exact: a <= p, b <= p
// and x < p (p = 2^31 - 1), so v = a * x + b <= p * p < 2^62.  Two
// Mersenne folds (2^31 = 1 mod p) then take v to s in [0, p] with s = v
// mod p, where s = p stands for 0:
//   s1 = (v >> 31) + (v & p) < 2^32,  s = (s1 >> 31) + (s1 & p) <= p,
// and min(s, s - p) in unsigned arithmetic is the residue.  Each value
// equals numpy's uint64 path (lsh.py:380-391) bit for bit.
//
// A block stages the codes of its rows in shared memory, in chunks of
// up to SIG_CHUNK columns (read as 16-byte loads; rows padded by 4 words
// so that the rows of one warp fall on distinct banks), and each thread keeps
// SIG_HPT hash functions (a, b) and their running minima in registers:
// one code from shared memory serves SIG_HPT products.  Threads of a row
// take neighbouring groups of hash functions and write neighbouring
// outputs of the (U, H) matrix.
//
// Bound on the card: integer work, U * n * H products, folds and minima,
// against U * n + 2H + U * H words of memory; 7 instructions of a lane
// per (u, j, h): the multiply-add, two folds of two instructions each
// (and, then shift-and-add), min(s, s - p) and the running minimum.
#include "common.cuh"

#define SIG_P 0x7FFFFFFFu
#define SIG_HPT 4
#define SIG_THREADS 256
#define SIG_CHUNK 256
#define SIG_SMEM (48 * 1024)

// (a * x + b) mod p for a, b <= p and x < p, as s in [0, p] (s = p for 0).
// The product and sum are one mad.wide.u32 (written out: the compiler
// multiplies a 64-bit a otherwise).
__device__ __forceinline__ uint32_t sig_fold(uint32_t a, uint32_t x,
                                             uint32_t b) {
    uint64_t v;
    asm("mad.wide.u32 %0, %1, %2, %3;"
        : "=l"(v) : "r"(a), "r"(x), "l"((uint64_t)b));
    const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
    const uint32_t s1 = __funnelshift_l(lo, hi, 1) + (lo & SIG_P);
    return (s1 >> 31) + (s1 & SIG_P);
}

__global__ void __launch_bounds__(SIG_THREADS)
minhash_sig_kernel(const int32_t* __restrict__ codes, int64_t U, int n,
                   const int32_t* __restrict__ ab, int H, int groups,
                   int rows, int chunk, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t stage[];
    const int stride = chunk + 4;
    const int per_block = blockDim.x / rows;  // groups of this block
    const int ul = threadIdx.x / per_block;
    const int g = blockIdx.y * per_block + threadIdx.x % per_block;
    const int64_t u0 = (int64_t)blockIdx.x * rows;
    const int nu = U - u0 < rows ? (int)(U - u0) : rows;
    uint32_t a[SIG_HPT], b[SIG_HPT], m[SIG_HPT];
#pragma unroll
    for (int k = 0; k < SIG_HPT; ++k) {
        const int h = g * SIG_HPT + k;
        a[k] = h < H ? (uint32_t)__ldg(ab + 2 * h) : 0u;
        b[k] = h < H ? (uint32_t)__ldg(ab + 2 * h + 1) : 0u;
        m[k] = 0xFFFFFFFFu;
    }
    const int32_t* row = stage + ul * stride;
    for (int j0 = 0; j0 < n; j0 += chunk) {
        const int len = min(chunk, n - j0);
        __syncthreads();
        for (int i = threadIdx.x; i < nu * len; i += blockDim.x) {
            const int t = i / len, jj = i - t * len;
            stage[t * stride + jj] = codes[(u0 + t) * n + j0 + jj];
        }
        __syncthreads();
        if (ul >= nu) continue;
        int jj = 0;
        for (; jj + 4 <= len; jj += 4) {
            const int4 x4 = *reinterpret_cast<const int4*>(row + jj);
            const uint32_t xs[4] = {(uint32_t)x4.x, (uint32_t)x4.y,
                                    (uint32_t)x4.z, (uint32_t)x4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
                for (int k = 0; k < SIG_HPT; ++k) {
                    const uint32_t s = sig_fold(a[k], xs[c], b[k]);
                    m[k] = min(m[k], min(s, s - SIG_P));
                }
            }
        }
        for (; jj < len; ++jj) {
            const uint32_t x = (uint32_t)row[jj];
#pragma unroll
            for (int k = 0; k < SIG_HPT; ++k) {
                const uint32_t s = sig_fold(a[k], x, b[k]);
                m[k] = min(m[k], min(s, s - SIG_P));
            }
        }
    }
    if (ul >= nu || g >= groups) return;
    int32_t* o = out + (u0 + ul) * H;
#pragma unroll
    for (int k = 0; k < SIG_HPT; ++k) {
        const int h = g * SIG_HPT + k;
        if (h < H) o[h] = (int32_t)m[k];
    }
}

extern "C" int ct_minhash_sig(const void* codes, int64_t U, int n,
                              const void* ab, int H, void* out,
                              void* stream) {
    if (U > 0 && H > 0) {
        // groups of SIG_HPT hash functions: a block takes up to
        // SIG_THREADS of them (more ride the grid's y) for as many rows
        // as make SIG_THREADS threads
        const int groups = (H + SIG_HPT - 1) / SIG_HPT;
        const int per_block = groups < SIG_THREADS ? groups : SIG_THREADS;
        const int rows = SIG_THREADS / per_block;
        // columns a chunk stages: SIG_CHUNK, or fewer (a multiple of 4)
        // where the block's rows would pass SIG_SMEM bytes
        int chunk = (int)(SIG_SMEM / sizeof(int32_t)) / rows - 4;
        chunk = chunk < SIG_CHUNK ? chunk & ~3 : SIG_CHUNK;
        const size_t smem = (size_t)rows * (chunk + 4) * sizeof(int32_t);
        dim3 grid(ct_blocks(U, rows),
                  (unsigned)((groups + per_block - 1) / per_block));
        minhash_sig_kernel<<<grid, rows * per_block, smem,
                             ct_stream(stream)>>>(
            (const int32_t*)codes, U, n, (const int32_t*)ab, H, groups, rows,
            chunk, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
