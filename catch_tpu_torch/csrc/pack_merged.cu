// K9 pack_merged: the merged set-cover instance packed for its readback.
//
// Replaces catch_tpu/ops/scan_instance.py _pack_merged_jit (:611-658).
// The merged rows (key, start, end) are sorted by key, so the key delta
// from the previous row is nonnegative and usually tiny.  Each row
// becomes 4 + b_pos little-endian bytes:
//   u16 key delta (from 0 for the first row), b_pos bytes of start,
//   u16 length end - start.
// A row whose key delta or length exceeds 16 bits stores 0 in that field
// and is listed in the escape arrays with its row index, absolute key and
// end, which the host decoder applies (scan_instance.unpack_merged).  The
// caller picks b_pos from the largest universe-local coordinate, so a
// start always fits.
//
// Two passes, as the other compactions here:
//   1. rows: one thread per row writes its bytes and its escape flag;
//   2. escapes: torch.cumsum of the flags gives each escaped row its slot,
//      and the row writes (index, key, end) there.
// catch_tpu's fixed escape capacity and its unpacked fallback on overflow
// go: the escape arrays are sized from the count.
//
// Bound on the card: device-memory bandwidth (three 8-byte reads and
// 4 + b_pos + 8 bytes of writes per row).
#include "common.cuh"

__global__ void pack_rows_kernel(const int64_t* __restrict__ k,
                                 const int64_t* __restrict__ s,
                                 const int64_t* __restrict__ e, int64_t n,
                                 int b_pos, uint8_t* __restrict__ packed,
                                 int64_t* __restrict__ esc) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int64_t dk = k[i] - (i > 0 ? k[i - 1] : 0);
    int64_t ln = e[i] - s[i];
    const int64_t sv = s[i];
    const bool key_esc = dk > 0xFFFF;
    const bool len_esc = ln > 0xFFFF;
    if (key_esc) dk = 0;
    if (len_esc) ln = 0;
    uint8_t* row = packed + i * (4 + b_pos);
    row[0] = (uint8_t)(dk & 0xFF);
    row[1] = (uint8_t)((dk >> 8) & 0xFF);
    for (int b = 0; b < b_pos; ++b)
        row[2 + b] = (uint8_t)((sv >> (8 * b)) & 0xFF);
    row[2 + b_pos] = (uint8_t)(ln & 0xFF);
    row[3 + b_pos] = (uint8_t)((ln >> 8) & 0xFF);
    esc[i] = (key_esc || len_esc) ? 1 : 0;
}

__global__ void pack_escapes_kernel(const int64_t* __restrict__ k,
                                    const int64_t* __restrict__ e,
                                    const int64_t* __restrict__ esc,
                                    const int64_t* __restrict__ pos_incl,
                                    int64_t n, int64_t* __restrict__ esc_idx,
                                    int64_t* __restrict__ esc_key,
                                    int64_t* __restrict__ esc_end) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !esc[i]) return;
    const int64_t r = pos_incl[i] - 1;
    esc_idx[r] = i;
    esc_key[r] = k[i];
    esc_end[r] = e[i];
}

extern "C" int ct_pack_rows(const void* k, const void* s, const void* e,
                            int64_t n, int b_pos, void* packed, void* esc,
                            void* stream) {
    if (n > 0) {
        pack_rows_kernel<<<ct_blocks(n, 256), 256, 0, ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)s, (const int64_t*)e, n, b_pos,
            (uint8_t*)packed, (int64_t*)esc);
    }
    return (int)cudaGetLastError();
}

extern "C" int ct_pack_escapes(const void* k, const void* e, const void* esc,
                               const void* pos_incl, int64_t n, void* esc_idx,
                               void* esc_key, void* esc_end, void* stream) {
    if (n > 0) {
        pack_escapes_kernel<<<ct_blocks(n, 256), 256, 0,
                              ct_stream(stream)>>>(
            (const int64_t*)k, (const int64_t*)e, (const int64_t*)esc,
            (const int64_t*)pos_incl, n, (int64_t*)esc_idx,
            (int64_t*)esc_key, (int64_t*)esc_end);
    }
    return (int)cudaGetLastError();
}
