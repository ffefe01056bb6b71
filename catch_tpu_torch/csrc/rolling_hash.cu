// K1 rolling_hash: the 32-bit rolling hash of kj codes at every
// stride-th position of a uint8 code array.
//
// Replaces catch_tpu/ops/scan_instance.py _build_table_jit (:129-162,
// stride 1 over the probe rows [L codes][kj PAD]) and _hash_samples_jit
// (:174-194, stride s over the corpus).  h = h * 0x9E3779B1 + c in
// uint32 arithmetic; a window holding PAD (code 0) or starting past
// last_pos gives the sentinel 0xFFFFFFFF, every other hash is clamped
// to 0xFFFFFFFE.  Keys leave as int64 so torch.sort orders them.
//
// Bound on the card: device-memory bandwidth.  One thread per output
// reads kj bytes (stride 1: neighbouring threads share cache lines, so
// each byte comes from DRAM once) and writes 8 bytes.
#include "common.cuh"

__global__ void rolling_hash_kernel(const uint8_t* __restrict__ codes,
                                    int64_t n_out, int64_t stride, int kj,
                                    int64_t last_pos,
                                    int64_t* __restrict__ out) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_out) return;
    int64_t pos = i * stride;
    const uint8_t* c = codes + pos;
    uint32_t h = 0;
    bool ok = pos <= last_pos;
    for (int j = 0; j < kj; ++j) {
        uint32_t cj = c[j];
        h = h * 0x9E3779B1u + cj;
        ok = ok && cj > 0;
    }
    out[i] = ok ? (int64_t)(h < 0xFFFFFFFEu ? h : 0xFFFFFFFEu) : CT_HMAX;
}

extern "C" int ct_rolling_hash(const void* codes, int64_t n_out,
                               int64_t stride, int kj, int64_t last_pos,
                               void* out, void* stream) {
    if (n_out > 0) {
        rolling_hash_kernel<<<ct_blocks(n_out, 256), 256, 0,
                              ct_stream(stream)>>>(
            (const uint8_t*)codes, n_out, stride, kj, last_pos,
            (int64_t*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
