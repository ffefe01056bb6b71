// K1: the 32-bit rolling hashes of the scan, h = h * 0x9E3779B1 + c in
// uint32 arithmetic over kj codes; a window holding PAD (code 0) is
// invalid, every other hash is clamped to 0xFFFFFFFE.
//
// ct_seed_table (stage T) replaces catch_tpu/ops/scan_instance.py
// _build_table_jit (:129-162): the (hash, probe, offset) entry of every
// probe kj-mer, which the TPU program hashes over the flat rows [L
// codes][kj PAD] and sorts by hash.  Nothing downstream reads the hash
// order: K2 (csrc/lookup_expand.cu) merges a probe's offsets, so it
// wants the entries grouped by probe, the order the windows come in.
// So this kernel writes the table probe-major and sorts nothing: probe
// p's valid windows go, in offset order, to the first cnt[p] of its W =
// L - kj + 1 slots of ent (ent[p * W + k] = offset << 32 | hash), its
// other slots get 0, and a PAD window is counted out, never stored.
// One warp per probe: lane l hashes windows l, l + 32, ... straight
// from the probe row (kj bytes, from L1: the warp reads one row), and
// a ballot compacts each round of 32 windows into consecutive slots.
//
// Bound on the card: device-memory bandwidth, L bytes of codes read and
// 8 bytes a slot written per probe.  The 2 * kj operations of a
// window's multiply-adds take under a third of its 8 bytes' time up to
// kj = 24 (the scan's kj is 12 to 20).
//
// ct_rolling_hash (stage A) replaces _hash_samples_jit (:174-194): the
// hash at every stride-th corpus position; a window starting past
// last_pos is invalid too and gives the sentinel 0xFFFFFFFF.  Keys
// leave as int64 so torch.sort orders them.  One thread per output
// reads kj bytes (neighbouring threads share cache lines, so each byte
// comes from DRAM once) and writes 8 bytes.
#include "common.cuh"

#define ST_WARPS 8     // probes a block of ct_seed_table works on at once

__global__ void __launch_bounds__(32 * ST_WARPS)
seed_table_kernel(const uint8_t* __restrict__ codes, int64_t P, int64_t L,
                  int kj, int64_t W, int64_t* __restrict__ ent,
                  int32_t* __restrict__ cnt) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = (int64_t)gridDim.x * ST_WARPS;
    for (int64_t p = (int64_t)blockIdx.x * ST_WARPS + (threadIdx.x >> 5);
         p < P; p += warps) {
        const uint8_t* row = codes + p * L;
        int64_t* out = ent + p * W;
        int64_t n = 0;
        for (int64_t w0 = 0; w0 < W; w0 += 32) {
            const int64_t w = w0 + lane;
            uint32_t h = 0;
            bool ok = w < W;
            if (ok) {
                for (int j = 0; j < kj; ++j) {
                    const uint32_t c = __ldg(row + w + j);
                    h = h * 0x9E3779B1u + c;
                    ok = ok && c > 0;
                }
            }
            const unsigned valid = __ballot_sync(0xffffffffu, ok);
            if (ok) {
                const int k = __popc(valid & ((1u << lane) - 1u));
                out[n + k] = (int64_t)w << 32
                    | (h < 0xFFFFFFFEu ? h : 0xFFFFFFFEu);
            }
            n += __popc(valid);
        }
        for (int64_t k = n + lane; k < W; k += 32) out[k] = 0;
        if (lane == 0) cnt[p] = (int32_t)n;
    }
}

// codes: uint8[P, L]; ent: int64[P, W] with W = max(L - kj + 1, 0);
// cnt: int32[P].
extern "C" int ct_seed_table(const void* codes, int64_t P, int64_t L, int kj,
                             void* ent, void* cnt, void* stream) {
    if (P > 0) {
        const int64_t W = L >= kj ? L - kj + 1 : 0;
        int64_t blocks = (P + ST_WARPS - 1) / ST_WARPS;
        if (blocks > 65535) blocks = 65535;     // the warps loop over probes
        seed_table_kernel<<<(unsigned)blocks, 32 * ST_WARPS, 0,
                            ct_stream(stream)>>>(
            (const uint8_t*)codes, P, L, kj, W, (int64_t*)ent,
            (int32_t*)cnt);
    }
    return (int)cudaGetLastError();
}

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
