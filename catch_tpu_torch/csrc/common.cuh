// Shared definitions of the scan kernels (see catch_tpu_torch/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Hash sentinel: invalid kj-mers carry it, valid hashes are clamped
// below it (catch_tpu/ops/scan_instance.py _HMAX).
#define CT_HMAX 0xFFFFFFFFll

static inline unsigned ct_blocks(int64_t n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

static inline cudaStream_t ct_stream(void* s) {
    return reinterpret_cast<cudaStream_t>(s);
}
