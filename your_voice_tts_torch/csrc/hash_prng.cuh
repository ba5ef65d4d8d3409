// Counter-based hash PRNG, bit-exact with the JAX package's
// ops/pallas/wavernn_gen.py `_fmix32` / `_uniform` and with the port's plain
// version (your_voice_tts_torch/ops/prng.py). All arithmetic is uint32_t: the
// JAX version's wrapping int32 products and logical shifts are exactly
// uint32 arithmetic.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t hash_fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// per-step key: fmix32(seed + step * 0x9E3779B9)
__device__ __forceinline__ uint32_t hash_step_key(uint32_t seed, uint32_t step) {
    return hash_fmix32(seed + step * 0x9E3779B9u);
}

// Uniform(0, 1) for element index `lin` (= row * width + col) under `key`
// and call `salt`; (mant + 0.5) / 2^24 exactly as the reference computes it.
__device__ __forceinline__ float hash_uniform(uint32_t lin, uint32_t key, uint32_t salt) {
    uint32_t x = hash_fmix32(lin * 0x9E3779B9u + key + salt * 7919u);
    float mant = (float)(x & 0xFFFFFFu);
    return (mant + 0.5f) * (1.0f / 16777216.0f);
}
