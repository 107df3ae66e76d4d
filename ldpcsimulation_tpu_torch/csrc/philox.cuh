// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11 — the Random123
// philox4x32 with 10 rounds).  Shared by the channel kernels, so every
// uniform the port draws on the card comes from one definition; its plain
// PyTorch twin is ldpcsimulation_tpu_torch/kernels/channel.py::philox4x32_10.
//
// Known answer (Random123 kat_vectors): counter 0, key 0 ->
// 6627e8d5 e169c58d bc57ac4c 9b00dbd8.
#pragma once

#include <cstdint>

namespace ldpc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1

__device__ __forceinline__ void philox4x32_10(const uint32_t ctr_in[4],
                                              const uint32_t key_in[2],
                                              uint32_t out[4]) {
  uint32_t c0 = ctr_in[0], c1 = ctr_in[1], c2 = ctr_in[2], c3 = ctr_in[3];
  uint32_t k0 = key_in[0], k1 = key_in[1];
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0, hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2, hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

}  // namespace ldpc
