// The SSCS majority vote of one (family, position), shared by every kernel
// that votes: the one source of the vote's semantics on the card.
//
// Port of consensuscruncher_tpu/ops/consensus_pallas.py: _init_vote_state,
// _accumulate_member and _finalize_vote, which the TPU's plain and fused
// kernels share the same way.  On the TPU the state lives in VMEM scratch
// and one member arrives per grid step; here one thread folds a family's
// member rows into registers in a loop:
//   - a member whose qual is below qual_threshold votes N;
//   - the modal lane (A C G T N) wins, ties to the earliest first-seen member;
//   - it passes iff modal != N && max_count*den >= num*size && size > 0, an
//     exact int32 cross-multiply (the wrappers guard its range);
//   - a pass gives (modal, min(sum of agreeing quals, qual_cap)), else (N, 0).
// A base code past N (PAD) with a passing qual matches no lane: it counts
// in the denominator only, as in _accumulate_member.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cct {

constexpr int kLanes = 5;  // A C G T N
constexpr int kN = 4;

struct VoteState {
  int count[kLanes];
  int first[kLanes];
  int qsum[kLanes];
};

struct Vote {
  int base;
  int qual;
};

// _init_vote_state + _accumulate_member over members m = 0..size-1: member m
// is at byte m * row_stride from pb (bases) and pq (quals).
__device__ __forceinline__ void fold_members(VoteState& s,
                                             const uint8_t* __restrict__ pb,
                                             const uint8_t* __restrict__ pq,
                                             int size, int64_t row_stride,
                                             int qual_threshold) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    s.count[k] = 0;
    s.first[k] = size;  // first-seen starts past every member
    s.qsum[k] = 0;
  }
  for (int m = 0; m < size; ++m) {
    const int b = pb[m * row_stride];
    const int q = pq[m * row_stride];
    const bool ok = q >= qual_threshold;
    const int eff = ok ? b : kN;  // low-qual members vote N
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const bool eq = eff == k;
      s.count[k] += eq;
      s.first[k] = (eq && m < s.first[k]) ? m : s.first[k];
      s.qsum[k] += (ok && b == k) ? q : 0;
    }
  }
}

// _finalize_vote: max count, the unrolled argmin over first-seen, the
// rational cutoff, the capped quality.
__device__ __forceinline__ Vote finalize_vote(const VoteState& s, int size,
                                              int num, int den, int qual_cap) {
  int max_count = s.count[0];
#pragma unroll
  for (int k = 1; k < kLanes; ++k) max_count = max(max_count, s.count[k]);
  int modal = 0;
  int best_first = s.count[0] == max_count ? s.first[0] : size + 1;
#pragma unroll
  for (int k = 1; k < kLanes; ++k) {
    const int cand = s.count[k] == max_count ? s.first[k] : size + 1;
    if (cand < best_first) {
      best_first = cand;
      modal = k;
    }
  }
  int q = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) q = modal == k ? s.qsum[k] : q;
  const bool passed = modal != kN && max_count * den >= num * size && size > 0;
  return Vote{passed ? modal : kN, passed ? min(q, qual_cap) : 0};
}

}  // namespace cct
