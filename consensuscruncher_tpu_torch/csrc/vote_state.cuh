// The SSCS majority vote of one (family, position), shared by every kernel
// that votes: the one source of the vote's semantics on the card.
//
// Port of consensuscruncher_tpu/ops/consensus_pallas.py: _init_vote_state,
// _accumulate_member and _finalize_vote, which the TPU's plain and fused
// kernels share the same way.  The semantics:
//   - a member whose qual is below qual_threshold votes N;
//   - the modal lane (A C G T N) wins, ties to the earliest first-seen member;
//   - it passes iff modal != N && max_count*den >= num*size && size > 0, an
//     exact int32 cross-multiply (the wrappers guard its range);
//   - a pass gives (modal, min(sum of agreeing quals, qual_cap)), else (N, 0).
// A base code past N (PAD) with a passing qual matches no lane: it counts
// in the denominator only, as in _accumulate_member.
//
// On the TPU the state is five counts, five first-seen ranks and five
// quality sums per position.  Here it is leaner, for the same result:
//   - no first-seen ranks.  The rank only breaks a tie at the top count, and
//     only a vote that passes the cutoff needs its modal lane, so finalize
//     rescans the family's members for the first one whose lane is tied
//     (rare: never at a cutoff above 1/2);
//   - no quality sum for N: an N modal never passes;
//   - a member enters the fold as (base code, increment): the increment is
//     0 when its qual fails (it votes N), else one count plus its qual in
//     the packed layout below, so the qual test is made once per member
//     (for a packed wire, once per codebook entry: increment());
//   - for a family of at most kPackedMax members, each lane is one
//     register, count << 19 | quality sum << 3 | lane (PackedTally):
//     folding a member into a lane is one compare and one add, and the
//     lanes' maximum is the modal lane with its sum whenever it is unique,
//     which it is whenever 2 * max_count > size (always, for a vote that
//     passes a cutoff above 1/2).  Larger families keep counts and sums
//     apart (WideTally).
//
// The QC rider (port of the with_qc planes of _stream_vote_fn) reads the
// same tally: qc() gives, for one (family, position), the members whose
// effective lane is one of A C G T N (a PAD code with a passing qual joins
// none) and the top count, whether or not the vote passes the cutoff; the
// rider's disagree is their difference.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cct {

constexpr int kLanes = 5;  // A C G T N
constexpr int kN = 4;
// PackedTally's layout: a count <= 256 fits bits 19..27, a quality sum
// <= 256 * 255 bits 3..18, the lane bits 0..2
constexpr int kPackedMax = 256;
constexpr int kCountShift = 19;
constexpr int kSumShift = 3;
constexpr uint32_t kCountOne = 1u << kCountShift;

struct Vote {
  int base;
  int qual;
};

struct QcPart {
  int votes;  // members in a lane
  int top;    // the top count of a lane
};

// A member's increment at one position from its Phred q: 0 if q fails the
// threshold, else one count plus q.
__device__ __forceinline__ uint32_t increment(int q, int qual_threshold) {
  return q >= qual_threshold ? kCountOne + (static_cast<uint32_t>(q) << kSumShift) : 0u;
}

// The effective lane of one member at one position (base code b,
// increment e): its base when its qual passes, else N.
__device__ __forceinline__ int effective_lane(int b, uint32_t e) { return e ? b : kN; }

struct PackedTally {
  uint32_t acc[kLanes];  // lane k: count << 19 | quality sum << 3 | k (N: no sum)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = static_cast<uint32_t>(k);
  }
  // _accumulate_member for one member (base code b, increment e); a base
  // past N (PAD) with a passing qual joins no lane
  __device__ __forceinline__ void fold(int b, uint32_t e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += b == k ? e : 0u;
    acc[kN] += (e == 0u || b == kN) ? kCountOne : 0u;
  }
  __device__ __forceinline__ int count(int k) const {
    return static_cast<int>(acc[k] >> kCountShift);
  }
  __device__ __forceinline__ int qsum(int k) const {
    return static_cast<int>((acc[k] >> kSumShift) & 0xFFFFu);
  }
  // The counts sit above the sums, so the lanes' maximum holds the top
  // count.  The lanes' total is the members in a lane above bit 19: each
  // passing member's qual is in one lane only, so the sums add up to at
  // most kPackedMax * 255, which with the lane indices (0 + 1 + 2 + 3 + 4)
  // stays below 2^16 << 3 and never carries into the counts.
  __device__ __forceinline__ QcPart qc() const {
    uint32_t top = acc[0], total = acc[0];
#pragma unroll
    for (int k = 1; k < kLanes; ++k) {
      top = max(top, acc[k]);
      total += acc[k];
    }
    return QcPart{static_cast<int>(total >> kCountShift), static_cast<int>(top >> kCountShift)};
  }
};

struct WideTally {
  int cnt[kLanes];
  int qs[4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) cnt[k] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) qs[k] = 0;
  }
  __device__ __forceinline__ void fold(int b, uint32_t e) {
    const int eff = effective_lane(b, e);
    const int q = static_cast<int>((e >> kSumShift) & 0xFFFFu);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) cnt[k] += eff == k;
#pragma unroll
    for (int k = 0; k < 4; ++k) qs[k] += eff == k ? q : 0;
  }
  __device__ __forceinline__ int count(int k) const { return cnt[k]; }
  __device__ __forceinline__ int qsum(int k) const { return qs[k]; }
  __device__ __forceinline__ QcPart qc() const {
    QcPart r{cnt[0], cnt[0]};
#pragma unroll
    for (int k = 1; k < kLanes; ++k) {
      r.votes += cnt[k];
      r.top = max(r.top, cnt[k]);
    }
    return r;
  }
};

// _finalize_vote.  lane_of(m) is the effective lane of member m at this
// position; it is called only to break a tie at the top count of a vote
// that passes the cutoff.
template <class Tally, class LaneOf>
__device__ __forceinline__ Vote finalize(const Tally& t, int size, int num, int den,
                                         int qual_cap, LaneOf&& lane_of) {
  int c[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) c[k] = t.count(k);
  int max_count = c[0];
#pragma unroll
  for (int k = 1; k < kLanes; ++k) max_count = max(max_count, c[k]);
  if (!(size > 0 && max_count * den >= num * size)) return Vote{kN, 0};
  unsigned tied = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) tied |= (c[k] == max_count ? 1u : 0u) << k;
  int modal = __ffs(tied) - 1;  // the lowest tied lane, as the argmin picks
  if (tied & (tied - 1)) {
    // Tied lanes with max_count > 0 have all been seen: the first member in
    // one of them is the earliest first-seen.  With max_count == 0 no
    // member is in a lane and the lowest lane stands.
    for (int m = 0; m < size; ++m) {
      const int eff = lane_of(m);
      if (eff >= 0 && eff < kLanes && ((tied >> eff) & 1u)) {
        modal = eff;
        break;
      }
    }
  }
  if (modal == kN) return Vote{kN, 0};
  int q = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) q = modal == k ? t.qsum(k) : q;
  return Vote{modal, min(q, qual_cap)};
}

// _finalize_vote on the packed lanes: their maximum holds the top count,
// and when 2 * max_count > size no other lane can reach it, so the maximum
// is the modal lane with its sum.  Otherwise (a cutoff of 1/2 or less) the
// general finalize breaks the tie.
template <class LaneOf>
__device__ __forceinline__ Vote finalize(const PackedTally& t, int size, int num, int den,
                                         int qual_cap, LaneOf&& lane_of) {
  uint32_t top = t.acc[0];
#pragma unroll
  for (int k = 1; k < kLanes; ++k) top = max(top, t.acc[k]);
  const int max_count = static_cast<int>(top >> kCountShift);
  if (!(size > 0 && max_count * den >= num * size)) return Vote{kN, 0};
  if (2 * max_count <= size)
    return finalize<PackedTally>(t, size, num, den, qual_cap, lane_of);
  const int modal = static_cast<int>(top & 7u);
  if (modal == kN) return Vote{kN, 0};
  return Vote{modal, min(static_cast<int>((top >> kSumShift) & 0xFFFFu), qual_cap)};
}

}  // namespace cct
