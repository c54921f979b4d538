// Majority votes over ragged member streams: the SSCS vote (one consensus
// per UMI family) and the fused duplex vote (both strands' SSCS and their
// DCS in one sweep).  The vote itself is vote_state.cuh, shared by both.
//
// vote_members_kernel replaces the TPU kernel
// consensuscruncher_tpu/ops/consensus_pallas.py:_vote_kernel and serves the
// main path's stream vote (in the JAX package the XLA program
// ops/consensus_segment.py:_stream_vote_fn).
//
// duplex_members_kernel replaces consensus_pallas.py:_fused_duplex_kernel
// and serves its stream twin, the XLA program
// ops/consensus_segment.py:_compiled_segment_duplex.  Per (pair p, position):
// strand A's family votes to (va, qa), strand B's to (vb, qb), and the DCS
// keeps va iff va == vb && va < N, with quality min(qa + qb, qual_cap), else
// (N, 0).  A strand of size 0 always votes N, so a pair with one strand
// missing gets a DCS of N without a separate "both present" mask.  Both the
// dense (B, F, L) form (starts = i*F, one plane per strand) and the stream
// form (one member stream passed twice, A families then B families) are
// this kernel with other starts.
//
// What bounds them on Hopper: memory.  Each member byte is read once (2 bytes
// per member-position, base + qual) and each output byte written once; the
// arithmetic is a few int32 ops per byte, under the card's INT32 rate.  The
// design follows from that:
//   - one thread per (family or pair, position): blockIdx.y is the family,
//     blockIdx.x * blockDim.x + threadIdx.x the position, so the threads of a
//     warp read one member row as consecutive bytes (coalesced).  The grid's
//     y extent stops at 65535, so a block walks families blockIdx.y,
//     blockIdx.y + gridDim.y, ...: every call is one launch, whatever the
//     family count;
//   - the TPU kernel's sequential grid axis over members becomes a loop over
//     the family's rows [starts[f], starts[f] + sizes[f]);
//   - the vote state (5 counts, 5 first-seen ranks, 5 quality sums, int32)
//     lives in registers; the duplex kernel folds strand A, finalizes it,
//     then reuses the same registers for strand B, so it holds one state, not
//     two.  Nothing but the inputs and the output planes touches device
//     memory, and there is no member-count cap.
// TMA and shared-memory staging of the member rows are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_state.cuh"

namespace {

constexpr int kMaxGridY = 65535;

__global__ void vote_members_kernel(
    const uint8_t* __restrict__ bases, const uint8_t* __restrict__ quals,
    const int64_t* __restrict__ starts, const int32_t* __restrict__ sizes,
    int nf, int length, int64_t row_stride, int num, int den,
    int qual_threshold, int qual_cap, uint8_t* __restrict__ out_b,
    uint8_t* __restrict__ out_q, int64_t out_stride) {
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= length) return;
  for (int f = blockIdx.y; f < nf; f += gridDim.y) {
    const int size = sizes[f];
    const int64_t row0 = starts[f] * row_stride + pos;
    cct::VoteState s;
    cct::fold_members(s, bases + row0, quals + row0, size, row_stride,
                      qual_threshold);
    const cct::Vote v = cct::finalize_vote(s, size, num, den, qual_cap);
    const int64_t o = static_cast<int64_t>(f) * out_stride + pos;
    out_b[o] = static_cast<uint8_t>(v.base);
    out_q[o] = static_cast<uint8_t>(v.qual);
  }
}

__global__ void duplex_members_kernel(
    const uint8_t* __restrict__ bases_a, const uint8_t* __restrict__ quals_a,
    const int64_t* __restrict__ starts_a, const int32_t* __restrict__ sizes_a,
    int64_t stride_a, const uint8_t* __restrict__ bases_b,
    const uint8_t* __restrict__ quals_b, const int64_t* __restrict__ starts_b,
    const int32_t* __restrict__ sizes_b, int64_t stride_b, int np, int length,
    int num, int den, int qual_threshold, int qual_cap,
    uint8_t* __restrict__ out, int64_t out_stride, int64_t plane_stride) {
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= length) return;
  for (int p = blockIdx.y; p < np; p += gridDim.y) {
    cct::VoteState s;
    const int size_a = sizes_a[p];
    const int64_t row_a = starts_a[p] * stride_a + pos;
    cct::fold_members(s, bases_a + row_a, quals_a + row_a, size_a, stride_a,
                      qual_threshold);
    const cct::Vote va = cct::finalize_vote(s, size_a, num, den, qual_cap);
    const int size_b = sizes_b[p];
    const int64_t row_b = starts_b[p] * stride_b + pos;
    cct::fold_members(s, bases_b + row_b, quals_b + row_b, size_b, stride_b,
                      qual_threshold);
    const cct::Vote vb = cct::finalize_vote(s, size_b, num, den, qual_cap);
    // the pinned duplex formula (ops/duplex_tpu.duplex_vote)
    const bool agree = va.base == vb.base && va.base < cct::kN;
    uint8_t* o = out + static_cast<int64_t>(p) * out_stride + pos;
    o[0] = static_cast<uint8_t>(va.base);
    o[plane_stride] = static_cast<uint8_t>(va.qual);
    o[2 * plane_stride] = static_cast<uint8_t>(vb.base);
    o[3 * plane_stride] = static_cast<uint8_t>(vb.qual);
    o[4 * plane_stride] = static_cast<uint8_t>(agree ? va.base : cct::kN);
    o[5 * plane_stride] =
        static_cast<uint8_t>(agree ? min(va.qual + vb.qual, qual_cap) : 0);
  }
}

dim3 grid_for(int nf, int length, int threads) {
  const unsigned int blocks_x = (length + threads - 1) / threads;
  return dim3(blocks_x, static_cast<unsigned int>(nf < kMaxGridY ? nf : kMaxGridY));
}

int threads_for(int length) {
  return length >= 256 ? 256 : ((length + 31) / 32) * 32;
}

}  // namespace

extern "C" {

// bases/quals: member rows, row r at byte offset r * row_stride; starts
// (int64) and sizes (int32): nf entries; out_b/out_q: family f at byte
// offset f * out_stride; positions [0, length) are voted.  One launch on
// `stream`; returns cudaGetLastError().
int cct_vote_members(const void* bases, const void* quals, const void* starts,
                     const void* sizes, int nf, int length, int64_t row_stride,
                     int num, int den, int qual_threshold, int qual_cap,
                     void* out_b, void* out_q, int64_t out_stride,
                     void* stream) {
  if (nf <= 0 || length <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = threads_for(length);
  vote_members_kernel<<<grid_for(nf, length, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      static_cast<const int64_t*>(starts), static_cast<const int32_t*>(sizes),
      nf, length, row_stride, num, den, qual_threshold, qual_cap,
      static_cast<uint8_t*>(out_b), static_cast<uint8_t*>(out_q), out_stride);
  return static_cast<int>(cudaGetLastError());
}

// Two strand sources (member rows, int64 starts, int32 sizes, row stride;
// np pairs each) -> six planes in `out`: plane k of pair p at byte offset
// k * plane_stride + p * out_stride, in the order SSCS-a bases, SSCS-a
// quals, SSCS-b bases, SSCS-b quals, DCS bases, DCS quals.  One launch on
// `stream`; returns cudaGetLastError().
int cct_duplex_members(const void* bases_a, const void* quals_a,
                       const void* starts_a, const void* sizes_a,
                       int64_t stride_a, const void* bases_b,
                       const void* quals_b, const void* starts_b,
                       const void* sizes_b, int64_t stride_b, int np,
                       int length, int num, int den, int qual_threshold,
                       int qual_cap, void* out, int64_t out_stride,
                       int64_t plane_stride, void* stream) {
  if (np <= 0 || length <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = threads_for(length);
  duplex_members_kernel<<<grid_for(np, length, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases_a), static_cast<const uint8_t*>(quals_a),
      static_cast<const int64_t*>(starts_a), static_cast<const int32_t*>(sizes_a),
      stride_a, static_cast<const uint8_t*>(bases_b),
      static_cast<const uint8_t*>(quals_b), static_cast<const int64_t*>(starts_b),
      static_cast<const int32_t*>(sizes_b), stride_b, np, length, num, den,
      qual_threshold, qual_cap, static_cast<uint8_t*>(out), out_stride,
      plane_stride);
  return static_cast<int>(cudaGetLastError());
}

const char* cct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
