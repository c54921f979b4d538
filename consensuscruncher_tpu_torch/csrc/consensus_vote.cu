// Majority votes over ragged member streams, read straight from the wire:
// the SSCS vote (one consensus per UMI family) and the fused duplex vote
// (both strands' SSCS and their DCS in one sweep).  One kernel template,
// vote_tiles_kernel<Wire, Duplex>, serves both; the vote itself is
// vote_state.cuh.
//
// vote_tiles_kernel<W, false> replaces the TPU kernel
// consensuscruncher_tpu/ops/consensus_pallas.py:_vote_kernel and serves the
// main path's stream vote (in the JAX package the XLA program
// ops/consensus_segment.py:_stream_vote_fn, wire unpack included).
// vote_tiles_kernel<W, true> replaces consensus_pallas.py:_fused_duplex_kernel
// and serves its stream twin, the XLA program
// ops/consensus_segment.py:_compiled_segment_duplex, stats included.  Per
// (pair p, position): strand A's family votes to (va, qa), strand B's to
// (vb, qb), and the DCS keeps va iff va == vb && va < N, with quality
// min(qa + qb, qual_cap), else (N, 0).  A strand of size 0 always votes N,
// so a pair with one strand missing gets a DCS of N with no presence mask.
//
// The wire (ops/packing.py's layouts) is decoded in the kernel; for member
// row r at position p:
//   raw    b = bases[r][p], q = quals[r][p];
//   pack8  b = w[p] & 7, q = book[w[p] >> 3];
//   pack6  with w = row_bytes / 3: b = (w8[p/4] >> 2(p%4)) & 3,
//          q = book[(w8[w + p/2] >> 4(p%2)) & 15];
//   pack4  n = (w8[p/2] >> 4(p%2)) & 15, b = n & 3, q = book[n >> 2].
// The codebook rides in the kernel's argument struct, and each block turns
// its entries into fold increments once (vote_state.cuh: the qual test and
// the packed count and sum), so a packed wire's member costs one table read
// per position; dead cells decode to legal values and are never voted.
//
// What bounds them on Hopper: INT32 operations, at the main path's shape and
// at the stage loop's (a few compares, selects and adds per member-position
// and some thirty per position finalized, on 64 INT32 lanes per SM); with the
// wire decoded in the kernel the bytes it must move take a third to two
// fifths of that time.  Neither is a matrix product: tensor cores have no
// part.  What the earlier one-block-per-family kernels lost was latency: each
// thread waited on its family's size, then on its member rows, one byte at a
// time.  The design:
//   - a persistent grid (a few blocks per SM, each call one launch) walks
//     tiles, each a run of consecutive families whose member rows are one
//     contiguous byte range of the wire per strand, sized so that the tile
//     gives every consumer thread about one item.  The host plans them
//     (ops/tiles.py): for the stream form, uniform tiles whose rows the
//     producer derives from the family records (tile_row), else a table;
//   - a producer warp works out its block's next 32 tile rows (one per lane)
//     and stages the tiles' family records and row ranges into a ring of
//     kStages shared-memory stages with TMA 1-D bulk copies, a "full"
//     mbarrier per stage, while 8 consumer warps fold the tiles already
//     landed and release each stage per warp on an "empty" mbarrier: the
//     chain sizes -> rows -> fold no longer waits on device memory per
//     family, and a warp done early runs ahead to the next tile.  The warps
//     take a tile's items in an order that turns by one warp per tile, so
//     the leftover items of a tile fall on a different warp each time;
//   - each thread owns one family and pos_for() consecutive positions (SSCS
//     4: one pack6 base byte and two qual bytes per member; duplex 2), its
//     vote state in registers (vote_state.cuh: a lane's count, quality sum
//     and index in one register, so folding a member into a lane is a
//     compare and an add, and a vote that passes a cutoff above 1/2 is
//     finalized from the lanes' maximum alone);
//   - a tile that cannot be staged (a family over the stage or over
//     kPackedMax members, a range that cannot be aligned to 16 bytes inside
//     its plane, rows too wide for enough families per stage) takes the
//     direct path: the same fold from device memory, 4-byte loads where
//     aligned, members unrolled so several loads are in flight.  There is
//     no member cap;
//   - the duplex form reduces its stats [real, duplexes, n_count, q_sum] per
//     warp and block and adds them with one integer atomic per block and
//     stat (order free, so deterministic) into zeros uploaded with the
//     records, and can write sscs_a | sscs_b << 3, qa, qb;
//   - the SSCS form with the QC rider (kQc; the with_qc planes of the JAX
//     package's _stream_vote_fn) also sums, over the call's families, each
//     position's votes and votes that disagree with the modal lane
//     (vote_state.cuh's qc(), failed votes included), at positions below
//     each family's true length (cells past it hold codebook-legal
//     garbage).  The length rides in the high 32 bits of the family's size
//     record, so it reaches the consumers staged with the records; the
//     size is the record's low 32 bits.  Each block sums into shared memory
//     and adds its (2, length) int32 sums into zeros uploaded with the
//     records, one integer atomic per position and stat.  The rider is a
//     template flag: the SSCS form without it and the duplex form compile
//     as before it existed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_state.cuh"

namespace {

using cct::Vote;

enum Wire { kRaw = 0, kPack8 = 1, kPack6 = 2, kPack4 = 3 };

constexpr int kThreads = 256;          // consumer threads (8 warps)
constexpr int kBlock = kThreads + 32;  // + one producer warp
constexpr int kMinBlocks = 3;          // resident blocks per SM (<= 72 registers)
constexpr int kStages = 4;
constexpr int kMetaBytes = 2048;       // a tile's family records
constexpr int kDataBytes = 12288;      // a tile's member rows, all strands and planes
constexpr int kStageBytes = kMetaBytes + kDataBytes;
constexpr int kTileCols = 8;           // f0, f1, staged, off0, bytes0, off1, bytes1, 0
// The QC rider sums a block's positions in shared memory up to this vote
// length (4 KB of the block's shared memory beside its ring); a longer
// call adds every item's sums to the output with global atomics instead.
constexpr int kQcSmemLength = 512;
// The rider's forms keep two blocks per SM (up to 112 registers): at
// three, their 72 registers spilled, and two blocks without spills voted
// faster.
constexpr int kQcMinBlocks = 2;

// Positions per thread: 4 for the SSCS vote (one pack6 base byte, two qual
// bytes per member), 2 for the duplex vote, whose two strands' tallies and
// votes would otherwise crowd the registers (and give a block too few
// tiles to overlap staging with folding at the stage loop's shape).
__host__ __device__ constexpr int pos_for(bool duplex) { return duplex ? 2 : 4; }

struct Params {
  const uint8_t* plane[2][2];  // [strand][bases or wire, quals (raw only)]
  int64_t row_bytes[2];        // row stride of each strand's planes
  int64_t width[2];            // bytes of content per row
  const int64_t* fam;          // per family: (start, size) per strand
  const int64_t* tiles;        // kTileCols per tile, or null: uniform tiles (tile_row)
  int64_t fams, nf;            // uniform tiles: families per tile, families
  int64_t extent[2];           // uniform tiles: bytes from a plane to its last row's end
  int n_tiles, length, groups;
  uint64_t group_magic;        // ceil(2^32 / groups): i / groups for i * groups < 2^32
  int num, den, qual_threshold, qual_cap;
  uint8_t* out;                // plane k of family f at k * plane_stride + f * length
  int64_t plane_stride;
  int32_t* stats;              // duplex: [real, duplexes, n_count, q_sum], zeroed
  int packed_out;
  int vec;                     // bit s: strand s allows 4-byte loads
  uint32_t book[16];           // codebook (pack4: the first 4)
  int32_t* qc_out;             // the QC rider's (2, length) sums, zeroed (last, so
                               // the fields above keep their offsets)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete.  A copy that
// never lands (a planning fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0; !mbar_try_wait(addr, parity);)
    if (++polls == (1u << 26)) __trap();
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// kBytes bytes at r + i, little-endian (one load when vec: i is then a
// multiple of kBytes); bytes at or past `width` read as 0.
template <int kBytes>
__device__ __forceinline__ uint32_t load_le(const uint8_t* __restrict__ r, int64_t i,
                                            int64_t width, bool vec) {
  if (kBytes == 1) return r[i];
  if (vec) {
    return kBytes == 4 ? *reinterpret_cast<const uint32_t*>(r + i)
                       : *reinterpret_cast<const uint16_t*>(r + i);
  }
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < kBytes; ++j)
    if (i + j < width) x |= static_cast<uint32_t>(r[i + j]) << (8 * j);
  return x;
}

// Positions kPos*g .. kPos*g + kPos - 1 of one member row: base codes and
// increments (vote_state.cuh: 0 for a qual that fails the threshold).  r0:
// the row (raw: its bases), r1: raw: its quals; inc: a packed wire's
// increment per codebook entry.
template <int W, int kPos>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ r0,
                                           const uint8_t* __restrict__ r1, int g,
                                           int64_t width, bool vec, const uint32_t* inc,
                                           int qual_threshold, int (&b)[kPos],
                                           uint32_t (&e)[kPos]) {
  constexpr int kNibBytes = kPos >= 2 ? kPos / 2 : 1;  // kPos 4-bit fields
  const int p0 = kPos * g;
  if (W == kRaw || W == kPack8) {
    const uint32_t x = load_le<kPos>(r0, p0, width, vec);
    const uint32_t y = W == kRaw ? load_le<kPos>(r1, p0, width, vec) : 0u;
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const uint32_t w = (x >> (8 * j)) & 0xFFu;
      if (W == kRaw) {
        b[j] = static_cast<int>(w);
        e[j] = cct::increment(static_cast<int>((y >> (8 * j)) & 0xFFu), qual_threshold);
      } else {
        b[j] = static_cast<int>(w & 7u);
        e[j] = inc[w >> 3];
      }
    }
  } else if (W == kPack6) {
    const int64_t wq = width / 3;  // the qual-index block starts here
    const uint32_t bb = static_cast<uint32_t>(r0[p0 / 4]) >> (2 * (p0 % 4));
    const uint32_t qq = load_le<kNibBytes>(r0, wq + p0 / 2, width, vec) >> (4 * (p0 % 2));
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      b[j] = static_cast<int>((bb >> (2 * j)) & 3u);
      e[j] = inc[(qq >> (4 * j)) & 15u];
    }
  } else {  // kPack4
    const uint32_t nn = load_le<kNibBytes>(r0, p0 / 2, width, vec) >> (4 * (p0 % 2));
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const uint32_t n = (nn >> (4 * j)) & 15u;
      b[j] = static_cast<int>(n & 3u);
      e[j] = inc[n >> 2];
    }
  }
}

// Vote positions kPos*g.. of one family of `size` members, its first row at r0
// (raw quals at r1), rows row_bytes apart.  rider (the QC rider's
// instantiations only) takes each position's QC part, (j, QcPart), as soon
// as the tally holds it, so no part stays live across the finalizes.
template <int W, int kPos, class Tally, class... Rider>
__device__ __forceinline__ void vote_rows(const uint8_t* r0, const uint8_t* r1,
                                          int64_t row_bytes, int64_t width, bool vec,
                                          int size, int g, const Params& p,
                                          const uint32_t* inc, Vote (&v)[kPos],
                                          Rider&... rider) {
  Tally t[kPos];
#pragma unroll
  for (int j = 0; j < kPos; ++j) t[j].init();
#pragma unroll 4
  for (int m = 0; m < size; ++m) {
    int b[kPos];
    uint32_t e[kPos];
    load_group<W, kPos>(r0 + m * row_bytes, r1 + m * row_bytes, g, width, vec, inc,
                        p.qual_threshold, b, e);
#pragma unroll
    for (int j = 0; j < kPos; ++j) t[j].fold(b[j], e[j]);
  }
#pragma unroll
  for (int j = 0; j < kPos; ++j) {
    (rider(j, t[j].qc()), ...);
    v[j] = cct::finalize(t[j], size, p.num, p.den, p.qual_cap, [&](int m) {
      int b[kPos];
      uint32_t e[kPos];
      load_group<W, kPos>(r0 + m * row_bytes, r1 + m * row_bytes, g, width, vec, inc,
                          p.qual_threshold, b, e);
      return cct::effective_lane(b[j], e[j]);
    });
  }
}

// A family of more than kPackedMax members (the direct path only): one
// position at a time, so the wide tally costs no more registers than the
// packed one.  rider as in vote_rows; without it the function is what it
// was before the QC rider.
template <int W, int kPos, class... Rider>
__device__ __noinline__ void vote_rows_wide(const uint8_t* r0, const uint8_t* r1,
                                            int64_t row_bytes, int64_t width, bool vec,
                                            int size, int g, const Params& p,
                                            const uint32_t* inc, Vote (&v)[kPos],
                                            Rider&... rider) {
#pragma unroll 1
  for (int j = 0; j < kPos; ++j) {
    cct::WideTally t;
    t.init();
    for (int m = 0; m < size; ++m) {
      int b[kPos];
      uint32_t e[kPos];
      load_group<W, kPos>(r0 + m * row_bytes, r1 + m * row_bytes, g, width, vec, inc,
                          p.qual_threshold, b, e);
#pragma unroll
      for (int k = 0; k < kPos; ++k)
        if (k == j) t.fold(b[k], e[k]);
    }
    (rider(j, t.qc()), ...);
    v[j] = cct::finalize(t, size, p.num, p.den, p.qual_cap, [&](int m) {
      int b[kPos];
      uint32_t e[kPos];
      load_group<W, kPos>(r0 + m * row_bytes, r1 + m * row_bytes, g, width, vec, inc,
                          p.qual_threshold, b, e);
      int lane = 0;
#pragma unroll
      for (int k = 0; k < kPos; ++k)
        if (k == j) lane = cct::effective_lane(b[k], e[k]);
      return lane;
    });
  }
}

template <int W, int kPos, class... Rider>
__device__ __forceinline__ void vote_family(const uint8_t* r0, const uint8_t* r1,
                                            int64_t row_bytes, int64_t width, bool vec,
                                            int size, int g, const Params& p,
                                            const uint32_t* inc, Vote (&v)[kPos],
                                            Rider&... rider) {
  if (size <= cct::kPackedMax)
    vote_rows<W, kPos, cct::PackedTally>(r0, r1, row_bytes, width, vec, size, g, p, inc, v,
                                         rider...);
  else
    vote_rows_wide<W, kPos>(r0, r1, row_bytes, width, vec, size, g, p, inc, v, rider...);
}

// Where strand s's rows of the tile in one stage are read from: the staged
// copy in shared memory (both planes' base; `rel` turns a row's offset in
// the plane into its offset in the copy), else device memory.
struct Source {
  const uint8_t* r0;
  const uint8_t* r1;
  int64_t rel;
};

template <int W>
__device__ __forceinline__ Source strand_source(const Params& p, const int64_t* info,
                                                const uint8_t* data, int s) {
  constexpr int kPlanes = W == kRaw ? 2 : 1;
  if (info[2]) {
    const uint8_t* d = data + (s == 0 ? 0 : kPlanes * info[4]);
    return Source{d, d + info[4 + 2 * s], -info[3 + 2 * s]};
  }
  return Source{p.plane[s][0], p.plane[s][1], 0};
}

// Vote strand s of local family lf of a tile (records `meta`, rows at `src`);
// rider as in vote_rows.
template <int W, int kRec, int kPos, class... Rider>
__device__ __forceinline__ int vote_strand(const Params& p, const Source& src,
                                           const int64_t* meta, int lf, int s, int g,
                                           const uint32_t* inc, Vote (&v)[kPos],
                                           Rider&... rider) {
  const int64_t start = meta[lf * kRec + 2 * s];
  const int size = static_cast<int>(meta[lf * kRec + 2 * s + 1]);
  const int64_t rb = p.row_bytes[s];
  const int64_t at = start * rb + src.rel;
  vote_family<W, kPos>(src.r0 + at, src.r1 + at, rb, p.width[s], (p.vec >> s) & 1, size, g, p,
                       inc, v, rider...);
  return size;
}

template <int kPos>
__device__ __forceinline__ uint32_t pack_bytes(const int (&x)[kPos]) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < kPos; ++j) w |= (static_cast<uint32_t>(x[j]) & 0xFFu) << (8 * j);
  return w;
}

// kPos output bytes of one family row at o (positions kPos*g.. of
// `length`): one store when the row length allows it.
template <int kPos>
__device__ __forceinline__ void store_group(uint8_t* o, int g, int length,
                                            const int (&x)[kPos]) {
  if (kPos > 1 && length % kPos == 0) {
    if (kPos == 4)
      *reinterpret_cast<uint32_t*>(o) = pack_bytes(x);
    else
      *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(pack_bytes(x));
  } else {
#pragma unroll
    for (int j = 0; j < kPos; ++j)
      if (kPos * g + j < length) o[j] = static_cast<uint8_t>(x[j]);
  }
}

// Row t of a uniform tile table (no table uploaded: the stream form, whose
// families are contiguous and each fit a stage): families [t*fams, ..) and,
// per strand, the byte range from the first family's first row to the last
// family's end, rounded outward to 16 bytes; staged iff every range stays
// inside its plane and all fit a stage.  ops/tiles.py's _table computes the
// same rows on the host.  kQc: the size records carry the QC rider's
// lengths in their high 32 bits.
template <int W, int kRec, bool kQc>
__device__ void tile_row(const Params& p, int64_t t, int64_t (&row)[kTileCols]) {
  constexpr int kPlanes = W == kRaw ? 2 : 1;
  const int64_t f0 = t * p.fams;
  const int64_t f1 = min(f0 + p.fams, p.nf);
  row[0] = f0;
  row[1] = f1;
  row[7] = 0;
  int64_t total = 0;
  bool ok = true;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    row[3 + 2 * s] = row[4 + 2 * s] = 0;
    if (2 * s >= kRec) continue;
    const int64_t lo = p.fam[f0 * kRec + 2 * s];
    const int64_t hi = p.fam[(f1 - 1) * kRec + 2 * s] +
                       (kQc ? p.fam[(f1 - 1) * kRec + 2 * s + 1] & 0xFFFFFFFF
                            : p.fam[(f1 - 1) * kRec + 2 * s + 1]);
    if (hi <= lo) continue;  // no member row in the tile
    const int64_t off = (lo * p.row_bytes[s]) & ~int64_t{15};
    const int64_t end = ((hi - 1) * p.row_bytes[s] + p.width[s] + 15) & ~int64_t{15};
    ok = ok && end <= p.extent[s];
    total += kPlanes * (end - off);
    row[3 + 2 * s] = off;
    row[4 + 2 * s] = end - off;
  }
  row[2] = ok && total <= kDataBytes;
  if (!row[2]) row[3] = row[4] = row[5] = row[6] = 0;
}

// The producer (lane 0 of its warp): stage the tile whose row is `row` into
// stage s (records always; member rows if staged).
template <int W, int kRec>
__device__ void issue_tile(const Params& p, const int64_t (&row)[kTileCols], int s,
                           uint8_t* smem, uint64_t* full, int64_t (*info)[kTileCols]) {
  constexpr int kPlanes = W == kRaw ? 2 : 1;
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) info[s][c] = row[c];
  const int64_t f0 = row[0], f1 = row[1];
  const bool staged = row[2] != 0;
  const uint32_t meta_bytes = static_cast<uint32_t>((f1 - f0) * kRec * 8);
  const uint32_t data_bytes =
      staged ? static_cast<uint32_t>(kPlanes * (row[4] + row[6])) : 0u;
  uint8_t* stage = smem + s * kStageBytes;
  mbar_expect_tx(&full[s], meta_bytes + data_bytes);
  bulk_copy(stage, p.fam + f0 * kRec, meta_bytes, &full[s]);
  if (staged) {
    uint8_t* d = stage + kMetaBytes;
    for (int r = 0; r < 2; ++r) {
      const int64_t off = row[3 + 2 * r];
      const uint32_t bytes = static_cast<uint32_t>(row[4 + 2 * r]);
      if (bytes == 0) continue;
      for (int pl = 0; pl < kPlanes; ++pl) {
        bulk_copy(d, p.plane[r][pl] + off, bytes, &full[s]);
        d += bytes;
      }
    }
  }
}

// Warp-specialised: the last warp is the producer.  Its lanes read (or, for
// uniform tiles, derive) the block's next 32 tile rows at once; lane 0 then stages tile after tile into
// a ring of kStages, waiting for a stage's "empty" barrier before reusing
// it.  The other warps consume each tile as soon as its "full" barrier
// completes and release it per warp.  kQc (SSCS only): the QC rider.
template <int W, bool kDuplex, bool kQc>
__global__ void __launch_bounds__(kBlock, kQc ? kQcMinBlocks : kMinBlocks)
    vote_tiles_kernel(const __grid_constant__ Params p) {
  static_assert(!(kDuplex && kQc), "the QC rider rides the SSCS vote only");
  constexpr int kRec = kDuplex ? 4 : 2;
  constexpr int kPos = pos_for(kDuplex);
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int64_t info[kStages][kTileCols];
  __shared__ uint32_t inc[16];  // the increment of each codebook entry
  __shared__ int block_stats[4];
  // the QC rider's block sums: votes at [0, length), disagree at [length, 2 length)
  __shared__ int qc_sums[kQc ? 2 * kQcSmemLength : 1];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid < 16) inc[tid] = cct::increment(static_cast<int>(p.book[tid]), p.qual_threshold);
  if (tid < 4) block_stats[tid] = 0;
  const bool qc_in_smem = kQc && p.length <= kQcSmemLength;
  if constexpr (kQc) {
    if (qc_in_smem)
      for (int i = tid; i < 2 * p.length; i += kBlock) qc_sums[i] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {  // the producer warp
    for (int base = 0;; base += 32) {
      const int64_t mine = blockIdx.x + static_cast<int64_t>(base + lane) * gridDim.x;
      int64_t rows[kTileCols] = {};
      if (mine < p.n_tiles) {
        if (p.tiles) {
#pragma unroll
          for (int c = 0; c < kTileCols; ++c) rows[c] = p.tiles[mine * kTileCols + c];
        } else {
          tile_row<W, kRec, kQc>(p, mine, rows);
        }
      }
      for (int j = 0; j < 32; ++j) {
        const int it = base + j;
        if (blockIdx.x + static_cast<int64_t>(it) * gridDim.x >= p.n_tiles) return;
        int64_t row[kTileCols];
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) row[c] = __shfl_sync(0xFFFFFFFFu, rows[c], j);
        const int s = it % kStages;
        if (lane == 0) {
          if (it >= kStages) {
            mbar_wait(&empty[s], static_cast<uint32_t>((it / kStages - 1) & 1));
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          }
          issue_tile<W, kRec>(p, row, s, smem, full, info);
        }
        __syncwarp();
      }
    }
  }
  int st_real = 0, st_dup = 0, st_n = 0, st_q = 0;
  for (int it = 0, t = blockIdx.x; t < p.n_tiles; ++it, t += gridDim.x) {
    const int s = it % kStages;
    mbar_wait(&full[s], static_cast<uint32_t>((it / kStages) & 1));
    int64_t ti[kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) ti[c] = info[s][c];
    const int64_t* meta = reinterpret_cast<const int64_t*>(smem + s * kStageBytes);
    const uint8_t* data = smem + s * kStageBytes + kMetaBytes;
    const Source src_a = strand_source<W>(p, ti, data, 0);
    const Source src_b = strand_source<W>(p, ti, data, 1);
    const int64_t f0 = ti[0];
    const int items = static_cast<int>(ti[1] - f0) * p.groups;
    // this tile's item order: warp w takes the share of warp (w + it) % kWarps
    const int first = ((warp + it) % kWarps) * 32 + lane;
    for (int i = first; i < items; i += kThreads) {
      const int lf = static_cast<int>((static_cast<uint64_t>(i) * p.group_magic) >> 32);
      const int g = i - lf * p.groups;
      const int64_t o = (f0 + lf) * p.length + kPos * g;
      Vote va[kPos];
      int na;
      if constexpr (kQc) {
        // the QC rider: positions past the family's true length (the high
        // word of its staged size record) are wire padding; a position's
        // votes and disagreement are added as soon as its tally is folded
        const int len = static_cast<int>(meta[lf * kRec + 1] >> 32);
        const int live = min(len, p.length) - kPos * g;
        auto rider = [&](int j, const cct::QcPart& q) {
          if (j >= live) return;
          const int pos = kPos * g + j, disagree = q.votes - q.top;
          if (qc_in_smem) {  // shared-memory atomics; a generic pointer would lose them
            if (q.votes) atomicAdd(&qc_sums[pos], q.votes);
            if (disagree) atomicAdd(&qc_sums[p.length + pos], disagree);
          } else {
            if (q.votes) atomicAdd(p.qc_out + pos, q.votes);
            if (disagree) atomicAdd(p.qc_out + p.length + pos, disagree);
          }
        };
        na = vote_strand<W, kRec, kPos>(p, src_a, meta, lf, 0, g, inc, va, rider);
      } else {
        na = vote_strand<W, kRec, kPos>(p, src_a, meta, lf, 0, g, inc, va);
      }
      if (!kDuplex) {
        int x[kPos], y[kPos];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          x[j] = va[j].base;
          y[j] = va[j].qual;
        }
        store_group(p.out + o, g, p.length, x);
        store_group(p.out + p.plane_stride + o, g, p.length, y);
      } else {
        Vote vb[kPos];
        const int nb = vote_strand<W, kRec, kPos>(p, src_b, meta, lf, 1, g, inc, vb);
        const bool both = na > 0 && nb > 0;
        int sa[kPos], qa[kPos], sb[kPos], qb[kPos], dcs[kPos], dq[kPos];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          sa[j] = va[j].base;
          qa[j] = va[j].qual;
          sb[j] = vb[j].base;
          qb[j] = vb[j].qual;
          // the pinned duplex formula (ops/duplex_tpu.duplex_vote)
          const bool agree = sa[j] == sb[j] && sa[j] < cct::kN;
          dcs[j] = agree ? sa[j] : cct::kN;
          dq[j] = agree ? min(qa[j] + qb[j], p.qual_cap) : 0;
          if (both && kPos * g + j < p.length) {
            st_n += dcs[j] == cct::kN;
            st_q += dq[j];
          }
        }
        if (g == 0) {
          st_real += na > 0 || nb > 0;
          st_dup += both;
        }
        uint8_t* out = p.out + o;
        if (p.packed_out) {
          int pk[kPos];
#pragma unroll
          for (int j = 0; j < kPos; ++j) pk[j] = sa[j] | sb[j] << 3;
          store_group(out, g, p.length, pk);
          store_group(out + p.plane_stride, g, p.length, qa);
          store_group(out + 2 * p.plane_stride, g, p.length, qb);
        } else {
          store_group(out, g, p.length, sa);
          store_group(out + p.plane_stride, g, p.length, qa);
          store_group(out + 2 * p.plane_stride, g, p.length, sb);
          store_group(out + 3 * p.plane_stride, g, p.length, qb);
          store_group(out + 4 * p.plane_stride, g, p.length, dcs);
          store_group(out + 5 * p.plane_stride, g, p.length, dq);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
  if (kDuplex) {
    const unsigned v[4] = {static_cast<unsigned>(st_real), static_cast<unsigned>(st_dup),
                           static_cast<unsigned>(st_n), static_cast<unsigned>(st_q)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned w = __reduce_add_sync(0xFFFFFFFFu, v[k]);
      if (lane == 0) atomicAdd(&block_stats[k], static_cast<int>(w));
    }
    // the consumer warps only: the producer warp has left
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    if (tid < 4) atomicAdd(p.stats + tid, block_stats[tid]);
  }
  if constexpr (kQc) {
    if (qc_in_smem) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      for (int i = tid; i < 2 * p.length; i += kThreads)
        if (qc_sums[i]) atomicAdd(p.qc_out + i, qc_sums[i]);
    }
  }
}

// Cards a process may address: the grid and the kernel's shared-memory
// attribute are per card (a function attribute set on one card's context
// does not reach another's).
constexpr int kMaxCards = 64;

template <int W, bool kDuplex, bool kQc>
struct Launcher {
  // the persistent grid of the current card, which the caller made the
  // planes' card
  static int grid_blocks() {
    static int cached[kMaxCards] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= kMaxCards) return 0;
    if (cached[dev] == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaFuncSetAttribute(vote_tiles_kernel<W, kDuplex, kQc>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStages * kStageBytes);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, vote_tiles_kernel<W, kDuplex, kQc>, kBlock, kStages * kStageBytes);
      cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    return cached[dev];
  }
  static int launch(const Params& p, cudaStream_t stream) {
    const int blocks = grid_blocks();
    if (blocks == 0) return static_cast<int>(cudaErrorInvalidDevice);
    const int grid = p.n_tiles < blocks ? p.n_tiles : blocks;
    vote_tiles_kernel<W, kDuplex, kQc><<<grid, kBlock, kStages * kStageBytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
};

template <bool kDuplex, bool kQc>
int dispatch(int wire, const Params* p, cudaStream_t stream, bool grid_only) {
  switch (wire) {
    case kRaw:
      return grid_only ? Launcher<kRaw, kDuplex, kQc>::grid_blocks()
                       : Launcher<kRaw, kDuplex, kQc>::launch(*p, stream);
    case kPack8:
      return grid_only ? Launcher<kPack8, kDuplex, kQc>::grid_blocks()
                       : Launcher<kPack8, kDuplex, kQc>::launch(*p, stream);
    case kPack6:
      return grid_only ? Launcher<kPack6, kDuplex, kQc>::grid_blocks()
                       : Launcher<kPack6, kDuplex, kQc>::launch(*p, stream);
    case kPack4:
      return grid_only ? Launcher<kPack4, kDuplex, kQc>::grid_blocks()
                       : Launcher<kPack4, kDuplex, kQc>::launch(*p, stream);
    default:
      return grid_only ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instantiation of a call: SSCS (with or without the QC rider) or duplex.
int dispatch_form(int wire, int duplex, int qc, const Params* p, cudaStream_t stream,
                  bool grid_only) {
  if (duplex) return dispatch<true, false>(wire, p, stream, grid_only);
  return qc ? dispatch<false, true>(wire, p, stream, grid_only)
            : dispatch<false, false>(wire, p, stream, grid_only);
}

}  // namespace

extern "C" {

// The layout the host planner (ops/tiles.py) plans for, for the SSCS
// (duplex 0) or the duplex vote: consumer threads, positions per thread,
// record bytes of a stage, row bytes of a stage, the packed-tally member
// limit, tile table columns, stages in a block's ring (dynamic shared
// memory: stages x (record bytes + row bytes)).
void cct_tile_constants(int duplex, int64_t* out) {
  out[0] = kThreads;
  out[1] = pos_for(duplex != 0);
  out[2] = kMetaBytes;
  out[3] = kDataBytes;
  out[4] = cct::kPackedMax;
  out[5] = kTileCols;
  out[6] = kStages;
}

// Blocks of the persistent grid (SMs x resident blocks per SM) of one
// instantiation (qc: the SSCS vote with the QC rider) on the current card.
int cct_tile_grid(int wire, int duplex, int qc) {
  return dispatch_form(wire, duplex, qc, nullptr, nullptr, true);
}

// One launch of the vote over a planned tile table on `stream`, a stream of
// the current card, which holds the planes.
// planes: [strand0 bases|wire, strand0 quals, strand1 bases|wire, strand1
// quals]; row_bytes, width, extent: per strand (extent: bytes from a plane
// to its last row's end); fam: per family (start, size) per strand, int64;
// tiles: n_tiles x kTileCols int64, no tile holding more than 2^16 / groups
// families, or null for n_tiles uniform tiles of `fams` of the `nf`
// families (tile_row); book: 16 codebook bytes (pack4: the first 4); out:
// plane k of family f at k * plane_stride + f * length; stats (duplex): 4
// int32 the caller zeroed; qc_out (SSCS with the QC rider, else null): (2,
// length) int32 the caller zeroed, each family's true length then in the
// high 32 bits of its size record.  Returns cudaGetLastError().
int cct_vote_tiles(int wire, int duplex, const void* const* planes,
                   const int64_t* row_bytes, const int64_t* width, const int64_t* extent,
                   const void* fam, const void* tiles, int64_t fams, int64_t nf,
                   int n_tiles, int length, int num, int den,
                   int qual_threshold, int qual_cap, const uint8_t* book, void* out,
                   int64_t plane_stride, void* stats, int packed_out, int vec,
                   void* qc_out, void* stream) {
  if (n_tiles <= 0 || length <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  for (int s = 0; s < 2; ++s) {
    p.plane[s][0] = static_cast<const uint8_t*>(planes[2 * s]);
    p.plane[s][1] = static_cast<const uint8_t*>(planes[2 * s + 1]);
    p.row_bytes[s] = row_bytes[s];
    p.width[s] = width[s];
    p.extent[s] = extent[s];
  }
  p.fam = static_cast<const int64_t*>(fam);
  p.tiles = static_cast<const int64_t*>(tiles);
  p.fams = fams;
  p.nf = nf;
  p.n_tiles = n_tiles;
  p.length = length;
  const int pos = pos_for(duplex != 0);
  p.groups = (length + pos - 1) / pos;
  p.group_magic = ((1ull << 32) + p.groups - 1) / p.groups;
  p.num = num;
  p.den = den;
  p.qual_threshold = qual_threshold;
  p.qual_cap = qual_cap;
  p.out = static_cast<uint8_t*>(out);
  p.plane_stride = plane_stride;
  p.stats = static_cast<int32_t*>(stats);
  p.packed_out = packed_out;
  p.vec = vec;
  p.qc_out = static_cast<int32_t*>(qc_out);
  for (int k = 0; k < 16; ++k) p.book[k] = book[k];
  const int qc = !duplex && qc_out != nullptr;
  return dispatch_form(wire, duplex, qc, &p, static_cast<cudaStream_t>(stream), false);
}

const char* cct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
