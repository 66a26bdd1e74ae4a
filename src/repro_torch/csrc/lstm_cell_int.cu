// B1: the fused integer LSTM window — every timestep of one lstm_cell node
// for a batch of windows in one launch.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell_int/kernel.py::
// _lstm_int_kernel, launched by kernel.py::lstm_window_int_pallas.
//
// At each step t, for every row (DESIGN.md §4, integer for integer):
//   z  = requant_A([x_t, h] . W + b)          shift wf, round half even
//   si, sf, so = sig_rom[z_{i,f,o} - sig_lo];  tg = tanh_rom[z_g - tanh_lo]
//   c  = requant_C(sf*c + (si*tg) << (cf-af))  shift af
//   h  = requant_A(so * tanh_rom[requant_A(c) - tanh_lo])
// and the whole (B, S, H) hidden sequence is written out (stacked cells and
// the emulator's trace read it). Every shift lies in [0, 32) (the wrapper
// checks it); both variants round with fxp_int.cuh's requant, its shifts
// formed once a thread (RShift).
//
// Two kernels, chosen by the wrapper from the cell's formats
// (kernels/lstm_cell_int/ops.py::variant):
//
// `mma` — the gate product on the int8 tensor cores. Where x, h (act_fmt)
// and W (w_fmt) codes are at most 8 bits, [x_t, h] . W is an int8 x int8
// product with an int32 sum: one mma.sync.m16n8k32.s32.s8.s8.s32 per 32
// columns of K = d_in + H (zero-padded to a multiple of 32) and per 8 of the
// N = 4H gate columns. Exactness envelope: |x|, |h|, |w| <= 128 and K <= 128,
// so every partial and final sum is bounded by 128 * 128 * 128 = 2^21 < 2^31
// and no accumulator can wrap; the int32 sum is the exact one, which is what
// the plain version's int32 loop gives (it cannot wrap either), and the bias
// is added after the product with wrap_add, as the plain version adds it.
// The routing rule (act and w codes <= 8 bits, H <= 64, K <= 128) keeps
// every spec it sends here inside that envelope; a W outside w_fmt's codes
// (an SEU model's flipped bit) the wrapper sends to `simt`, and the launcher
// raises a ValueError on one. An x code outside int8 (x not
// holding act_fmt codes, against the wrapper's contract; checking it would
// cost a pass over the input) traps, as does a W the launcher did not see,
// so it ends in a CUDA error and never in a silently different answer.
//   Layout. One warp owns a tile of 16 windows (the mma's M) and walks
//   its S steps. The block (4 warps) stages in shared memory once:
//   - W as int8 B fragments, [k32 step][n8 tile][lane] of uint2, so each
//     fragment is one conflict-free 8-byte load. W's columns are
//     interleaved by unit, [i_u, f_u, g_u, o_u, i_u+1, ...]: in an n8 tile
//     lane 4g+q holds columns 2q, 2q+1 of rows g and g+8, so lanes q = 0, 2
//     hold (i, f) and lanes q = 1, 3 hold (g, o) of units 2j and 2j+1. One
//     __shfl_xor(1) of two packed 16-bit codes then gives the even lane all
//     four gates of row g and the odd lane those of row g+8: each (row,
//     unit) is updated by exactly one lane, and its c stays in that lane's
//     registers (int32, C format) for the whole window.
//   - the bias in the same interleaved order, int32;
//   - 2^act_bits entries of each ROM (the act_fmt code range), int32.
//   Per warp: the A tile, 16 rows of [x_t | h | 0 pad] int8 with a pitch of
//   32*kt + 16 bytes (so the A fragment loads hit 32 distinct banks); each
//   lane writes its h code back there for the next step. The window's x is
//   staged as int8 per chunk of ts steps (coalesced int32 loads, one range
//   check each), and its hidden sequence as int8 codes (h is an act_fmt
//   code) in (row, step, unit) order, written out at the end of each chunk
//   with 16-byte stores that sign-extend 4 codes to 4 int32 — where ts = S
//   (Table I) a tile's output is one contiguous run of 16*S*H int32.
//   Grid: one warp per 16-window tile, ceil(B / 64) blocks, no persistence:
//   at 65,536 windows that is 1,024 blocks, and with about 16 KB of shared
//   memory and at most 64 registers a thread 8 blocks (32 warps) sit on
//   each of the 132 SMs, so all 4,096 tiles run in one wave. The ragged
//   last tile reads zeros for its missing rows and stores only real rows.
//   What bounds it: the elementwise work (four gate requants, five ROM
//   gathers, the c and h updates: 70 int32 operations per window, step and
//   unit that the cell's function needs, plus this kernel's shuffle of the
//   gates; chip_smoke.py prints what the compiler made of them), not the
//   product (10 mma per warp-step at Table I). The ROM
//   gathers are data-dependent shared-memory loads, so lanes of a warp can
//   conflict on a bank; chip_smoke.py measures that cost by timing the same
//   kernel with zero weights (every lane then reads one address): a few
//   percent on an H100, so the ROMs are staged once, not replicated.
//
// `simt` — the exact route for wider formats (any int32 codes). One thread
// per window. W is staged interleaved by unit as int4 {i, f, g, o}, so one
// broadcast 16-byte load feeds four multiply-adds; where H <= 32, h sits in
// registers (the k loop compile-time unrolled), so a multiply-add reads
// only its weight; c, and h beyond 32 units, sit in shared memory laid out
// [unit][thread]. The sequence is stored per thread. Bound: the gate
// product's int32 multiply-adds and the same elementwise work as mma's.
#include "fxp_int.cuh"

namespace {

struct CellArgs {
  long long B;
  int S, d_in, H;
  int wf, af, cf;
  int a_lo, a_hi, c_lo, c_hi;
  int sig_lo, tanh_lo, sig_depth, tanh_depth;
};

// the cell's requant shifts, formed once a thread
struct Shifts {
  repro::RShift w;                 // [x, h] . W + b -> A
  repro::RShift a;                 // C products -> C, A products -> A
  repro::RShift ca;                // c: C -> A; also aligns si*tg to sf*c
};

__device__ __forceinline__ Shifts make_shifts(const CellArgs& a) {
  return {repro::make_rshift(a.wf), repro::make_rshift(a.af),
          repro::make_rshift(a.cf - a.af)};
}

// one cell update from the four gates' codes (sigmoid/tanh ROMs indexed by
// the code itself), shared by both variants; returns h and updates c
__device__ __forceinline__ int32_t unit_update(
    int32_t zi, int32_t zf, int32_t zg, int32_t zo, int32_t& c,
    const int32_t* sig_z, const int32_t* tanh_z, const Shifts& sh,
    const CellArgs& a) {
  const int32_t si = sig_z[zi], sf = sig_z[zf], tg = tanh_z[zg],
                so = sig_z[zo];
  const int32_t term = repro::wrap_add(
      repro::wrap_mul(sf, c),
      repro::shift_left(repro::wrap_mul(si, tg), sh.ca.s));
  c = repro::requant(term, sh.a, a.c_lo, a.c_hi);
  const int32_t c_a = repro::requant(c, sh.ca, a.a_lo, a.a_hi);
  return repro::requant(repro::wrap_mul(so, tanh_z[c_a]), sh.a, a.a_lo,
                        a.a_hi);
}

// ---------------------------------------------------------------- mma ----
namespace mma {

constexpr int kWarps = 4;          // warps a block, one 16-window tile each
constexpr int kStageBytes = 4096;  // a warp's x + h staging per chunk
constexpr int kMaxKt = 4;          // K <= 128: four k32 steps

struct Geometry {
  int kt, nt;        // k32 steps over K = d_in + H; n8 tiles over 4H
  int ts;            // steps a chunk stages
  int pitch;         // bytes of an A-tile row: 32*kt + 16
  int x_bytes, o_bytes, rom_pad;
  size_t warp_bytes, smem;
};

int round16(int v) { return (v + 15) & ~15; }

Geometry geometry(const CellArgs& a) {
  Geometry g{};
  g.kt = (a.d_in + a.H + 31) / 32;
  g.nt = (4 * a.H + 7) / 8;
  g.ts = kStageBytes / (16 * (a.d_in + a.H));
  g.ts = g.ts < 1 ? 1 : (g.ts > a.S ? a.S : g.ts);
  g.pitch = 32 * g.kt + 16;
  g.x_bytes = round16(16 * g.ts * a.d_in);
  g.o_bytes = round16(16 * g.ts * a.H);
  g.rom_pad = ((a.a_hi - a.a_lo + 1) + 3) & ~3;
  g.warp_bytes = static_cast<size_t>(16) * g.pitch + g.x_bytes + g.o_bytes;
  g.smem = static_cast<size_t>(g.kt) * g.nt * 32 * sizeof(uint2) +
           static_cast<size_t>(g.nt) * 8 * sizeof(int32_t) +
           2 * static_cast<size_t>(g.rom_pad) * sizeof(int32_t) +
           kWarps * g.warp_bytes;
  return g;
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ int8_t s8_code(int32_t v) {
  if (v < -128 || v > 127) __trap();       // outside the exactness envelope
  return static_cast<int8_t>(v);
}

__device__ __forceinline__ uint32_t pack2(int32_t lo, int32_t hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) |
         (static_cast<uint32_t>(hi) << 16);
}

// NT: n8 tiles a warp-step covers (>= geo.nt), KT: k32 steps (>= geo.kt);
// both bound the unrolled loops, so c and the A fragments stay in registers
template <int NT, int KT>
__global__ void __launch_bounds__(32 * kWarps, NT <= 10 ? 8 : 4)
lstm_mma_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                const int32_t* __restrict__ b,
                const int32_t* __restrict__ sig,
                const int32_t* __restrict__ tanh_rom,
                int32_t* __restrict__ out, CellArgs a, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, d_in = a.d_in, K = d_in + H, G = 4 * H;
  const int kt = geo.kt, nt = geo.nt, ts = geo.ts, pitch = geo.pitch;
  uint2* wfrag = reinterpret_cast<uint2*>(smem);            // [kt][nt][32]
  int32_t* bias_s = reinterpret_cast<int32_t*>(wfrag + kt * nt * 32);
  int32_t* sig_s = bias_s + nt * 8;                          // [rom_pad]
  int32_t* tanh_s = sig_s + geo.rom_pad;                     // [rom_pad]
  unsigned char* warps = reinterpret_cast<unsigned char*>(tanh_s +
                                                          geo.rom_pad);

  // prologue: W to int8 B fragments, interleaved column n = 4u + gate
  for (int e = threadIdx.x; e < kt * nt * 32; e += blockDim.x) {
    const int lane = e & 31, j = (e >> 5) % nt, kk = (e >> 5) / nt;
    const int n = j * 8 + (lane >> 2), u = n >> 2, gate = n & 3;
    uint32_t r[2] = {0u, 0u};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kk * 32 + half * 16 + (lane & 3) * 4 + i;
        const int32_t v = (u < H && k < K) ? w[k * G + gate * H + u] : 0;
        r[half] |= (static_cast<uint32_t>(s8_code(v)) & 0xFFu) << (8 * i);
      }
    wfrag[e] = make_uint2(r[0], r[1]);
  }
  for (int n = threadIdx.x; n < nt * 8; n += blockDim.x)
    bias_s[n] = (n >> 2) < H ? b[(n & 3) * H + (n >> 2)] : 0;
  const int rom = a.a_hi - a.a_lo + 1;        // the act_fmt code range
  for (int i = threadIdx.x; i < rom; i += blockDim.x) {
    sig_s[i] = sig[a.a_lo - a.sig_lo + i];
    tanh_s[i] = tanh_rom[a.a_lo - a.tanh_lo + i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 16;
  if (r0 >= a.B) return;
  const int rows = a.B - r0 < 16 ? static_cast<int>(a.B - r0) : 16;
  unsigned char* a_tile = warps + warp * geo.warp_bytes;     // [16][pitch]
  int8_t* xs = reinterpret_cast<int8_t*>(a_tile + 16 * pitch);  // [16][ts][d_in]
  int8_t* os = xs + geo.x_bytes;                             // [16][ts][H]
  for (int i = lane; i < 16 * pitch / 4; i += 32)
    reinterpret_cast<uint32_t*>(a_tile)[i] = 0u;             // h0 = 0, pad

  const int g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  const int my_row = g + (odd ? 8 : 0);
  const Shifts sh = make_shifts(a);
  const int32_t* sig_z = sig_s - a.a_lo;      // indexed by the code itself
  const int32_t* tanh_z = tanh_s - a.a_lo;
  int32_t c[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j] = 0;
  const long long SH = static_cast<long long>(a.S) * H;

  for (int t0 = 0; t0 < a.S; t0 += ts) {
    const int ns = a.S - t0 < ts ? a.S - t0 : ts;
    const int xrow = ns * d_in;               // x codes of a row, this chunk
    for (int e = lane; e < 16 * xrow; e += 32) {
      const int row = e / xrow, rem = e - row * xrow;
      const int32_t v = row < rows
          ? x[(r0 + row) * a.S * d_in + static_cast<long long>(t0) * d_in +
              rem] : 0;
      xs[row * ts * d_in + rem] = s8_code(v);
    }
    __syncwarp();
    for (int s = 0; s < ns; ++s) {
      for (int e = lane; e < 16 * d_in; e += 32) {
        const int row = e / d_in, k = e - row * d_in;
        a_tile[row * pitch + k] = xs[row * ts * d_in + s * d_in + k];
      }
      __syncwarp();
      uint32_t af[KT][4];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk < kt) {
          const unsigned char* p = a_tile + g * pitch + kk * 32 + q * 4;
          af[kk][0] = *reinterpret_cast<const uint32_t*>(p);
          af[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
          af[kk][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 16);
        }
      }
      __syncwarp();                            // A read before h is written
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          int32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (int kk = 0; kk < KT; ++kk)
            if (kk < kt) mma_s8(acc, af[kk], wfrag[(kk * nt + j) * 32 + lane]);
          const int2 bb = *reinterpret_cast<const int2*>(bias_s + j * 8 + q * 2);
          int32_t z[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            z[i] = repro::requant(
                repro::wrap_add(acc[i], (i & 1) ? bb.y : bb.x), sh.w, a.a_lo,
                a.a_hi);
          // even lanes keep row g's (i, f), odd lanes row g+8's (g, o)
          const uint32_t recv = __shfl_xor_sync(
              0xffffffffu, odd ? pack2(z[0], z[1]) : pack2(z[2], z[3]), 1);
          const int32_t lo = static_cast<int16_t>(recv & 0xFFFFu),
                        hi = static_cast<int32_t>(recv) >> 16;
          const int32_t h = unit_update(
              odd ? lo : z[0], odd ? hi : z[1], odd ? z[2] : lo,
              odd ? z[3] : hi, c[j], sig_z, tanh_z, sh, a);
          const int u = 2 * j + (q >> 1);
          if (u < H) {
            a_tile[my_row * pitch + d_in + u] = static_cast<int8_t>(h);
            os[(my_row * ts + s) * H + u] = static_cast<int8_t>(h);
          }
        }
      }
      __syncwarp();
    }
    // this chunk's (rows, ns, H) codes out as int32
    int32_t* base = out + r0 * SH + static_cast<long long>(t0) * H;
    const int span = ns * H;
    if ((H & 3) == 0) {                        // 16-byte stores
      const int span4 = span >> 2;
      for (int e = lane; e < rows * span4; e += 32) {
        const int row = e / span4, c4 = e - row * span4;
        const uint32_t wd =
            *reinterpret_cast<const uint32_t*>(os + row * ts * H + c4 * 4);
        const int4 v = make_int4(static_cast<int8_t>(wd & 0xFFu),
                                 static_cast<int8_t>((wd >> 8) & 0xFFu),
                                 static_cast<int8_t>((wd >> 16) & 0xFFu),
                                 static_cast<int32_t>(wd) >> 24);
        *reinterpret_cast<int4*>(base + row * SH + c4 * 4) = v;
      }
    } else {
      for (int e = lane; e < rows * span; e += 32) {
        const int row = e / span, col = e - row * span;
        base[row * SH + col] = os[row * ts * H + col];
      }
    }
    __syncwarp();
  }
}

template <int NT, int KT>
cudaError_t launch(const CellArgs& a, const Geometry& geo, const int32_t* x,
                   const int32_t* w, const int32_t* b, const int32_t* sig,
                   const int32_t* tanh_rom, int32_t* out,
                   cudaStream_t stream) {
  if (geo.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_mma_kernel<NT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (a.B + 15) / 16;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  lstm_mma_kernel<NT, KT><<<static_cast<unsigned>(blocks), 32 * kWarps,
                            geo.smem, stream>>>(x, w, b, sig, tanh_rom, out,
                                                a, geo);
  return cudaGetLastError();
}

// the instance whose unrolled loops cover the geometry: n8 tiles 4, 8, 10
// (Table I), 16 or 32; k32 steps 1, 2 or 4
template <int NT>
cudaError_t launch_kt(const CellArgs& a, const Geometry& geo,
                      const int32_t* x, const int32_t* w, const int32_t* b,
                      const int32_t* sig, const int32_t* tanh_rom,
                      int32_t* out, cudaStream_t stream) {
  if (geo.kt <= 1)
    return launch<NT, 1>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  if (geo.kt <= 2)
    return launch<NT, 2>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  return launch<NT, kMaxKt>(a, geo, x, w, b, sig, tanh_rom, out, stream);
}

cudaError_t launch_any(const CellArgs& a, const int32_t* x, const int32_t* w,
                       const int32_t* b, const int32_t* sig,
                       const int32_t* tanh_rom, int32_t* out,
                       cudaStream_t stream) {
  const Geometry geo = geometry(a);
  if (geo.nt <= 4)
    return launch_kt<4>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  if (geo.nt <= 8)
    return launch_kt<8>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  if (geo.nt <= 10)
    return launch_kt<10>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  if (geo.nt <= 16)
    return launch_kt<16>(a, geo, x, w, b, sig, tanh_rom, out, stream);
  return launch_kt<32>(a, geo, x, w, b, sig, tanh_rom, out, stream);
}

}  // namespace mma

// --------------------------------------------------------------- simt ----
namespace simt {

constexpr int kThreads = 128;

__device__ __forceinline__ void mac4(int4& acc, int32_t v, int4 w) {
  acc.x = repro::wrap_add(acc.x, repro::wrap_mul(v, w.x));
  acc.y = repro::wrap_add(acc.y, repro::wrap_mul(v, w.y));
  acc.z = repro::wrap_add(acc.z, repro::wrap_mul(v, w.z));
  acc.w = repro::wrap_add(acc.w, repro::wrap_mul(v, w.w));
}

// W ((d_in+H) x 4H) as w4[k*H + u] = {i_u, f_u, g_u, o_u}, b as b4[u], and
// both ROMs whole
__device__ void stage(const int32_t* w, const int32_t* b, const int32_t* sig,
                      const int32_t* tanh_rom, int4* w4, int4* b4,
                      int32_t* sig_s, int32_t* tanh_s, const CellArgs& a) {
  const int H = a.H, G = 4 * H, K = a.d_in + H;
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
    const int k = i / H, u = i - k * H;
    const int32_t* r = w + k * G + u;
    w4[i] = make_int4(r[0], r[H], r[2 * H], r[3 * H]);
  }
  for (int u = threadIdx.x; u < H; u += blockDim.x)
    b4[u] = make_int4(b[u], b[H + u], b[2 * H + u], b[3 * H + u]);
  for (int i = threadIdx.x; i < a.sig_depth; i += blockDim.x)
    sig_s[i] = sig[i];
  for (int i = threadIdx.x; i < a.tanh_depth; i += blockDim.x)
    tanh_s[i] = tanh_rom[i];
}

size_t staged_bytes(const CellArgs& a) {
  const size_t K = a.d_in + a.H;
  return sizeof(int4) * (K * a.H + a.H) +
         sizeof(int32_t) * (a.sig_depth + a.tanh_depth);
}

constexpr int kRegH = 32;          // h in registers up to this width

// h in registers (H <= kRegH, the k loop unrolled), c and the next h in
// shared memory [unit][thread]: each multiply-add reads only its weight,
// and one broadcast int4 load serves the four gates of a unit
__global__ void __launch_bounds__(kThreads)
lstm_simt_reg_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ w,
                     const int32_t* __restrict__ b,
                     const int32_t* __restrict__ sig,
                     const int32_t* __restrict__ tanh_rom,
                     int32_t* __restrict__ out, CellArgs a) {
  extern __shared__ int4 smem4[];
  const int H = a.H, d_in = a.d_in, T = blockDim.x, tid = threadIdx.x;
  int4* w4 = smem4;
  int4* b4 = w4 + (d_in + H) * H;
  int32_t* sig_s = reinterpret_cast<int32_t*>(b4 + H);
  int32_t* tanh_s = sig_s + a.sig_depth;
  int32_t* h_nxt = tanh_s + a.tanh_depth;     // H * T
  int32_t* c_s = h_nxt + H * T;               // H * T
  stage(w, b, sig, tanh_rom, w4, b4, sig_s, tanh_s, a);
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * T + tid;
  if (row >= a.B) return;                     // ragged last block
  const Shifts sh = make_shifts(a);
  const int32_t* sig_z = sig_s - a.sig_lo;
  const int32_t* tanh_z = tanh_s - a.tanh_lo;
  const int32_t* xr = x + row * a.S * d_in;
  int32_t* orow = out + row * a.S * H;
  int32_t h[kRegH];
#pragma unroll
  for (int k = 0; k < kRegH; ++k) h[k] = 0;
  for (int u = 0; u < H; ++u) c_s[u * T + tid] = 0;
  for (int t = 0; t < a.S; ++t) {
    const int32_t* xt = xr + t * d_in;
    for (int u = 0; u < H; ++u) {
      int4 acc = b4[u];
      for (int k = 0; k < d_in; ++k) mac4(acc, __ldg(xt + k), w4[k * H + u]);
      const int4* wh = w4 + d_in * H + u;
#pragma unroll
      for (int k = 0; k < kRegH; ++k)
        if (k < H) mac4(acc, h[k], wh[k * H]);
      int32_t c = c_s[u * T + tid];
      const int32_t hn = unit_update(
          repro::requant(acc.x, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.y, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.z, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.w, sh.w, a.a_lo, a.a_hi), c, sig_z, tanh_z, sh,
          a);
      c_s[u * T + tid] = c;
      h_nxt[u * T + tid] = hn;
      orow[t * H + u] = hn;
    }
#pragma unroll
    for (int k = 0; k < kRegH; ++k)
      if (k < H) h[k] = h_nxt[k * T + tid];
  }
}

// any H: h (double-buffered: every gate reads the whole previous h) and c
// in shared memory, [unit][thread]
__global__ void __launch_bounds__(kThreads)
lstm_simt_smem_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ w,
                      const int32_t* __restrict__ b,
                      const int32_t* __restrict__ sig,
                      const int32_t* __restrict__ tanh_rom,
                      int32_t* __restrict__ out, CellArgs a) {
  extern __shared__ int4 smem4[];
  const int H = a.H, d_in = a.d_in, T = blockDim.x, tid = threadIdx.x;
  int4* w4 = smem4;
  int4* b4 = w4 + (d_in + H) * H;
  int32_t* sig_s = reinterpret_cast<int32_t*>(b4 + H);
  int32_t* tanh_s = sig_s + a.sig_depth;
  int32_t* h_cur = tanh_s + a.tanh_depth;     // H * T
  int32_t* h_nxt = h_cur + H * T;             // H * T
  int32_t* c_s = h_nxt + H * T;               // H * T
  stage(w, b, sig, tanh_rom, w4, b4, sig_s, tanh_s, a);
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * T + tid;
  if (row >= a.B) return;                     // ragged last block
  for (int u = 0; u < H; ++u) {
    h_cur[u * T + tid] = 0;
    c_s[u * T + tid] = 0;
  }
  const Shifts sh = make_shifts(a);
  const int32_t* sig_z = sig_s - a.sig_lo;
  const int32_t* tanh_z = tanh_s - a.tanh_lo;
  const int32_t* xr = x + row * a.S * d_in;
  int32_t* orow = out + row * a.S * H;
  for (int t = 0; t < a.S; ++t) {
    const int32_t* xt = xr + t * d_in;
    for (int u = 0; u < H; ++u) {
      int4 acc = b4[u];
      for (int k = 0; k < d_in; ++k) mac4(acc, __ldg(xt + k), w4[k * H + u]);
      for (int k = 0; k < H; ++k)
        mac4(acc, h_cur[k * T + tid], w4[(d_in + k) * H + u]);
      int32_t c = c_s[u * T + tid];
      const int32_t h = unit_update(
          repro::requant(acc.x, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.y, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.z, sh.w, a.a_lo, a.a_hi),
          repro::requant(acc.w, sh.w, a.a_lo, a.a_hi), c, sig_z, tanh_z, sh,
          a);
      c_s[u * T + tid] = c;
      h_nxt[u * T + tid] = h;
      orow[t * H + u] = h;
    }
    int32_t* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
}

template <typename Kernel>
cudaError_t launch_with(Kernel kernel, size_t smem, const CellArgs& a,
                        const int32_t* x, const int32_t* w, const int32_t* b,
                        const int32_t* sig, const int32_t* tanh_rom,
                        int32_t* out, cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(smem_max))
    return cudaErrorInvalidValue;             // cell too wide
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (a.B + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, w, b, sig, tanh_rom, out, a);
  return cudaGetLastError();
}

cudaError_t launch(const CellArgs& a, const int32_t* x, const int32_t* w,
                   const int32_t* b, const int32_t* sig,
                   const int32_t* tanh_rom, int32_t* out,
                   cudaStream_t stream) {
  const size_t state = sizeof(int32_t) * static_cast<size_t>(a.H) * kThreads;
  if (a.H <= kRegH)
    return launch_with(lstm_simt_reg_kernel, staged_bytes(a) + 2 * state, a,
                       x, w, b, sig, tanh_rom, out, stream);
  return launch_with(lstm_simt_smem_kernel, staged_bytes(a) + 3 * state, a,
                     x, w, b, sig, tanh_rom, out, stream);
}

}  // namespace simt

}  // namespace

// variant: 0 = simt, 1 = mma (kernels/lstm_cell_int/kernel.py::VARIANTS)
extern "C" int lstm_cell_int_launch(
    const void* x, const void* w, const void* b, const void* sig,
    const void* tanh_rom, void* out, long long B, int S, int d_in, int H,
    int wf, int af, int cf, int a_lo, int a_hi, int c_lo, int c_hi,
    int sig_lo, int tanh_lo, int sig_depth, int tanh_depth, int variant,
    void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const CellArgs a{B, S, d_in, H, wf, af, cf, a_lo, a_hi, c_lo, c_hi,
                   sig_lo, tanh_lo, sig_depth, tanh_depth};
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* wi = static_cast<const int32_t*>(w);
  const auto* bi = static_cast<const int32_t*>(b);
  const auto* si = static_cast<const int32_t*>(sig);
  const auto* ti = static_cast<const int32_t*>(tanh_rom);
  auto* oi = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return static_cast<int>(simt::launch(a, xi, wi, bi, si, ti, oi, st));
  // mma: the envelope the routing rule keeps (8-bit act codes, H <= 64,
  // K <= 128) and a 16-byte-aligned output
  if (variant != 1 || a_lo < -128 || a_hi > 127 || H > 64 ||
      d_in + H > 32 * mma::kMaxKt ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma::launch_any(a, xi, wi, bi, si, ti, oi, st));
}
