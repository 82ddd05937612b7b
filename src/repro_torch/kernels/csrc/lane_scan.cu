// Lane resolver for Hopper (sm_90a): the timing engine's per-lane scan.
//
// Replaces the Pallas kernel `_lane_kernel` of
// src/repro/kernels/lane_scan.py (built by `make_lane_resolver`; its body
// is the branchless step `_build_step` of src/repro/core/engine.py).
//
// What it computes.  A lane is one channel's command stream
// [op, a, b, col] (int32) under its own 28-field timing row.  For every
// command the lane's channel state yields the issue-time candidate of the
// command's opcode (its issue cycle), and the opcode's state fields are
// then written.  The lane's total is the final `drain`.  Rows and columns
// never enter the timing, and the reference's `open_row` / `mode` fields
// are written but never read, so they are not carried here.
//
// Bit-exactness with the JAX engine:
//   * int32 adds wrap in JAX; here every add/sub goes through uint32.
//   * `x[i]` gathers (per-bank tables, the 17-entry candidate and
//     occupancy tables) wrap a negative index once by adding the table
//     length, then clamp it into range; equality tests use the raw value.
//     So an out-of-range bank is read at its clamped index and written
//     nowhere, and an out-of-range opcode takes the candidate and the two
//     addends of its clamped index and writes only `cmd_free` and `drain`.
//   * NEG = -(1 << 30) is the "never happened" sentinel; the ACT_MB quad
//     is the banks with (bank % 4) == a for every bank count.
//   * A NOP advances nothing, so a lane is its true commands alone.
//
// Layout.  The slab is ragged: the lanes' commands lie end to end in
// `streams` (T commands in all), lane f's at rows [start_f, start_f +
// lengths[f]), where start_f is the sum of the lengths before it; its issue
// cycles lie at the same offsets of the flat `issue` array.  Each block sums
// lengths[0..f) itself (a warp-strided sum, in long long), so a resolve stays
// one launch and the host sends no offsets.  A lane is clamped to the rows
// the slab holds, so no input reads outside it.
//
// Design.  One warp per lane and one lane per block, so the few long
// lanes of a fleet run on different SMs.
//   * Banks across the warp: thread k holds bank k's ready_act,
//     act_cycle, rd_cycle and wr_end; threads k >= NB hold INT32_MIN, which
//     loses every maximum (NEG would not: wrapped values fall below it).
//     The scalars and the four-entry tFAW ring (kept oldest first) are
//     computed uniformly in every thread.  A reduction over banks is one
//     `__reduce_max_sync`; max(act_cycle), which MAC reads, is kept
//     current after each ACT / ACT_MB instead.
//   * Bank values read a step ahead: at the top of step i every thread
//     shuffles the four values of step i + 1's bank out of the state
//     before step i, and step i then applies its own write to them, so no
//     shuffle latency sits in the chain from one issue cycle to the next.
//   * The opcode is a warp-uniform branch: each case computes only its
//     own candidate and writes only its own fields.  RD (host reads) and
//     MAC (PIM lanes), most of every real stream, are tested first, on a
//     class decoded with the command, which keeps the compiler from
//     folding them into the switch's indirect jump.
//   * Commands are fetched a chunk of 32 ahead: thread j loads command
//     `base + 32 + j` as one int4 (a coalesced 512-byte load) while chunk
//     `base` runs, decodes it (bank index, class) and writes it to a
//     64-command ring in shared memory; each step reads the command two
//     steps on from the ring with one broadcast load (three shuffles and
//     their selects, were it taken from the chunk's registers).  The step
//     loop is unrolled by two.  Issue cycles are kept one per thread and
//     stored once per chunk, coalesced.
// Bound.  Each command depends on the previous one through the state
// (t -> cmd_free / last_cas / bus_free -> t0 and the candidate -> t), a
// chain of dependent integer operations: 32 cycles at the SM clock a
// command of the longest lane is the bound chip_smoke.py states.  The
// bytes are small beside it (16 B per command, +4 B of issue cycles).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -(1 << 30);
constexpr int32_t NONE = INT32_MIN;      // no bank: loses every maximum
constexpr unsigned FULL = 0xffffffffu;
constexpr int NUM_OPS = 17;
constexpr int CHUNK = 32;
constexpr int HOT_RD = 1, HOT_MAC = 2;   // opcode classes taken first

enum Field {
  cRCD, cRP, cRAS, cRC, cRRD, cFAW, cCCD, cRTP, cWR, cWTR, cRTW, cRL, cWL,
  cBURST, cRFC, cREFI, cACT, cCAS, cPRE, cMODE, cMACI, cMACCMD, cMACPIPE,
  cMACWR, cSRFI, cRRDMB, cMOV, cFENCE, NUM_FIELDS
};

enum Op {
  NOP, ACT, PRE, PREA, RD, WR, REFAB, MODE_MB, MODE_SB, ACT_MB, PRE_MB,
  WR_SRF, WR_IRF, MAC, RD_ACC, MOV_ACC, FENCE
};

__device__ __forceinline__ int32_t add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) +
                              static_cast<uint32_t>(y));
}

__device__ __forceinline__ int32_t sub(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) -
                              static_cast<uint32_t>(y));
}

__device__ __forceinline__ int32_t imax(int32_t x, int32_t y) {
  return x > y ? x : y;
}

// JAX gather index: wrap a negative index once, then clamp into [0, n).
__device__ __forceinline__ int table_index(int32_t i, int n) {
  int64_t j = i < 0 ? static_cast<int64_t>(i) + n : static_cast<int64_t>(i);
  return static_cast<int>(j < 0 ? 0 : (j > n - 1 ? n - 1 : j));
}

template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[K], int i) {
  int32_t out = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) out = (k == i) ? v[k] : out;
  return out;
}

__device__ __forceinline__ int32_t bank_max(int32_t v) {
  return __reduce_max_sync(FULL, v);
}

template <int NB>
__global__ void __launch_bounds__(32)
lane_scan_kernel(const int32_t* __restrict__ cycs,
                 const int4* __restrict__ streams,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ issue,
                 int32_t* __restrict__ totals, long long T) {
  const int f = blockIdx.x;
  const int k = threadIdx.x;             // this thread's bank and slot
  const bool bank = k < NB;

  int32_t c[NUM_FIELDS];
#pragma unroll
  for (int j = 0; j < NUM_FIELDS; ++j) c[j] = __ldg(cycs + f * NUM_FIELDS + j);
  const int32_t rdburst = add(c[cRL], c[cBURST]);
  const int32_t wrburst = add(c[cWL], c[cBURST]);

  // This thread's bank.
  int32_t ready_act = bank ? 0 : NONE;
  int32_t act_cycle = bank ? NEG : NONE;
  int32_t rd_cycle = act_cycle, wr_end = act_cycle;
  // The lane's scalars, the same in every thread.
  int32_t faw0 = NEG, faw1 = NEG, faw2 = NEG, faw3 = NEG;
  int32_t last_act = NEG, last_actmb = NEG, last_cas = NEG, last_mac = NEG;
  int32_t bus_free = 0, bus_dir = 0, cmd_free = 0, srf_ready = 0;
  int32_t mac_pipe_end = 0, mode_ready = 0, drain = 0, fence_until = 0;
  int32_t max_act = NEG;

  // This lane's first row: the lengths before it, a warp-strided sum
  // reduced with redux in three pieces, none of whose sums can pass 32
  // bits.  A redux's result is uniform to the compiler, so the step loop
  // that `len` bounds stays uniform; a shuffle's result would make it
  // divergent (convergence barriers in the loop: 1.7x its instructions
  // and 1.5x the time a step on an H100).
  long long part = 0;
#pragma unroll 4
  for (int j = k; j < f; j += CHUNK) {
    const int32_t n = __ldg(lengths + j);
    part += n > 0 ? n : 0;
  }
  const long long start =
      static_cast<long long>(__reduce_add_sync(
          FULL, static_cast<unsigned>(part & 0xffff)))
      + (static_cast<long long>(__reduce_add_sync(
             FULL, static_cast<unsigned>((part >> 16) & 0xffff))) << 16)
      + (static_cast<long long>(__reduce_add_sync(
             FULL, static_cast<unsigned>(part >> 32))) << 32);
  const long long room = T > start ? T - start : 0;
  long long len = lengths[f];
  len = len < 0 ? 0 : (len > room ? room : len);
  const int4* cmds = streams + start;
  int32_t* out = issue ? issue + start : nullptr;
  auto fetch = [&](long long i) {
    return i < len ? __ldg(cmds + i) : make_int4(NOP, 0, 0, 0);
  };
  // A command as a step reads it: op, a, and `meta`, its bank index and
  // the class of the hot opcodes (bits 8 and up).
  const auto decode = [](int4 cmd) {
    const int hot = cmd.x == RD ? HOT_RD : cmd.x == MAC ? HOT_MAC : 0;
    return make_int4(cmd.x, cmd.y, table_index(cmd.y, NB) | hot << 8, 0);
  };

  // Slot i % 64 of the ring holds command i, decoded.  At the top of the
  // chunk at `base` thread j writes command `base + 32 + j` (loaded a
  // chunk earlier) and starts loading command `base + 64 + j`.
  __shared__ int4 ring[2 * CHUNK];
  int4 ahead = fetch(k);
  ring[k] = decode(ahead);
  ahead = fetch(CHUNK + k);
  __syncwarp();
  // This step's command, the next one's, and this step's bank's values
  // (all banks start equal).
  int32_t op = ring[0].x, a = ring[0].y;
  int hot = ring[0].z >> 8;
  int32_t op_n = ring[1].x, a_n = ring[1].y, meta_n = ring[1].z;
  int32_t at_ready = 0, at_act = NEG, at_rd = NEG, at_wr = NEG;
  int32_t my_t = 0;

  for (long long base = 0; base < len; base += CHUNK) {
    __syncwarp();
    ring[(base + CHUNK + k) & (2 * CHUNK - 1)] = decode(ahead);
    ahead = fetch(base + 2 * CHUNK + k);
    __syncwarp();
    const int steps = len - base < CHUNK ? static_cast<int>(len - base)
                                         : CHUNK;
#pragma unroll 2
    for (int j = 0; j < steps; ++j) {
      // The command two steps on; the next one's bank values before this
      // step, at the index read one step ago.
      const int4 cmd_nn = ring[(base + j + 2) & (2 * CHUNK - 1)];
      const int ai_n = meta_n & 0xff;
      int32_t n_ready = __shfl_sync(FULL, ready_act, ai_n);
      int32_t n_act = __shfl_sync(FULL, act_cycle, ai_n);
      int32_t n_rd = __shfl_sync(FULL, rd_cycle, ai_n);
      int32_t n_wr = __shfl_sync(FULL, wr_end, ai_n);

      const bool hit = bank && k == a;
      const bool hit_n = ai_n == a;
      const int32_t t0 = imax(imax(cmd_free, fence_until), mode_ready);
      const int32_t turn_r = bus_dir == 1 ? c[cWTR] : 0;
      const int32_t turn_w = bus_dir == 0 ? c[cRTW] : 0;
      const auto cas_rd = [&] {
        return imax(add(last_cas, c[cCCD]),
                    sub(add(bus_free, turn_r), c[cRL]));
      };
      const auto wr_bus_t = [&] { return sub(add(bus_free, turn_w), c[cWL]); };
      const auto quad_max = [&](int32_t v) {
        return imax(NEG, bank_max(bank && (k & 3) == a ? v : NONE));
      };
      // The issue-time candidate of opcode o (in range) on this state.
      const auto cand = [&](int o) -> int32_t {
        switch (o) {
          case NOP: return t0;
          case ACT:
            return imax(imax(t0, at_ready),
                        imax(imax(add(at_act, c[cRC]),
                                  add(last_act, c[cRRD])),
                             add(faw0, c[cFAW])));
          case PRE:
            return imax(imax(t0, add(at_act, c[cRAS])),
                        imax(add(at_rd, c[cRTP]), add(at_wr, c[cWR])));
          case PREA:
          case PRE_MB:
            return imax(imax(t0, add(max_act, c[cRAS])),
                        imax(imax(add(bank_max(rd_cycle), c[cRTP]),
                                  add(bank_max(wr_end), c[cWR])),
                             add(last_mac, c[cRTP])));
          case RD:
            return imax(imax(t0, add(at_act, c[cRCD])),
                        imax(cas_rd(), add(at_wr, c[cWTR])));
          case WR:
            return imax(imax(t0, add(at_act, c[cRCD])),
                        imax(add(last_cas, c[cCCD]), wr_bus_t()));
          case REFAB: return imax(t0, bank_max(ready_act));
          case MODE_MB:
          case MODE_SB: return imax(t0, drain);
          case ACT_MB:
            return imax(imax(t0, add(last_actmb, c[cRRDMB])),
                        imax(add(last_act, c[cRRD]),
                             imax(quad_max(ready_act),
                                  add(quad_max(act_cycle), c[cRC]))));
          case WR_SRF:
          case WR_IRF:
            return imax(imax(t0, add(last_cas, c[cSRFI])),
                        imax(wr_bus_t(), add(last_mac, c[cMACWR])));
          case MAC:
            return imax(imax(t0, add(last_mac, c[cMACI])),
                        imax(srf_ready, add(max_act, c[cRCD])));
          case RD_ACC: return imax(imax(t0, mac_pipe_end), cas_rd());
          case MOV_ACC:
            return imax(imax(t0, mac_pipe_end), add(last_cas, c[cCCD]));
          default: return add(drain, c[cFENCE]);
        }
      };
      // Every opcode but NOP: the command bus and the drain horizon.
      const auto retire = [&](int32_t t, int32_t cmd_add, int32_t drain_add) {
        cmd_free = add(t, cmd_add);
        drain = imax(drain, add(t, drain_add));
      };
      const auto push_faw = [&](int32_t t) {
        faw0 = faw1;
        faw1 = faw2;
        faw2 = faw3;
        faw3 = t;
        last_act = t;
      };

      // The hot opcodes' steps, dispatched on their class (RD: host
      // reads; MAC: PIM lanes) ahead of the switch.
      const auto step_rd = [&] {
        const int32_t t = cand(RD);
        if (hit) rd_cycle = t;
        if (hit_n) n_rd = t;
        last_cas = t;
        bus_free = add(t, rdburst);
        bus_dir = 0;
        retire(t, c[cCAS], rdburst);
        return t;
      };
      const auto step_mac = [&] {
        const int32_t t = cand(MAC);
        if (bank) rd_cycle = t;
        n_rd = t;
        last_mac = t;
        mac_pipe_end = add(t, c[cMACPIPE]);
        retire(t, c[cMACCMD], c[cMACPIPE]);
        return t;
      };

      int32_t t;
      if (hot == HOT_RD) {
        t = step_rd();
      } else if (hot == HOT_MAC) {
        t = step_mac();
      } else switch (op) {
        case NOP:
          t = t0;
          break;
        case ACT:
          t = cand(ACT);
          if (hit) act_cycle = t;
          if (hit_n) n_act = t;
          max_act = bank_max(act_cycle);
          push_faw(t);
          retire(t, c[cACT], c[cRCD]);
          break;
        case PRE:
          t = cand(PRE);
          if (hit) ready_act = add(t, c[cRP]);
          if (hit_n) n_ready = add(t, c[cRP]);
          retire(t, c[cPRE], c[cRP]);
          break;
        case PREA:
        case PRE_MB:
          t = cand(PREA);
          if (bank) ready_act = add(t, c[cRP]);
          n_ready = add(t, c[cRP]);
          retire(t, c[cPRE], c[cRP]);
          break;
        case RD:
          t = step_rd();
          break;
        case WR:
          t = cand(WR);
          if (hit) wr_end = add(t, wrburst);
          if (hit_n) n_wr = add(t, wrburst);
          last_cas = t;
          bus_free = add(t, wrburst);
          bus_dir = 1;
          retire(t, c[cCAS], wrburst);
          break;
        case REFAB:
          t = cand(REFAB);
          if (bank) ready_act = add(t, c[cRFC]);
          n_ready = add(t, c[cRFC]);
          retire(t, c[cACT], c[cRFC]);
          break;
        case MODE_MB:
        case MODE_SB:
          t = cand(MODE_MB);
          mode_ready = add(t, c[cMODE]);
          retire(t, c[cACT], c[cMODE]);
          break;
        case ACT_MB:
          t = cand(ACT_MB);
          if (bank && (k & 3) == a) act_cycle = t;
          if ((ai_n & 3) == a) n_act = t;
          max_act = bank_max(act_cycle);
          push_faw(t);
          last_actmb = t;
          retire(t, c[cACT], c[cRCD]);
          break;
        case WR_SRF:
        case WR_IRF:
          t = cand(WR_SRF);
          last_cas = t;
          bus_free = add(t, wrburst);
          bus_dir = 1;
          if (op == WR_SRF) srf_ready = imax(srf_ready, add(t, wrburst));
          retire(t, c[cCAS], wrburst);
          break;
        case MAC:
          t = step_mac();
          break;
        case RD_ACC:
          t = cand(RD_ACC);
          last_cas = t;
          bus_free = add(t, rdburst);
          bus_dir = 0;
          retire(t, c[cCAS], rdburst);
          break;
        case MOV_ACC:
          t = cand(MOV_ACC);
          if (bank) wr_end = imax(wr_end, add(t, c[cMOV]));
          n_wr = imax(n_wr, add(t, c[cMOV]));
          last_cas = t;
          retire(t, c[cCAS], c[cMOV]);
          break;
        case FENCE:
          t = cand(FENCE);
          fence_until = t;
          retire(t, 0, 0);
          break;
        default: {  // out of range: the clamped opcode's candidate and adds
          const int opi = table_index(op, NUM_OPS);
          const int32_t cmd_add[NUM_OPS] = {
              0, c[cACT], c[cPRE], c[cPRE], c[cCAS], c[cCAS], c[cACT],
              c[cACT], c[cACT], c[cACT], c[cPRE], c[cCAS], c[cCAS],
              c[cMACCMD], c[cCAS], c[cCAS], 0};
          const int32_t drain_add[NUM_OPS] = {
              0, c[cRCD], c[cRP], c[cRP], rdburst, wrburst, c[cRFC],
              c[cMODE], c[cMODE], c[cRCD], c[cRP], wrburst, wrburst,
              c[cMACPIPE], rdburst, c[cMOV], 0};
          t = cand(opi);
          retire(t, pick(cmd_add, opi), pick(drain_add, opi));
          break;
        }
      }
      my_t = k == j ? t : my_t;
      op = op_n;
      a = a_n;
      hot = meta_n >> 8;
      op_n = cmd_nn.x;
      a_n = cmd_nn.y;
      meta_n = cmd_nn.z;
      at_ready = n_ready;
      at_act = n_act;
      at_rd = n_rd;
      at_wr = n_wr;
    }
    if (out && base + k < len) out[base + k] = my_t;
  }

  if (k == 0) totals[f] = drain;
}

template <int NB>
cudaError_t launch(const int32_t* cycs, const int32_t* streams,
                   const int32_t* lengths, int32_t* issue, int32_t* totals,
                   int F, long long T, cudaStream_t stream) {
  lane_scan_kernel<NB><<<F, CHUNK, 0, stream>>>(
      cycs, reinterpret_cast<const int4*>(streams), lengths, issue, totals,
      T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the lane resolver on `stream`; returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for an unsupported
// bank count.  `streams` is the ragged slab of T commands; `issue` (T
// entries, at the commands' offsets) may be null (totals only).
int lane_scan_launch(const int32_t* cycs, const int32_t* streams,
                     const int32_t* lengths, int32_t* issue,
                     int32_t* totals, int F, long long T, int num_banks,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_banks) {
    case 4: return launch<4>(cycs, streams, lengths, issue, totals, F, T, s);
    case 8: return launch<8>(cycs, streams, lengths, issue, totals, F, T, s);
    case 12: return launch<12>(cycs, streams, lengths, issue, totals, F, T, s);
    case 16: return launch<16>(cycs, streams, lengths, issue, totals, F, T, s);
    case 20: return launch<20>(cycs, streams, lengths, issue, totals, F, T, s);
    case 24: return launch<24>(cycs, streams, lengths, issue, totals, F, T, s);
    case 28: return launch<28>(cycs, streams, lengths, issue, totals, F, T, s);
    case 32: return launch<32>(cycs, streams, lengths, issue, totals, F, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
