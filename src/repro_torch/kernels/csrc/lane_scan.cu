// Lane resolver for Hopper (sm_90a): the timing engine's per-lane scan.
//
// Replaces the Pallas kernel `_lane_kernel` of
// src/repro/kernels/lane_scan.py (built by `make_lane_resolver`; its body
// is the branchless step `_build_step` of src/repro/core/engine.py).
//
// What it computes.  A lane is one channel's command stream
// [op, a, b, col] (int32) under its own 28-field timing row.  For every
// command the lane's channel state yields 17 issue-time candidates, one
// per opcode; the command's opcode picks one (its issue cycle), and every
// state field is then written once under opcode masks.  The lane's total
// is the final `drain`.  Rows and columns never enter the timing, and the
// reference's `open_row` / `mode` fields are written but never read, so
// they are not carried here.
//
// Bit-exactness with the JAX engine:
//   * int32 adds wrap in JAX; here every add/sub goes through uint32.
//   * `x[i]` gathers (per-bank tables, the 17-entry candidate and
//     occupancy tables) wrap a negative index once by adding the table
//     length, then clamp it into range; equality tests use the raw value.
//   * NEG = -(1 << 30) is the "never happened" sentinel; the ACT_MB quad
//     is the banks with (bank % 4) == a for every bank count.
//   * Commands at positions >= lengths[f] are NOPs; their issue entries
//     are the lane's final NOP issue cycle.
//
// Design and bound.  One thread per lane; the channel state the timing
// reads (four per-bank vectors of NB entries, the four-entry tFAW ring
// and thirteen scalars) lives in registers for the whole stream: every
// per-bank access is an unrolled select over compile-time indices, never
// a dynamically indexed local array.  The kernel is templated on NB and
// instantiated for every multiple of 4 from 4 to 32.
//   bytes:  16 B read per command (+4 B written when issue arrays are
//           asked for), over 3.35 TB/s;
//   chain:  each command depends on the previous one through the state
//           (t0 -> candidate -> opcode select -> cmd_free / drain), at
//           least 8 dependent integer operations of about 4 cycles each,
//           so the longest lane costs N * 32 cycles at the SM clock.
// The chain bounds every real fleet: a 1.6 M-command baseline lane is
// tens of milliseconds of dependent latency but 26 MB of reads (8 us).
// One thread per lane does nothing to shorten the chain; it only keeps
// the state out of memory so that each step costs its arithmetic.
// Spreading a lane over a warp, or sorting lanes by length, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -(1 << 30);
constexpr int NUM_OPS = 17;

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

template <int K>
__device__ __forceinline__ int32_t vmax(const int32_t (&v)[K]) {
  int32_t out = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) out = imax(out, v[k]);
  return out;
}

template <int NB>
__global__ void __launch_bounds__(64)
lane_scan_kernel(const int32_t* __restrict__ cycs,
                 const int4* __restrict__ streams,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ issue,
                 int32_t* __restrict__ totals, int F, long long N) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;

  int32_t c[NUM_FIELDS];
#pragma unroll
  for (int j = 0; j < NUM_FIELDS; ++j) c[j] = cycs[f * NUM_FIELDS + j];
  const int32_t rdburst = add(c[cRL], c[cBURST]);
  const int32_t wrburst = add(c[cWL], c[cBURST]);
  const int32_t cmd_add[NUM_OPS] = {
      0, c[cACT], c[cPRE], c[cPRE], c[cCAS], c[cCAS], c[cACT], c[cACT],
      c[cACT], c[cACT], c[cPRE], c[cCAS], c[cCAS], c[cMACCMD], c[cCAS],
      c[cCAS], 0};
  const int32_t drain_add[NUM_OPS] = {
      0, c[cRCD], c[cRP], c[cRP], rdburst, wrburst, c[cRFC], c[cMODE],
      c[cMODE], c[cRCD], c[cRP], wrburst, wrburst, c[cMACPIPE], rdburst,
      c[cMOV], 0};

  int32_t ready_act[NB], act_cycle[NB], rd_cycle[NB], wr_end[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    ready_act[k] = 0;
    act_cycle[k] = NEG;
    rd_cycle[k] = NEG;
    wr_end[k] = NEG;
  }
  int32_t faw[4] = {NEG, NEG, NEG, NEG};
  int faw_i = 0;
  int32_t last_act = NEG, last_actmb = NEG, last_cas = NEG, last_mac = NEG;
  int32_t bus_free = 0, bus_dir = 0, cmd_free = 0, srf_ready = 0;
  int32_t mac_pipe_end = 0, mode_ready = 0, drain = 0, fence_until = 0;

  long long len = lengths[f];
  len = len < 0 ? 0 : (len > N ? N : len);
  const int4* cmds = streams + static_cast<long long>(f) * N;
  int32_t* out = issue ? issue + static_cast<long long>(f) * N : nullptr;

  for (long long i = 0; i < len; ++i) {
    const int4 cmd = cmds[i];
    const int32_t op = cmd.x;
    const int32_t a = cmd.y;
    const int opi = table_index(op, NUM_OPS);
    const int ai = table_index(a, NB);

    const bool is_nop = op == NOP, is_act = op == ACT, is_pre = op == PRE;
    const bool is_prea = op == PREA || op == PRE_MB;
    const bool is_rd = op == RD, is_wr = op == WR, is_refab = op == REFAB;
    const bool is_mode_mb = op == MODE_MB, is_mode_sb = op == MODE_SB;
    const bool is_mode = is_mode_mb || is_mode_sb;
    const bool is_actmb = op == ACT_MB, is_wrsrf = op == WR_SRF;
    const bool is_wrreg = is_wrsrf || op == WR_IRF;
    const bool is_mac = op == MAC, is_rdacc = op == RD_ACC;
    const bool is_mov = op == MOV_ACC, is_fence = op == FENCE;
    const bool is_actfam = is_act || is_actmb;
    const bool rd_bus = is_rd || is_rdacc;
    const bool wr_bus = is_wr || is_wrreg;
    const bool sets_cas = rd_bus || wr_bus || is_mov;

    // ---- shared subexpressions ----------------------------------------
    const int32_t t0 = imax(imax(cmd_free, fence_until), mode_ready);
    const int32_t act_a = pick(act_cycle, ai);
    const int32_t max_act = vmax(act_cycle);
    int32_t quad_ready = NEG, quad_act = NEG;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if ((k % 4) == a) {
        quad_ready = imax(quad_ready, ready_act[k]);
        quad_act = imax(quad_act, act_cycle[k]);
      }
    }
    const int32_t turn_r = bus_dir == 1 ? c[cWTR] : 0;
    const int32_t turn_w = bus_dir == 0 ? c[cRTW] : 0;
    const int32_t prea_t =
        imax(imax(t0, add(max_act, c[cRAS])),
             imax(imax(add(vmax(rd_cycle), c[cRTP]),
                       add(vmax(wr_end), c[cWR])),
                  add(last_mac, c[cRTP])));
    const int32_t mode_t = imax(t0, drain);
    const int32_t wrreg_t =
        imax(imax(t0, add(last_cas, c[cSRFI])),
             imax(sub(add(bus_free, turn_w), c[cWL]),
                  add(last_mac, c[cMACWR])));
    const int32_t cas_rd = imax(add(last_cas, c[cCCD]),
                                sub(add(bus_free, turn_r), c[cRL]));

    // ---- issue-time candidates, gathered by opcode --------------------
    const int32_t cand[NUM_OPS] = {
        t0,                                                       // NOP
        imax(imax(t0, pick(ready_act, ai)),                       // ACT
             imax(imax(add(act_a, c[cRC]), add(last_act, c[cRRD])),
                  add(pick(faw, faw_i), c[cFAW]))),
        imax(imax(t0, add(act_a, c[cRAS])),                       // PRE
             imax(add(pick(rd_cycle, ai), c[cRTP]),
                  add(pick(wr_end, ai), c[cWR]))),
        prea_t,                                                   // PREA
        imax(imax(t0, add(act_a, c[cRCD])),                       // RD
             imax(cas_rd, add(pick(wr_end, ai), c[cWTR]))),
        imax(imax(t0, add(act_a, c[cRCD])),                       // WR
             imax(add(last_cas, c[cCCD]),
                  sub(add(bus_free, turn_w), c[cWL]))),
        imax(t0, vmax(ready_act)),                                // REFAB
        mode_t,                                                   // MODE_MB
        mode_t,                                                   // MODE_SB
        imax(imax(t0, add(last_actmb, c[cRRDMB])),                // ACT_MB
             imax(add(last_act, c[cRRD]),
                  imax(quad_ready, add(quad_act, c[cRC])))),
        prea_t,                                                   // PRE_MB
        wrreg_t,                                                  // WR_SRF
        wrreg_t,                                                  // WR_IRF
        imax(imax(t0, add(last_mac, c[cMACI])),                   // MAC
             imax(srf_ready, add(max_act, c[cRCD]))),
        imax(imax(t0, mac_pipe_end), cas_rd),                     // RD_ACC
        imax(imax(t0, mac_pipe_end), add(last_cas, c[cCCD])),     // MOV_ACC
        add(drain, c[cFENCE]),                                    // FENCE
    };
    const int32_t t = pick(cand, opi);
    const int32_t end_w = add(t, wrburst);

    // ---- masked single-write updates ----------------------------------
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const bool hit = k == a;
      const bool in_quad = (k % 4) == a;
      if ((is_pre && hit) || is_prea) ready_act[k] = add(t, c[cRP]);
      if (is_refab) ready_act[k] = add(t, c[cRFC]);
      if ((is_act && hit) || (is_actmb && in_quad)) act_cycle[k] = t;
      if ((is_rd && hit) || is_mac) rd_cycle[k] = t;
      if (is_wr && hit) wr_end[k] = end_w;
      if (is_mov) wr_end[k] = imax(wr_end[k], add(t, c[cMOV]));
    }
    if (is_actfam) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k == faw_i) faw[k] = t;
      faw_i = (faw_i + 1) % 4;
    }
    if (is_actfam) last_act = t;
    if (is_actmb) last_actmb = t;
    if (sets_cas) last_cas = t;
    bus_free = rd_bus ? add(t, rdburst) : (wr_bus ? end_w : bus_free);
    bus_dir = rd_bus ? 0 : (wr_bus ? 1 : bus_dir);
    if (!is_nop) cmd_free = add(t, pick(cmd_add, opi));
    if (is_mac) last_mac = t;
    if (is_wrsrf) srf_ready = imax(srf_ready, end_w);
    if (is_mac) mac_pipe_end = add(t, c[cMACPIPE]);
    if (is_mode) mode_ready = add(t, c[cMODE]);
    if (!is_nop) drain = imax(drain, add(t, pick(drain_add, opi)));
    if (is_fence) fence_until = t;
    if (out) out[i] = t;
  }

  if (out) {
    const int32_t t_end = imax(imax(cmd_free, fence_until), mode_ready);
    for (long long i = len; i < N; ++i) out[i] = t_end;
  }
  totals[f] = drain;
}

template <int NB>
cudaError_t launch(const int32_t* cycs, const int32_t* streams,
                   const int32_t* lengths, int32_t* issue, int32_t* totals,
                   int F, long long N, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int blocks = (F + kThreads - 1) / kThreads;
  lane_scan_kernel<NB><<<blocks, kThreads, 0, stream>>>(
      cycs, reinterpret_cast<const int4*>(streams), lengths, issue, totals,
      F, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the lane resolver on `stream`; returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for an unsupported
// bank count.  `issue` may be null (totals only).
int lane_scan_launch(const int32_t* cycs, const int32_t* streams,
                     const int32_t* lengths, int32_t* issue,
                     int32_t* totals, int F, long long N, int num_banks,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_banks) {
    case 4: return launch<4>(cycs, streams, lengths, issue, totals, F, N, s);
    case 8: return launch<8>(cycs, streams, lengths, issue, totals, F, N, s);
    case 12: return launch<12>(cycs, streams, lengths, issue, totals, F, N, s);
    case 16: return launch<16>(cycs, streams, lengths, issue, totals, F, N, s);
    case 20: return launch<20>(cycs, streams, lengths, issue, totals, F, N, s);
    case 24: return launch<24>(cycs, streams, lengths, issue, totals, F, N, s);
    case 28: return launch<28>(cycs, streams, lengths, issue, totals, F, N, s);
    case 32: return launch<32>(cycs, streams, lengths, issue, totals, F, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
