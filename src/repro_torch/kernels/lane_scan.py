"""Lane resolver: the timing engine's hot loop, as a CUDA kernel.

Each lane is one channel's command stream under its own timing row; the
resolver runs the branchless 17-opcode int32 state machine of
``core/engine.py`` over every command and returns each command's issue
cycle and the lane's total (the final ``drain``).

Two implementations of one function live here:

* :func:`lane_scan_plain` — the step written with torch ops, batched over
  the fleet axis, with a Python loop over commands.  It is the oracle the
  kernel is held to, and the path a CPU tensor takes.
* the CUDA kernel in ``csrc/lane_scan.cu`` (one warp per lane, the banks
  across its threads), built by ``kernels/build.py`` on first use.

:func:`lane_scan` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other.

Contract shared by both (and by the reference engine, bit for bit):

* ``cycs`` int32 ``(F, len(CYC_FIELDS))``; ``lengths`` int32 ``(F,)``;
  ``streams`` int32 ``(T, 4)`` = ``[op, a, b, col]``, a ragged slab:
  the lanes' commands end to end, ``T = sum(lengths)``, lane ``f``'s at
  rows ``[start_f, start_f + lengths[f])`` with ``start_f`` the sum of
  the lengths before it.  The issue cycles, when asked for, are flat
  ``(T,)`` at the same offsets.  (A NOP advances nothing, so padding a
  lane would change no result; the slab carries none.)
* int32 arithmetic wraps.
* Out-of-range ``op`` / ``a`` index the per-opcode and per-bank tables
  the way a JAX gather does: a negative index is wrapped once by adding
  the table length, then clamped into range.  Equality tests on them
  (opcode predicates, one-hot bank masks) use the raw value.
"""
from __future__ import annotations

import torch

from repro_torch.core import commands as C

NEG = -(1 << 30)

# Column order of a packed timing row: the TimingCycles fields other
# than ``tck_ns`` (unused by the step) and ``num_banks`` (it picks the
# kernel instantiation).  The CUDA source indexes rows in this order.
CYC_FIELDS = ("cRCD", "cRP", "cRAS", "cRC", "cRRD", "cFAW", "cCCD",
              "cRTP", "cWR", "cWTR", "cRTW", "cRL", "cWL", "cBURST",
              "cRFC", "cREFI", "cACT", "cCAS", "cPRE", "cMODE", "cMACI",
              "cMACCMD", "cMACPIPE", "cMACWR", "cSRFI", "cRRDMB", "cMOV",
              "cFENCE")
_F = {name: j for j, name in enumerate(CYC_FIELDS)}

# Bank counts the kernel is instantiated for (csrc/lane_scan.cu).
SUPPORTED_BANKS = tuple(range(4, 33, 4))

# Kernel launches so far (the plain version never counts).
LAUNCHES = 0


def _table_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX gather indexing: wrap a negative index once, then clamp."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1)


def _gather(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vec[f, idx[f]]`` for a (F, K) table and (F,) indices."""
    return vec.gather(1, idx[:, None])[:, 0]


def lane_scan_plain(cycs: torch.Tensor, streams: torch.Tensor,
                    lengths: torch.Tensor, num_banks: int,
                    need_issue: bool = True
                    ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The lane step in torch ops: ``(issue (T,) | None, total (F,))``.

    Raises unless ``lengths`` are non-negative and sum to the slab's
    ``T`` rows.  The lanes are unpacked into a NOP-padded ``(F, steps)``
    block for a loop batched over the fleet, which stops at the longest
    lane (a NOP advances nothing).
    """
    f = lengths.shape[0]
    dev = streams.device
    i32 = torch.int32
    nb = int(num_banks)
    c = {name: cycs[:, j] for name, j in _F.items()}
    zero = torch.zeros(f, dtype=i32, device=dev)
    rdburst = c["cRL"] + c["cBURST"]
    wrburst = c["cWL"] + c["cBURST"]
    cmd_add = torch.stack([
        zero, c["cACT"], c["cPRE"], c["cPRE"], c["cCAS"], c["cCAS"],
        c["cACT"], c["cACT"], c["cACT"], c["cACT"], c["cPRE"], c["cCAS"],
        c["cCAS"], c["cMACCMD"], c["cCAS"], c["cCAS"], zero], dim=1)
    drain_add = torch.stack([
        zero, c["cRCD"], c["cRP"], c["cRP"], rdburst, wrburst, c["cRFC"],
        c["cMODE"], c["cMODE"], c["cRCD"], c["cRP"], wrburst, wrburst,
        c["cMACPIPE"], rdburst, c["cMOV"], zero], dim=1)

    lens = lengths.long()
    if f and int(lens.min()) < 0:
        raise ValueError("lengths must be >= 0")
    if int(lens.sum()) != streams.shape[0]:
        raise ValueError(f"streams holds {streams.shape[0]} commands, "
                         f"lengths sum to {int(lens.sum())}")
    steps = int(lens.max()) if f else 0
    bank_ids = torch.arange(nb, dtype=i32, device=dev)
    neg_b = torch.full((f, nb), NEG, dtype=i32, device=dev)

    # Every per-command quantity that does not depend on the state is
    # computed for the whole (F, steps) block up front; a row past a
    # lane's end reads the zero row appended to the slab, a NOP.
    pos = torch.arange(steps, device=dev)[None, :]
    live = pos < lens[:, None]
    rows = torch.where(live, (lens.cumsum(0) - lens)[:, None] + pos,
                       streams.shape[0])
    cmds = torch.cat([streams, streams.new_zeros((1, 4))])[rows].to(i32)
    op = cmds[..., 0]
    a = cmds[..., 1]                        # rows/cols never affect timing
    opi = _table_index(op, C.NUM_OPCODES).long()
    ai = _table_index(a, nb).long()
    add_cmd = cmd_add.gather(1, opi)
    add_drain = drain_add.gather(1, opi)
    per_step = [x.t().contiguous().unbind(0) for x in (op, a, ai, opi,
                                                       add_cmd, add_drain)]

    ready_act = torch.zeros((f, nb), dtype=i32, device=dev)
    act_cycle = neg_b.clone()
    rd_cycle = neg_b.clone()
    wr_end = neg_b.clone()
    faw = torch.full((f, 4), NEG, dtype=i32, device=dev)
    faw_i = torch.zeros(f, dtype=torch.long, device=dev)
    last_act = torch.full((f,), NEG, dtype=i32, device=dev)
    last_actmb = last_act.clone()
    last_cas = last_act.clone()
    last_mac = last_act.clone()
    bus_free, bus_dir, cmd_free = zero, zero, zero
    srf_ready, mac_pipe_end = zero, zero
    mode_ready, drain, fence_until = zero, zero, zero

    issue = []
    for op_s, a_s, ai_s, opi_s, cadd, dadd in zip(*per_step):
        is_nop = op_s == C.NOP
        is_act = op_s == C.ACT
        is_pre = op_s == C.PRE
        is_prea = (op_s == C.PREA) | (op_s == C.PRE_MB)
        is_rd = op_s == C.RD
        is_wr = op_s == C.WR
        is_refab = op_s == C.REFAB
        is_mode_mb = op_s == C.MODE_MB
        is_mode_sb = op_s == C.MODE_SB
        is_mode = is_mode_mb | is_mode_sb
        is_actmb = op_s == C.ACT_MB
        is_wrsrf = op_s == C.WR_SRF
        is_wrreg = is_wrsrf | (op_s == C.WR_IRF)
        is_mac = op_s == C.MAC
        is_rdacc = op_s == C.RD_ACC
        is_mov = op_s == C.MOV_ACC
        is_fence = op_s == C.FENCE
        is_actfam = is_act | is_actmb
        rd_bus = is_rd | is_rdacc
        wr_bus = is_wr | is_wrreg
        sets_cas = rd_bus | wr_bus | is_mov

        t0 = torch.maximum(torch.maximum(cmd_free, fence_until), mode_ready)
        act_a = _gather(act_cycle, ai_s)
        onehot_a = bank_ids[None, :] == a_s[:, None]
        quad = (bank_ids[None, :] % 4) == a_s[:, None]
        max_act = act_cycle.amax(1)
        turn_r = torch.where(bus_dir == 1, c["cWTR"], 0)
        turn_w = torch.where(bus_dir == 0, c["cRTW"], 0)
        prea_t = torch.maximum(
            torch.maximum(t0, max_act + c["cRAS"]),
            torch.maximum(torch.maximum(rd_cycle.amax(1) + c["cRTP"],
                                        wr_end.amax(1) + c["cWR"]),
                          last_mac + c["cRTP"]))
        mode_t = torch.maximum(t0, drain)
        wrreg_t = torch.maximum(
            torch.maximum(t0, last_cas + c["cSRFI"]),
            torch.maximum(bus_free + turn_w - c["cWL"],
                          last_mac + c["cMACWR"]))
        cas_rd = torch.maximum(last_cas + c["cCCD"],
                               bus_free + turn_r - c["cRL"])
        cand = torch.stack([
            t0,                                                  # NOP
            torch.maximum(                                       # ACT
                torch.maximum(t0, _gather(ready_act, ai_s)),
                torch.maximum(torch.maximum(act_a + c["cRC"],
                                            last_act + c["cRRD"]),
                              _gather(faw, faw_i) + c["cFAW"])),
            torch.maximum(                                       # PRE
                torch.maximum(t0, act_a + c["cRAS"]),
                torch.maximum(_gather(rd_cycle, ai_s) + c["cRTP"],
                              _gather(wr_end, ai_s) + c["cWR"])),
            prea_t,                                              # PREA
            torch.maximum(                                       # RD
                torch.maximum(t0, act_a + c["cRCD"]),
                torch.maximum(cas_rd, _gather(wr_end, ai_s) + c["cWTR"])),
            torch.maximum(                                       # WR
                torch.maximum(t0, act_a + c["cRCD"]),
                torch.maximum(last_cas + c["cCCD"],
                              bus_free + turn_w - c["cWL"])),
            torch.maximum(t0, ready_act.amax(1)),                # REFAB
            mode_t,                                              # MODE_MB
            mode_t,                                              # MODE_SB
            torch.maximum(                                       # ACT_MB
                torch.maximum(t0, last_actmb + c["cRRDMB"]),
                torch.maximum(
                    last_act + c["cRRD"],
                    torch.maximum(
                        torch.where(quad, ready_act, neg_b).amax(1),
                        torch.where(quad, act_cycle, neg_b).amax(1)
                        + c["cRC"]))),
            prea_t,                                              # PRE_MB
            wrreg_t,                                             # WR_SRF
            wrreg_t,                                             # WR_IRF
            torch.maximum(                                       # MAC
                torch.maximum(t0, last_mac + c["cMACI"]),
                torch.maximum(srf_ready, max_act + c["cRCD"])),
            torch.maximum(torch.maximum(t0, mac_pipe_end),       # RD_ACC
                          cas_rd),
            torch.maximum(torch.maximum(t0, mac_pipe_end),       # MOV_ACC
                          last_cas + c["cCCD"]),
            drain + c["cFENCE"],                                 # FENCE
        ], dim=1)
        t = _gather(cand, opi_s)
        end_w = t + wrburst
        tb = t[:, None]

        ready_act = torch.where((is_pre[:, None] & onehot_a)
                                | is_prea[:, None], tb + c["cRP"][:, None],
                                ready_act)
        ready_act = torch.where(is_refab[:, None], tb + c["cRFC"][:, None],
                                ready_act)
        act_cycle = torch.where((is_act[:, None] & onehot_a)
                                | (is_actmb[:, None] & quad), tb, act_cycle)
        rd_cycle = torch.where((is_rd[:, None] & onehot_a) | is_mac[:, None],
                               tb, rd_cycle)
        wr_end = torch.where(is_wr[:, None] & onehot_a, end_w[:, None],
                             wr_end)
        wr_end = torch.where(is_mov[:, None],
                             torch.maximum(wr_end, (t + c["cMOV"])[:, None]),
                             wr_end)
        faw = torch.where(is_actfam[:, None]
                          & (torch.arange(4, device=dev)[None, :]
                             == faw_i[:, None]), tb, faw)
        faw_i = torch.where(is_actfam, (faw_i + 1) % 4, faw_i)
        last_act = torch.where(is_actfam, t, last_act)
        last_actmb = torch.where(is_actmb, t, last_actmb)
        last_cas = torch.where(sets_cas, t, last_cas)
        bus_free = torch.where(rd_bus, t + rdburst,
                               torch.where(wr_bus, end_w, bus_free))
        bus_dir = torch.where(rd_bus, 0, torch.where(wr_bus, 1, bus_dir))
        cmd_free = torch.where(is_nop, cmd_free, t + cadd)
        last_mac = torch.where(is_mac, t, last_mac)
        srf_ready = torch.where(is_wrsrf, torch.maximum(srf_ready, end_w),
                                srf_ready)
        mac_pipe_end = torch.where(is_mac, t + c["cMACPIPE"], mac_pipe_end)
        mode_ready = torch.where(is_mode, t + c["cMODE"], mode_ready)
        drain = torch.where(is_nop, drain, torch.maximum(drain, t + dadd))
        fence_until = torch.where(is_fence, t, fence_until)
        if need_issue:
            issue.append(t)

    if not need_issue:
        return None, drain
    if not issue:
        return torch.zeros(0, dtype=i32, device=dev), drain
    return torch.stack(issue, dim=1)[live], drain


def _check(cycs: torch.Tensor, streams: torch.Tensor,
           lengths: torch.Tensor, num_banks: int) -> None:
    if int(num_banks) not in SUPPORTED_BANKS:
        raise ValueError(f"num_banks must be one of {SUPPORTED_BANKS}, "
                         f"got {num_banks}")
    if streams.dim() != 2 or streams.shape[1] != 4:
        raise ValueError(f"streams must be (T, 4), got "
                         f"{tuple(streams.shape)}")
    if cycs.dim() != 2 or cycs.shape[1] != len(CYC_FIELDS):
        raise ValueError(f"cycs must be (F, {len(CYC_FIELDS)}), got "
                         f"{tuple(cycs.shape)}")
    f = cycs.shape[0]
    if tuple(lengths.shape) != (f,):
        raise ValueError(f"lengths must be ({f},), got "
                         f"{tuple(lengths.shape)}")
    for name, x in (("cycs", cycs), ("streams", streams),
                    ("lengths", lengths)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != streams.device:
            raise ValueError(f"{name} is on {x.device}, streams on "
                             f"{streams.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lane_scan(cycs: torch.Tensor, streams: torch.Tensor,
              lengths: torch.Tensor, num_banks: int,
              need_issue: bool = True
              ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Resolve a ragged slab of lanes: ``(issue (T,) | None, total
    (F,))``.

    CPU tensors run :func:`lane_scan_plain`; CUDA tensors launch the
    kernel on the current stream (building it on first use) and raise if
    the launch fails.  The launch reads no tensor back: the kernel clamps
    each lane to the slab's rows, and issue entries that no lane covers
    are left unwritten.
    """
    global LAUNCHES
    _check(cycs, streams, lengths, num_banks)
    if streams.device.type == "cpu":
        return lane_scan_plain(cycs, streams, lengths, num_banks,
                               need_issue)
    if streams.device.type != "cuda":
        raise ValueError(f"lane_scan runs on cpu or cuda tensors, got "
                         f"{streams.device}")
    from repro_torch.kernels import build

    f, t = lengths.shape[0], streams.shape[0]
    totals = torch.empty(f, dtype=torch.int32, device=streams.device)
    issue = (torch.empty(t, dtype=torch.int32, device=streams.device)
             if need_issue else None)
    if f == 0:
        return issue, totals
    if streams.data_ptr() % 16:
        raise ValueError("streams must be 16-byte aligned")
    with torch.cuda.device(streams.device):
        build.launch("lane_scan_launch", cycs.data_ptr(),
                     streams.data_ptr(), lengths.data_ptr(),
                     issue.data_ptr() if need_issue else None,
                     totals.data_ptr(), f, t, int(num_banks),
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return issue, totals


def probe_stream(num_banks: int) -> torch.Tensor:
    """A tiny but non-trivial lane touching ACT/RD/MAC/fence paths (the
    reference's capability-probe lane, kept as a kernel check)."""
    ops = [(C.ACT, 0, 3, 0), (C.RD, 0, 0, 0), (C.PRE, 0, 0, 0),
           (C.MODE_MB, 0, 0, 0), (C.ACT_MB, 1 % num_banks, 2, 0),
           (C.WR_SRF, 0, 0, 0), (C.MAC, 0, 0, 0), (C.RD_ACC, 0, 0, 0),
           (C.FENCE, 0, 0, 0), (C.MODE_SB, 0, 0, 0)]
    s = torch.zeros((16, 4), dtype=torch.int32)
    s[: len(ops)] = torch.tensor(ops, dtype=torch.int32)
    return s
