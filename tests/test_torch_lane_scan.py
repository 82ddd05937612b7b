"""The port's lane resolver vs the JAX engine, bit for bit.

``lane_scan_plain`` (what ``lane_scan`` runs on CPU tensors) must equal
both ``repro.core.engine.resolve_lanes`` (the scan backend) and the
``RefEngine`` oracle on the conformance corpus (8, 12 and 16 banks), the
probe lane, ragged slabs (zero-length lanes among them), lanes with an
explicit NOP tail and totals-only runs.  On
out-of-range opcodes and banks, and on timings that wrap int32, it is
held to the JAX engine alone (the oracle's Python ints neither wrap nor
index the same way).  ``tests/test_torch_gpu.py`` holds the CUDA kernel
to this plain version on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.core import engine as ref_engine
from repro.core.engine_ref import RefEngine
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
from repro.kernels import lane_scan as ref_lane_scan
from repro.pimkernel.executor import PimExecutor as RefExecutor
from repro.pimkernel.tileconfig import PimDType as RefDType

from repro_torch.core import engine, trace
from repro_torch.core.timing import cycles_from_dict
from repro_torch.kernels import lane_scan

from test_conformance import fleet_from_seed, make_spec
from test_engine import build_valid_stream, random_op_tuples
from test_torch_gpu import edge_lanes


def port_cyc(ref_cyc):
    return cycles_from_dict(dataclasses.asdict(ref_cyc))


def run_plain(lanes, need_issue=True):
    """Resolve reference-typed lanes with the plain resolver, one call
    per bank count; returns [(issue | None, total)] in order."""
    out = [None] * len(lanes)
    groups: dict[int, list[int]] = {}
    for i, (cyc, _s) in enumerate(lanes):
        groups.setdefault(cyc.num_banks, []).append(i)
    for nb, idxs in groups.items():
        cycs, streams, lengths = engine.pack_lanes(
            [(port_cyc(lanes[i][0]), lanes[i][1]) for i in idxs])
        iss, tot = lane_scan.lane_scan(cycs, streams, lengths, nb,
                                       need_issue=need_issue)
        assert streams.shape[0] == int(lengths.sum())
        for row, (i, at) in enumerate(zip(idxs, starts(lengths))):
            n = lanes[i][1].shape[0]
            out[i] = (None if iss is None else iss[at:at + n].numpy(),
                      int(tot[row]))
    return out


def starts(lengths):
    """Each lane's first row in a ragged slab."""
    return (lengths.long().cumsum(0) - lengths.long()).tolist()


def assert_matches_jax(lanes, need_issue=True):
    ref_engine.lane_cache_reset()
    want = ref_engine.resolve_lanes(lanes, need_issue=need_issue)
    got = run_plain(lanes, need_issue=need_issue)
    for j, ((gi, gt), (wi, wt)) in enumerate(zip(got, want)):
        assert gt == wt, f"total divergence on lane {j}"
        if need_issue:
            np.testing.assert_array_equal(gi, wi,
                                          err_msg=f"issue, lane {j}")
        else:
            assert gi is None
    return got


def assert_matches_ref(lanes, got):
    for (cyc, s), (gi, gt) in zip(lanes, got):
        iss_ref, tot_ref = RefEngine(cyc, validate=False).run(s)
        np.testing.assert_array_equal(gi.astype(np.int64), iss_ref)
        assert gt == tot_ref


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_and_oracle_on_corpus(seed):
    lanes = [(spec.derive_cycles(), s)
             for spec, streams in fleet_from_seed(seed) for s in streams]
    assert {c.num_banks for c, _s in lanes} <= {8, 12, 16}
    assert_matches_ref(lanes, assert_matches_jax(lanes))


def test_plain_mixed_bank_counts():
    rng = np.random.default_rng(99)
    lanes = []
    for bg in (2, 3, 4, 2, 4, 3):
        cyc = make_spec(bg, 18.0, 18.0, 42.0, 3, 14, 150.0).derive_cycles()
        ops = [(k, b % cyc.num_banks, r, n)
               for (k, b, r, n) in random_op_tuples(rng, max_ops=25)]
        lanes.append((cyc, build_valid_stream(ops)))
    assert_matches_ref(lanes, assert_matches_jax(lanes))


@pytest.mark.parametrize("bankgroups", [2, 3, 4])
def test_probe_lane(bankgroups):
    cyc = make_spec(bankgroups, 18.0, 18.0, 42.0, 3, 14, 150.0) \
        .derive_cycles()
    probe = lane_scan.probe_stream(cyc.num_banks).numpy()
    np.testing.assert_array_equal(
        probe, ref_lane_scan._probe_stream(cyc.num_banks))
    lanes = [(cyc, probe)]
    assert_matches_ref(lanes, assert_matches_jax(lanes))


def test_ragged_and_nop_padded_lanes_agree():
    """One launch over a ragged slab == each lane alone == the lane with
    an explicit NOP tail; a slab whose rows do not match the lengths
    raises in the plain path."""
    rng = np.random.default_rng(4)
    cyc = REF_DEFAULT.derive_cycles()
    streams = [build_valid_stream(random_op_tuples(rng, max_ops=20))
               for _ in range(5)]
    lanes = [(cyc, s) for s in streams]
    got = assert_matches_jax(lanes)
    padded = [(cyc, np.concatenate([s, np.zeros((37, 4), np.int32)]))
              for s in streams]
    for (gi, gt), (pi, pt) in zip(got, run_plain(padded)):
        assert gt == pt
        np.testing.assert_array_equal(gi, pi[: gi.shape[0]])
        assert (pi[gi.shape[0]:] == pi[-1]).all()
    # a slab shorter than the lengths say, or a negative length, raises
    cycs, packed, lengths = engine.pack_lanes([(port_cyc(cyc), s)
                                               for s in streams])
    assert packed.shape == (sum(s.shape[0] for s in streams), 4)
    with pytest.raises(ValueError, match="lengths sum to"):
        lane_scan.lane_scan_plain(cycs, packed[:-1].contiguous(), lengths,
                                  16)
    with pytest.raises(ValueError, match="lengths sum to"):
        lane_scan.lane_scan(cycs, packed[:-1].contiguous(), lengths, 16)
    short = lengths.clone()
    short[0] = -1
    with pytest.raises(ValueError, match=">= 0"):
        lane_scan.lane_scan_plain(cycs, packed, short, 16)


def _ragged_slab(shape, rng):
    """Streams of one ragged slab: zero-length lanes among others, a
    1-command lane beside a long one, or the longest lane last."""
    def lane(max_ops):
        return build_valid_stream(random_op_tuples(rng, max_ops=max_ops))

    empty = np.zeros((0, 4), np.int32)
    if shape == "zero_length_interleaved":
        return [empty, lane(12), empty, empty, lane(30), empty, lane(5),
                empty]
    if shape == "one_command_beside_long":
        return [np.array([[1, 3, 7, 0]], np.int32), lane(60),
                np.array([[4, 1, 0, 0]], np.int32)]
    return sorted([lane(80), lane(5), lane(15)], key=len)


@pytest.mark.parametrize("seed,shape", enumerate(
    ["zero_length_interleaved", "one_command_beside_long", "longest_last"]))
def test_plain_on_ragged_slabs_matches_jax_lane_by_lane(seed, shape):
    """Ragged slabs of awkward shapes, each lane read at its offset, equal
    the JAX engine lane by lane (it takes a zero-length lane too)."""
    streams = _ragged_slab(shape, np.random.default_rng(seed))
    lens = [s.shape[0] for s in streams]
    assert {"zero_length_interleaved": lens.count(0) == 5,
            "one_command_beside_long": lens[0] == lens[2] == 1 < lens[1],
            "longest_last": lens[-1] > max(lens[:-1])}[shape]
    lanes = [(REF_DEFAULT.derive_cycles(), s) for s in streams]
    assert_matches_jax(lanes, need_issue=False)
    got = assert_matches_jax(lanes)
    assert_matches_ref(lanes, got)
    for (gi, gt), n in zip(got, lens):
        assert gi.shape == (n,) and (n or gt == 0)


def test_totals_only_matches():
    rng = np.random.default_rng(6)
    lanes = [(spec.derive_cycles(), s)
             for spec, streams in fleet_from_seed(3) for s in streams]
    lanes += [(REF_DEFAULT.derive_cycles(),
               build_valid_stream(random_op_tuples(rng)))]
    assert_matches_jax(lanes, need_issue=False)


def test_pim_stream_matches_oracle():
    ex = RefExecutor()
    layout, program = ex.plan(256, 2048, RefDType.W8A16)
    gs = ex.build_streams(layout, program, fence=True, flush="dram")
    cyc = REF_DEFAULT.derive_cycles()
    lanes = [(cyc, s) for s in gs.streams]
    assert_matches_ref(lanes, run_plain(lanes))


def _wild_lanes(seed, nb_groups=(2, 3, 4), n=48):
    rng = np.random.default_rng(seed)
    lanes = []
    for bg in nb_groups:
        cyc = make_spec(bg, 18.0, 18.0, 42.0, 3, 14, 150.0).derive_cycles()
        nb = cyc.num_banks
        s = np.zeros((n, 4), np.int32)
        s[:, 0] = rng.integers(-25, 25, n)
        s[:, 1] = rng.choice([-100, -nb - 1, -nb, -5, -1, 0, 1, 3, 4,
                              nb - 1, nb, nb + 1, 100], n)
        s[:, 2] = rng.integers(0, 10, n)
        lanes.append((cyc, s))
    return lanes


@pytest.mark.parametrize("seed", range(3))
def test_out_of_range_opcodes_and_banks_match_jax(seed):
    """JAX gathers wrap a negative index once and clamp; predicates and
    one-hot masks see the raw value — the plain version does the same."""
    assert_matches_jax(_wild_lanes(seed))


def test_int32_wraparound_matches_jax():
    cyc = REF_DEFAULT.derive_cycles()
    big = dataclasses.replace(cyc, cFENCE=(1 << 30) + 3,
                              cMODE=(1 << 30) + 5, cRFC=(1 << 31) - 7,
                              cRP=(1 << 31) - 1)
    ops = [[16, 0, 0, 0]] * 4 + [[7, 0, 0, 0], [3, 0, 0, 0],
                                 [6, 0, 0, 0], [8, 0, 0, 0],
                                 [1, 2, 0, 0], [2, 2, 0, 0],
                                 [16, 0, 0, 0]] * 3
    got = assert_matches_jax([(big, np.asarray(ops, np.int32))])
    assert min(got[0][0]) < 0          # the run really wrapped


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("nb", [4, 32])
def test_plain_matches_jax_on_the_kernel_edge_lanes(nb, seed):
    """The lanes ``test_torch_gpu.py`` holds the warp kernel to plain on
    (chunk-edge lengths, zero-length lanes among them, 4 and 32 banks,
    out-of-range banks and opcodes, timings near -2**31), through the JAX
    engine, each lane read at its offset in the ragged slab.  Some REFAB
    must issue below NEG, or the lanes could not tell a reduction's
    neutral value."""
    cycs, streams, lengths = edge_lanes(nb, seed)
    issue, totals = lane_scan.lane_scan_plain(cycs, streams, lengths, nb)
    assert issue.shape == (streams.shape[0],)
    base = dataclasses.replace(REF_DEFAULT.derive_cycles(), num_banks=nb)
    at = starts(lengths) + [streams.shape[0]]
    lanes = [(dataclasses.replace(base, **dict(zip(lane_scan.CYC_FIELDS,
                                                   row))),
              streams[at[f]:at[f + 1]].numpy())
             for f, row in enumerate(cycs.tolist())]
    ref_engine.lane_cache_reset()
    for f, (wi, wt) in enumerate(ref_engine.resolve_lanes(lanes)):
        np.testing.assert_array_equal(issue[at[f]:at[f + 1]].numpy(), wi,
                                      err_msg=f"issue, lane {f}")
        assert int(totals[f]) == wt, f"total, lane {f}"
    refab = streams[:, 0] == 6
    assert bool((issue[refab] < lane_scan.NEG).any())


def test_pack_cycles_matches_reference_packing():
    cycs = [REF_DEFAULT.derive_cycles(),
            make_spec(4, 24.0, 20.0, 50.0, 5, 9, 90.0).derive_cycles()]
    assert lane_scan.CYC_FIELDS == ref_lane_scan.CYC_FIELDS
    want = np.asarray(ref_lane_scan.pack_cycles(
        ref_engine.stack_cycles(cycs)))
    got = engine.pack_cycles([port_cyc(c) for c in cycs]).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_checks_inputs_and_never_counts_cpu_runs():
    cycs, streams, lengths = engine.pack_lanes(
        [(port_cyc(REF_DEFAULT.derive_cycles()),
          lane_scan.probe_stream(16).numpy())])
    before = trace.totals().counter("lane_scan.launches")
    lane_scan.lane_scan(cycs, streams, lengths, 16)
    assert trace.totals().counter("lane_scan.launches") == before
    with pytest.raises(ValueError, match="num_banks"):
        lane_scan.lane_scan(cycs, streams, lengths, 6)
    with pytest.raises(TypeError, match="int32"):
        lane_scan.lane_scan(cycs, streams.long(), lengths, 16)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((streams.shape[0], 8), dtype=torch.int32)
        lane_scan.lane_scan(cycs, wide[:, ::2], lengths, 16)
    with pytest.raises(ValueError, match=r"\(T, 4\)"):
        lane_scan.lane_scan(cycs, streams[None], lengths, 16)
    with pytest.raises(ValueError, match="lengths"):
        lane_scan.lane_scan(cycs, streams, lengths[:0], 16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        lane_scan.lane_scan(cycs.to("meta"), streams.to("meta"),
                            lengths.to("meta"), 16)
