"""The port's spec, controller, energy and planner modules vs the JAX
package's (both numpy): equal cycle derivations for every spec family,
byte-identical command streams with equal structural keys for every
dtype x fence x reshape x flush, equal layouts, DRAM images, programs,
payloads and energies.  Design points are carried over field for field
with ``spec_from_dict``."""
import dataclasses
import enum

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.configs.specfam import SPEC_FAMILIES
from repro.core import controller as ref_controller
from repro.core import energy as ref_energy
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
from repro.core.timing import LpddrTimings as RefTimings
from repro.core.timing import SystemSpec as RefSpec
from repro.pimkernel import codegen as ref_codegen
from repro.pimkernel.datamapper import DataMapper as RefMapper
from repro.pimkernel.gemv import GemvKernel as RefKernel
from repro.pimkernel.tileconfig import ALL_DTYPES as REF_DTYPES

from repro_torch.core import controller, energy
from repro_torch.core.timing import (DEFAULT_SYSTEM, cycles_from_dict,
                                     spec_from_dict)
from repro_torch.pimkernel import codegen
from repro_torch.pimkernel.datamapper import DataMapper
from repro_torch.pimkernel.gemv import GemvKernel
from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType

SPECS = {"default": REF_DEFAULT, **SPEC_FAMILIES}


def port_spec(ref):
    return spec_from_dict(dataclasses.asdict(ref))


def plain(x):
    """Package-neutral view: dataclasses by field values, enums by name
    (the two packages' classes differ, their contents must not)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(dataclasses.astuple(x)))
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (tuple, list)):
        return type(x)(plain(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(SPECS))
def test_derive_cycles_equal(name):
    ref = SPECS[name]
    port = port_spec(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cyc = port.derive_cycles()
    assert dataclasses.asdict(cyc) == dataclasses.asdict(
        ref.derive_cycles())
    assert cycles_from_dict(dataclasses.asdict(cyc)) == cyc
    assert port.total_pim_blocks == ref.total_pim_blocks


def test_default_system_equal():
    assert DEFAULT_SYSTEM == port_spec(REF_DEFAULT)


def test_dtypes_and_tiles_equal():
    assert [d.name for d in ALL_DTYPES] == [d.name for d in REF_DTYPES]
    from repro.pimkernel.tileconfig import TileConfig as RefTile
    from repro_torch.pimkernel.tileconfig import TileConfig
    for d, rd in zip(ALL_DTYPES, REF_DTYPES):
        assert (d.kind, d.w_bits, d.a_bits) == (rd.kind, rd.w_bits,
                                                rd.a_bits)
        assert plain(TileConfig.make(d, DEFAULT_SYSTEM.pim)) == plain(
            RefTile.make(rd, REF_DEFAULT.pim))


def _plans(dtype_name, h, w, reshape, spec=REF_DEFAULT):
    ref_layout = RefMapper(spec).layout(h, w, [d for d in REF_DTYPES
                                               if d.name == dtype_name][0],
                                        reshape=reshape)
    layout = DataMapper(port_spec(spec)).layout(h, w,
                                                PimDType[dtype_name],
                                                reshape=reshape)
    ref_prog = ref_codegen.synthesize(ref_layout.tc, spec.pim)
    prog = codegen.synthesize(layout.tc, layout.spec.pim)
    return (layout, prog), (ref_layout, ref_prog)


@pytest.mark.parametrize("flush", ["bus", "dram"])
@pytest.mark.parametrize("reshape", [False, True])
@pytest.mark.parametrize("fence", [False, True])
@pytest.mark.parametrize("dtype", [d.name for d in ALL_DTYPES])
def test_streams_byte_identical_and_keys_equal(dtype, fence, reshape,
                                               flush):
    for h, w in ((200, 1100), (512, 2048)):
        (layout, prog), (ref_layout, ref_prog) = _plans(dtype, h, w,
                                                        reshape)
        assert plain(dataclasses.astuple(layout)[1:]) == plain(
            dataclasses.astuple(ref_layout)[1:])
        gs = GemvKernel().build(layout, prog, fence=fence, flush=flush)
        ref = RefKernel().build(ref_layout, ref_prog, fence=fence,
                                flush=flush)
        assert len(gs.streams) == len(ref.streams)
        for s, rs in zip(gs.streams, ref.streams):
            assert s.dtype == rs.dtype == np.int32
            assert s.tobytes() == rs.tobytes()
        assert plain(gs.stream_keys) == plain(ref.stream_keys)
        assert gs.meta == ref.meta


@pytest.mark.parametrize("dtype", [d.name for d in ALL_DTYPES])
def test_payloads_images_and_programs_equal(dtype):
    """With operands: WR_SRF payloads, DRAM images and the IRF program
    match the reference; the port's vectorized build matches its own
    per-command reference build."""
    rng = np.random.default_rng(7)
    (layout, prog), (ref_layout, ref_prog) = _plans(dtype, 130, 700, True)
    d = PimDType[dtype]
    if d.is_fp:
        wts = rng.integers(0, 256, size=(130, 700)).astype(np.uint8)
        x = rng.standard_normal(700).astype(np.float32)
    else:
        lim = 1 << (d.w_bits - 1)
        wts = rng.integers(-lim, lim, size=(130, 700)).astype(np.int32)
        alim = 1 << (d.a_bits - 1)
        x = rng.integers(-alim, alim, size=(700,)).astype(np.int32)
    assert plain(prog.insns) == plain(ref_prog.insns)
    np.testing.assert_array_equal(prog.acc_idx, ref_prog.acc_idx)
    np.testing.assert_array_equal(prog.srf_off, ref_prog.srf_off)
    img = DataMapper(layout.spec).pack(layout, wts)
    ref_img = RefMapper(REF_DEFAULT).pack(ref_layout, wts)
    assert img.keys() == ref_img.keys()
    for k in img:
        assert img[k].tobytes() == ref_img[k].tobytes()
    np.testing.assert_array_equal(
        DataMapper(layout.spec).unpack(layout, img),
        RefMapper(REF_DEFAULT).unpack(ref_layout, ref_img))
    gs = GemvKernel().build(layout, prog, x=x)
    ref = RefKernel().build(ref_layout, ref_prog, x=x)
    own = GemvKernel().build_reference(layout, prog, x=x)
    for pays in (ref.payloads, own.payloads):
        assert len(gs.payloads) == len(pays)
        for p, rp in zip(gs.payloads, pays):
            assert p.keys() == rp.keys()
            for k in p:
                assert p[k].tobytes() == rp[k].tobytes()
    for s, rs in zip(gs.streams, own.streams):
        assert s.tobytes() == rs.tobytes()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_baseline_streams_identical(name):
    ref = SPECS[name]
    spec = port_spec(ref)
    for nbytes in (0, 1, 32, 4096, 70_000, 1 << 20):
        assert (controller.sequential_read_stream(nbytes, spec).tobytes()
                == ref_controller.sequential_read_stream(nbytes,
                                                         ref).tobytes())
        assert (controller.interleaved_rw_stream(nbytes, 999, spec)
                .tobytes() == ref_controller.interleaved_rw_stream(
                    nbytes, 999, ref).tobytes())


def test_refresh_insertion_identical():
    ref = dataclasses.replace(REF_DEFAULT, refresh_enabled=True,
                              timings=RefTimings(tREFI=400.0))
    spec = port_spec(ref)
    s = controller.sequential_read_stream(200_000, spec)
    rs = ref_controller.sequential_read_stream(200_000, ref)
    assert (controller.with_refresh(s, spec).tobytes()
            == ref_controller.with_refresh(rs, ref).tobytes())


def test_energy_equal():
    rng = np.random.default_rng(3)
    spec = port_spec(REF_DEFAULT)
    streams = [rng.integers(0, 17, size=(300, 4)).astype(np.int32)
               for _ in range(4)]
    totals = rng.integers(1, 10_000, size=4).astype(np.int32)
    for banks in (1, 7, 16):
        assert (energy.gemv_energy_summary(streams, totals, spec, 12345,
                                           active_banks=banks)
                == ref_energy.gemv_energy_summary(streams, totals,
                                                  REF_DEFAULT, 12345,
                                                  active_banks=banks))
    other = RefSpec(timings=RefTimings(ck_ghz=1.6))
    counts = rng.integers(0, 50, size=17)
    assert (energy.stream_energy_pj(counts, 777, port_spec(other))
            == ref_energy.stream_energy_pj(counts, 777, other))


def test_fp8_and_activation_codecs_equal():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(512) * 40).astype(np.float32)
    raw = rng.integers(0, 256, size=64).astype(np.uint8)
    for d, rd in zip(ALL_DTYPES, REF_DTYPES):
        vals = x if d.is_fp else np.round(x).astype(np.int32)
        enc = codegen.encode_acts(vals, d)
        assert enc.tobytes() == ref_codegen.encode_acts(vals, rd).tobytes()
        np.testing.assert_array_equal(codegen.decode_srf(raw, d),
                                      ref_codegen.decode_srf(raw, rd))
        np.testing.assert_array_equal(codegen.decode_w_burst(raw[:32], d),
                                      ref_codegen.decode_w_burst(raw[:32],
                                                                 rd))
