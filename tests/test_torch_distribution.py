"""The port's distribution layer and the dry-run's cell lowering, held to
the JAX package.

* Sharding: per-leaf pspecs, cache and input sharding trees and
  ``state_bytes_per_device`` ``==`` the reference's for every arch x kind
  x mesh ((16, 16), (2, 16, 16)) x ``QUANT_BITS`` {0, 8, 4} x
  ``SERVE_TP_ONLY`` (the reference's shardings built on a JAX
  ``AbstractMesh``, which needs no devices).
* Roofline: ``model_flops``, ``attention_context``, ``attention_hlo_flops``
  (block skipping on and off) and ``min_traffic_bytes`` ``==`` for all
  (arch, shape) cells; ``RooflineTerms.row()`` ``==`` once the port's
  hardware constants are set to the reference's.
* Collectives: hand-built records priced by the reference's conventions;
  one FSDP matmul on a 4-rank fake mesh records the all-gather a hand
  count gives; per-device FLOPs checked against a hand count.
* Lowering: smoke configs of granite-8b, dbrx-132b (experts sharded),
  mamba2-130m and gemma3-4b x each kind traced on a (2, 2) mesh over a
  fake 4-rank group, at shapes cut to smoke size; the traced arguments'
  local bytes equal the rules' state bytes exactly; the 2/4-layer
  extrapolation equals a direct count; no process group outlives a test;
  an op DTensor cannot shard makes the cell an error.
"""
import dataclasses
import functools

import pytest
import torch
import torch.distributed as dist

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
from jax.sharding import AbstractMesh
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.distribution import roofline as RRL
from repro.distribution import sharding as RSH
from repro.models import model as RM

from repro_torch.configs import ARCHS, SHAPES, shapes_for, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution import hlo_analysis as H
from repro_torch.distribution import roofline as RL
from repro_torch.distribution import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M

MESHES = {"pod1": (16, 16), "pod2": (2, 16, 16)}
AXES = {"pod1": ("data", "model"), "pod2": ("pod", "data", "model")}
CELLS = [(a, s) for a, cfg in ARCHS.items() for s in shapes_for(cfg)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors run fastest on one intra-op thread, and the suite's
    worker processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _knobs():
    yield
    for mod in (M, RM):
        mod.QUANT_BITS = 0
        mod.KV_QUANT = False
        mod.REMAT_POLICY = "full"
    SH.SERVE_TP_ONLY = RSH.SERVE_TP_ONLY = False
    assert not dist.is_initialized(), "a process group leaked"


@pytest.fixture(autouse=True, scope="module")
def _cached_reference_specs():
    """Both packages' ``param_specs`` build the full-width tree each
    call; cache them per (arch, dtype, bits) for the module."""
    orig = RM.param_specs

    @functools.lru_cache(maxsize=None)
    def cached(cfg, dtype, bits):
        return orig(cfg, dtype)

    RM.param_specs = lambda cfg, dtype=jax.numpy.bfloat16: cached(
        cfg, dtype, RM.QUANT_BITS)
    port_orig = M.param_specs

    @functools.lru_cache(maxsize=None)
    def port_cached(cfg, dtype, bits):
        return port_orig(cfg, dtype)

    M.param_specs = lambda cfg, dtype=torch.bfloat16: port_cached(
        cfg, dtype, M.QUANT_BITS)
    yield
    RM.param_specs = orig
    M.param_specs = port_orig


def _set(bits=0, tp_only=False, kv_quant=False):
    M.QUANT_BITS = RM.QUANT_BITS = bits
    SH.SERVE_TP_ONLY = RSH.SERVE_TP_ONLY = tp_only
    M.KV_QUANT = RM.KV_QUANT = kv_quant


def _ref_specs(tree):
    """A reference sharding tree as {path: spec tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            tuple(s.spec) for p, s in flat}


def _port_specs(tree):
    return {p: tuple(s.spec) for p, s in SH.leaves_with_paths(
        tree, lambda x: isinstance(x, SH.NamedSharding))}


# ---------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------

@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_pspecs_equal_reference(arch, bits):
    _set(bits)
    for tp_only in (False, True):
        _set(bits, tp_only)
        for name, shape in MESHES.items():
            amesh = AbstractMesh(shape, AXES[name])
            pmesh = SH.MeshShape(dict(zip(AXES[name], shape)))
            for kind in ("train", "prefill", "decode"):
                assert SH.tp_rules(ARCHS[arch], pmesh, kind) == \
                    RSH.tp_rules(REF_ARCHS[arch], amesh, kind)
                want = _ref_specs(RSH.param_shardings(REF_ARCHS[arch],
                                                      amesh, kind))
                got = _port_specs(SH.param_shardings(ARCHS[arch], pmesh,
                                                     kind))
                assert got == want, (arch, bits, tp_only, name, kind)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_input_shardings_equal_reference(arch, kv_quant):
    _set(kv_quant=kv_quant)
    for name, shape in MESHES.items():
        amesh = AbstractMesh(shape, AXES[name])
        pmesh = SH.MeshShape(dict(zip(AXES[name], shape)))
        for sname in shapes_for(ARCHS[arch]):
            want = _ref_specs(RSH.input_shardings(REF_ARCHS[arch], amesh,
                                                  REF_SHAPES[sname]))
            got = _port_specs(SH.input_shardings(ARCHS[arch], pmesh,
                                                 SHAPES[sname]))
            assert got == want, (arch, name, sname)
            # the specs' tree has the shardings' leaves, path for path
            specs = M.input_specs(ARCHS[arch], SHAPES[sname])
            assert set(p for p, _ in SH.leaves_with_paths(specs)) == \
                set(got)
            ref_specs = RM.input_specs(REF_ARCHS[arch], REF_SHAPES[sname])
            ref_flat = {tuple(getattr(k, "key", getattr(k, "idx", None))
                              for k in p): (tuple(v.shape), str(v.dtype))
                        for p, v in jax.tree_util.tree_flatten_with_path(
                            ref_specs)[0]}
            got_flat = {p: (tuple(v.shape),
                            str(v.dtype).replace("torch.", ""))
                        for p, v in SH.leaves_with_paths(specs)}
            assert got_flat == ref_flat


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_bytes_equal_reference(arch):
    for bits, tp_only in ((0, False), (8, True), (4, True)):
        _set(bits, tp_only)
        for name, shape in MESHES.items():
            mesh = dict(zip(AXES[name], shape))
            for sname in shapes_for(ARCHS[arch]):
                got = SH.state_bytes_per_device(ARCHS[arch], SHAPES[sname],
                                                SH.MeshShape(mesh))
                want = RSH.state_bytes_per_device(
                    REF_ARCHS[arch], REF_SHAPES[sname], RSH.MeshShape(mesh))
                assert got == want, (arch, bits, name, sname)


def test_param_tree_matches_reference_leaf_for_leaf():
    for arch in ARCHS:
        for bits in (0, 8, 4):
            _set(bits)
            ref = {tuple(k.key for k in p): (tuple(v.shape), str(v.dtype))
                   for p, v in jax.tree_util.tree_flatten_with_path(
                       RM.param_specs(REF_ARCHS[arch]))[0]}
            got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for p, v in SH.leaves_with_paths(
                       M.param_specs(ARCHS[arch]))}
            assert got == ref, (arch, bits)
        is_leaf = SH._is_logical
        assert ([lg for _p, lg in SH.leaves_with_paths(
            M.param_logical(ARCHS[arch]), is_leaf)]
                == jax.tree.leaves(RM.param_logical(REF_ARCHS[arch]),
                                   is_leaf=is_leaf))


def test_to_placements_and_data_axes():
    from torch.distributed.tensor import Replicate, Shard
    with LM.fake_process_group():
        mesh = LM.make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert mesh.size() == 512
        assert LM.data_axes(mesh) == ("pod", "data")
        assert SH.to_placements((("pod", "data"), None, "model"), mesh) \
            == [Shard(0), Shard(0), Shard(2)]
        assert SH.to_placements((None, None), mesh) == [Replicate()] * 3
        one = LM.make_production_mesh(device_type="cpu")
        assert tuple(one.shape) == (16, 16) and one.size() == 256
    with LM.fake_process_group(4):
        host = LM.make_host_mesh(model=2)
        assert tuple(host.shape) == (2, 2)
        assert host.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    from repro.launch.mesh import data_axes as ref_data_axes
    assert LM.data_axes(SH.MeshShape(amesh.shape)) == ref_data_axes(amesh)


# ---------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch,sname", CELLS)
def test_roofline_math_equals_reference(arch, sname, monkeypatch):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    shape, rshape = SHAPES[sname], REF_SHAPES[sname]
    assert RL.model_flops(cfg, shape) == RRL.model_flops(rcfg, rshape)
    assert RL.attention_context(cfg, shape.seq_len) == \
        RRL.attention_context(rcfg, rshape.seq_len)
    for skip in (False, True):
        monkeypatch.setattr(RL, "FLASH_SKIP_BLOCKS", skip)
        monkeypatch.setattr(RRL, "FLASH_SKIP_BLOCKS", skip)
        assert RL.attention_hlo_flops(cfg, shape) == \
            RRL.attention_hlo_flops(rcfg, rshape)
    for remat in ("full", "none"):
        assert RL.min_traffic_bytes(cfg, shape, remat=remat) == \
            RRL.min_traffic_bytes(rcfg, rshape, remat=remat)
    assert RL.FLASH_BLOCK == RRL.FLASH_BLOCK
    for name in ("PEAK_FLOPS", "HBM_BW"):
        monkeypatch.setattr(RL, name, getattr(RRL, name))
    monkeypatch.setattr(RL, "LINK_BW", RRL.ICI_BW)
    kw = dict(arch=arch, shape=sname, mesh="pod1", chips=256,
              hlo_flops=3.1e17, hlo_bytes=2.2e15, coll_bytes=4.4e13,
              model_flops=RRL.model_flops(rcfg, rshape),
              traffic_dev=RRL.min_traffic_bytes(rcfg, rshape))
    assert RL.RooflineTerms(**kw).row() == RRL.RooflineTerms(**kw).row()


def test_h100_constants_are_spec_figures():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------
# Collectives and per-device counts
# ---------------------------------------------------------------------

def test_collective_conventions_equal_reference():
    from repro.distribution.hlo_analysis import collective_bytes as ref_cb
    from repro.distribution.hlo_analysis import DTYPE_BYTES, COLLECTIVES
    assert H.DTYPE_BYTES == DTYPE_BYTES and H.COLLECTIVES == COLLECTIVES
    recs = [H.CollectiveRecord("all-gather", "x", 256, 4096),
            H.CollectiveRecord("all-reduce", "x", 1024, 1024),
            H.CollectiveRecord("reduce-scatter", "x", 16384, 1024),
            H.CollectiveRecord("all-to-all", "x", 512, 512),
            H.CollectiveRecord("collective-permute", "x", 64, 64)]
    hlo = """
ENTRY %main (p0: bf16[16,128]) -> bf16[16,2048] {
  %ag = u8[4096]{0} all-gather(u8[256]{0} %p0), dims={0}
  %ar = u8[1024]{0} all-reduce(u8[1024]{0} %x), to_apply=%add
  %rs = u8[1024]{0} reduce-scatter(u8[16384]{0} %q), dims={0}
  %aa = u8[512]{0} all-to-all(u8[512]{0} %q), dims={0}
  %cp = u8[64]{0} collective-permute(u8[64]{0} %q), pairs={{0,1}}
}
"""
    assert H.collective_bytes(recs) == ref_cb(hlo)
    assert H.collective_bytes(recs, scan_trip_count=3)["total"] == \
        3 * ref_cb(hlo)["total"]


def test_fsdp_matmul_records_its_all_gather_and_local_flops():
    """x (B, d) split over batch on "data"; w (d, f) FSDP-split over d on
    "data" and over f on "model": the matmul gathers w over "data" (one
    all-gather of the (d, f/2) shard) and each device multiplies its
    (B/2, d) rows by (d, f/2)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distribution.layout import mesh_layout
    from repro_torch.models import layers as L
    b, d, f = 64, 256, 512
    with LM.fake_process_group(4):
        mesh = LM._device_mesh("cpu", (2, 2), ("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(b, d), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            w = distribute_tensor(torch.empty(d, f), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            rec = H.StepRecorder("cpu")
            with rec, mesh_layout():
                y = L.mm(x, w)
        assert [p for p in y.placements] == [Shard(0), Shard(1)]
    assert H.collective_bytes(rec.collectives) == {
        "all-gather": d * (f // 2) * 4, "total": d * (f // 2) * 4}
    assert rec.flops == 2 * (b // 2) * d * (f // 2)


# ---------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------

SMALL = {"train_4k": ShapeConfig("train_4k", 256, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 512, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 512, 8, "decode"),
         "long_500k": ShapeConfig("long_500k", 1024, 1, "decode")}


@pytest.fixture
def small_shapes(monkeypatch):
    for name, shp in SMALL.items():
        monkeypatch.setitem(SHAPES, name, shp)


def _lower(arch, sname, cfg, extrapolate=False):
    with LM.fake_process_group(4):
        mesh = LM._device_mesh("cpu", (2, 2), ("data", "model"))
        rec = D.run_cell(arch, sname, False, save=False,
                         extrapolate=extrapolate, cfg_override=cfg,
                         mesh=mesh)
    assert not dist.is_initialized()
    return rec


@pytest.mark.parametrize("arch", ["granite-8b", "dbrx-132b", "mamba2-130m",
                                  "gemma3-4b"])
def test_smoke_cells_lower_with_rule_exact_arguments(arch, small_shapes):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), n_layers=1)
    if arch == "dbrx-132b":
        assert SH.tp_rules(cfg, SH.MeshShape({"data": 2, "model": 2}))[
            "experts"] == "model"
    for sname in shapes_for(cfg):
        rec = _lower(arch, sname, cfg)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["chips"] == 4 and rec["device_type"] == "cpu"
        assert rec["flops"] > 0 and rec["collective"]["total"] >= 0
        row = rec["roofline"]
        assert row["chips"] == 4 and row["hlo_flops"] == 4 * rec["flops"]
        assert row["useful_ratio"] == rec["model_flops"] / row["hlo_flops"]
        shape = SHAPES[sname]
        msh = SH.MeshShape({"data": 2, "model": 2})
        st = SH.state_bytes_per_device(cfg, shape, msh)
        want = (st["params"] + st["opt"] + 4      # + AdamW's int32 step
                if shape.kind == "train" else st["params"])
        # the batch (and a serve cell's cache) under the rules' layout
        bsh = SH.input_shardings(cfg, msh, shape)
        batch_bytes = sum(
            SH._shard_bytes(v.shape, SH._get(bsh, p).spec, msh)
            * v.element_size()
            for p, v in SH.leaves_with_paths(M.input_specs(cfg, shape)))
        assert rec["memory"]["argument_bytes"] - batch_bytes == want, \
            (arch, sname)


def test_extrapolation_equals_direct_count(small_shapes):
    cfg = dataclasses.replace(smoke_config(ARCHS["granite-8b"]), n_layers=6)
    rec = _lower("granite-8b", "decode_32k", cfg, extrapolate=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["extrap"]["flops_dev"] == rec["flops"]
    assert rec["extrap"]["bytes_dev"] == rec["bytes_accessed"]
    assert rec["extrap"]["probe_layers"] == [2, 4]


def test_lowering_never_leaks_its_process_group(small_shapes):
    rec = D.run_cell("granite-8b", "decode_32k", False, save=False,
                     extrapolate=False, device="cpu",
                     cfg_override=dataclasses.replace(
                         smoke_config(ARCHS["granite-8b"]), n_layers=1))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="boom"):
        with LM.fake_process_group(4):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_op_without_a_sharding_rule_fails_the_cell(small_shapes,
                                                    monkeypatch):
    """DTensor cannot run the MoE dispatch's index-add as the model
    writes it (torch 2.11 has no rule for it; torch 2.13 lays the
    buffer out so the reshape after it fails).  With the mesh hook that
    runs it on replicas taken away the cell is an error, never a record
    with the op quietly run some other way."""
    from repro_torch.distribution import layout as LAY
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(smoke_config(ARCHS["dbrx-132b"]), n_layers=1)
    assert _lower("dbrx-132b", "decode_32k", cfg)["status"] == "ok"
    monkeypatch.setattr(LAY.MeshLayout, "scatter_add",
                        L.Layout.scatter_add)
    rec = _lower("dbrx-132b", "decode_32k", cfg)
    assert rec["status"] == "error"
    assert "models/moe.py" in rec["traceback"], rec["traceback"]
