"""The port's training stack, held to the JAX package's.

Every comparison feeds both packages the same numpy data: parameter
trees from the JAX package's ``init_params`` (crossed with
``params_from_numpy``), gradients and batches drawn with numpy.

* AdamW, the cosine schedule and global-norm clipping agree within
  ``TOL_OPT`` (rtol 1e-6, atol 1e-8: float32 sums over leaves taken in
  another order; the first update has lr 0 and changes nothing).
* The int8 and top-k compressors and error feedback are bit-equal;
  ``fault.py``'s outputs and ``SyntheticLM``'s batches are equal.
* Checkpoint leaf names equal the reference's, a checkpoint either
  package writes restores into the other, and a step from it agrees.
* ``loss_fn`` and its grads agree with ``jax.value_and_grad`` on every
  token-input smoke arch within ``TOL_LOSS`` (rtol 1e-5) and, for the
  grads, rtol 1e-4 / atol 1e-4 x the leaf's max |grad| (float32 sums
  over the batch and the SSM scan taken in another order), with remat
  on and off and ``CE_CHUNKS`` 0 and 3.
* Five trainer steps agree with the JAX ``Trainer`` on every token-input
  smoke arch: losses within ``TOL_LOSS``, moments within ``MOMENT_TOL``
  (rtol, and atol x the leaf's max |x|), and params
  all within 2 x the sum of the steps' lrs (the most Adam moves an entry
  whose float32-noise grad flips its update) and all but 0.1 % of them
  within 1 % of that sum (``_assert_adam_close``); with int8
  compression a noise difference can also move a gradient entry across
  a rounding tie (one int8 step), so 1 % of them.

``tests/golden/torch_train_steps.json`` pins four JAX ``Trainer`` steps
of granite-8b at its published widths cut to 2 of 36 layers (weights
from ``draw_numpy_params(cfg, 0)``); ``tests/test_torch_gpu.py`` holds
the port on the card to it (``torch_card.train_mismatch``).  Regenerate
it deliberately with ``PYTHONPATH=src python tests/test_torch_training.py``
(a few minutes and ~25 GB of host memory); ``... --port-distance`` runs
the port on the CPU against it and prints each tolerance's worst share.
"""
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import smoke_config as ref_smoke
from repro.core.faults import VirtualClock as RefVirtualClock
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import model as RM
from repro.training import checkpoint as RCKPT
from repro.training import fault as RF
from repro.training import grad_compress as RGC
from repro.training import optimizer as ROPT
from repro.training import trainer as RT

from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.core.faults import VirtualClock
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as M
from repro_torch.models.convert import (draw_numpy_params, params_from_numpy,
                                        params_to_numpy)
from repro_torch.distribution import sharding as SH
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import fault as F
from repro_torch.training import grad_compress as GC
from repro_torch.training import optimizer as OPT
from repro_torch.training import trainer as T
import torch_card

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_train_steps.json"
TOKEN_ARCHS = [a for a in REF_ARCHS if REF_ARCHS[a].input_mode == "tokens"]
TOL_OPT = dict(rtol=1e-6, atol=1e-8)
TOL_LOSS = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-4
TRAIN_LR_SHARE, TRAIN_LOOSE_FRAC = 0.01, 1e-3
MOMENT_TOL = 1e-3       # after five steps: rtol and atol x max |x|
# The fixture's run (granite-8b widths, 2 layers) and its tolerances.
FIXTURE_RUN = dict(arch="granite-8b", n_layers=2, seed=0, batch=2, seq=64,
                   steps=4,
                   train=dict(lr=1e-3, warmup=2, total_steps=4,
                              microbatches=2, compression="int8",
                              remat=True),
                   tol=dict(loss_rel=2e-5, sum_rel=2e-4, param_lrs=2.0,
                            moment_rel=0.02))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors run fastest on one intra-op thread, and the
    suite's worker processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for mod in (M, RM):
        mod.REMAT_POLICY = "full"
        mod.CE_CHUNKS = 0


def _np_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f(16, 8), "ln_f": f(8),
            "blocks": {"wq": f(2, 8, 8), "ln1": f(2, 8),
                       "mlp": {"wi": f(2, 8, 12), "wo": f(2, 12, 8)}}}


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return params_from_numpy(tree, "cpu")


def _assert_trees_close(ref_tree, port_tree, **tol):
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, ref_tree))[0]
    got = OPT.tree_flatten_with_path(port_tree)
    assert len(want) == len(got)
    for (kp, w), (path, g) in zip(want, got):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, err_msg=str(path), **tol)


def _assert_adam_close(ref_tree, port_tree, lr_sum: float,
                       frac: float = TRAIN_LOOSE_FRAC):
    """Params after AdamW steps from the same start: every entry within
    2 x ``lr_sum`` (an entry whose grad is at float32 noise level, such
    as a key bias's, whose exact grad is 0, takes an update of either
    sign, each step's at most lr), and all but ``frac`` of all entries
    within ``TRAIN_LR_SHARE`` x ``lr_sum`` (Adam divides each grad by
    its own running size, so float32 noise in a small grad moves its
    update by a share of lr, not of the grad)."""
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))
    got = OPT.tree_flatten_with_path(port_tree)
    assert len(want) == len(got)
    loose = total = 0
    for w, (path, g) in zip(want, got):
        d = np.abs(g.detach().cpu().numpy().astype(np.float64) - w)
        assert d.max() <= 2 * lr_sum, ("/".join(path), d.max())
        loose += int((d > TRAIN_LR_SHARE * lr_sum).sum())
        total += d.size
    assert loose <= frac * total, (loose, total)


def _assert_close_of_max(ref_tree, port_tree, rtol=None, atol_of_max=None):
    """Each leaf within ``rtol`` and ``atol_of_max`` x its max |x|
    (default ``GRAD_RTOL`` / ``GRAD_ATOL_OF_MAX``: float32 sums over a
    batch taken in another order)."""
    rtol = GRAD_RTOL if rtol is None else rtol
    atol_of_max = GRAD_ATOL_OF_MAX if atol_of_max is None else atol_of_max
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))
    got = OPT.tree_flatten_with_path(port_tree)
    assert len(want) == len(got)
    for w, (path, g) in zip(want, got):
        g = np.zeros_like(w) if g is None else g.detach().cpu().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol,
            atol=atol_of_max * max(float(np.abs(w).max()), 1e-30),
            err_msg="/".join(path))


def _assert_trees_equal(ref_tree, port_tree):
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))
    got = [g.detach().cpu().numpy() for g in OPT.tree_leaves(port_tree)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert torch_card.bits_equal(np.asarray(w), g)


# ---------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 1e3])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_reference(max_norm, wd):
    tree = _np_tree(0)
    rp, pp = _ref(tree), _port(tree)
    ropt, popt = ROPT.adamw_init(rp), OPT.adamw_init(pp)
    for step in range(5):
        grads = _np_tree(10 + step)
        lr_r = ROPT.cosine_schedule(jnp.asarray(step, jnp.int32), 1e-2, 2, 5)
        lr_p = OPT.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                   1e-2, 2, 5)
        np.testing.assert_allclose(float(lr_p), float(lr_r), **TOL_OPT)
        rp, ropt = ROPT.adamw_update(rp, _ref(grads), ropt, lr=lr_r,
                                     weight_decay=wd, max_grad_norm=max_norm)
        pp, popt = OPT.adamw_update(pp, _port(grads), popt, lr=lr_p,
                                    weight_decay=wd, max_grad_norm=max_norm)
        if step == 0:        # lr 0 at step 0: the first update moves nothing
            _assert_trees_equal(_ref(tree), pp)
        _assert_trees_close((rp, ropt.m, ropt.v), (pp, popt.m, popt.v),
                            **TOL_OPT)
        assert int(popt.step) == int(ropt.step) == step + 1
        assert popt.step.dtype == torch.int32


def test_adamw_with_a_python_float_lr():
    tree = _np_tree(1)
    rp, ropt = ROPT.adamw_update(_ref(tree), _ref(_np_tree(2)),
                                 ROPT.adamw_init(_ref(tree)), lr=3e-2)
    pp, popt = OPT.adamw_update(_port(tree), _port(_np_tree(2)),
                                OPT.adamw_init(_port(tree)), lr=3e-2)
    _assert_trees_close((rp, ropt.m, ropt.v), (pp, popt.m, popt.v),
                        **TOL_OPT)


@pytest.mark.parametrize("base,warmup,total,min_frac", [
    (1e-3, 10, 100, 0.1), (3e-4, 100, 1000, 0.1), (1e-2, 1, 7, 0.0),
    (5e-3, 0, 50, 0.25)])
def test_cosine_schedule_matches_reference(base, warmup, total, min_frac):
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(ROPT.cosine_schedule(jnp.asarray(steps), base, warmup,
                                           total, min_frac))
    got = OPT.cosine_schedule(torch.from_numpy(steps), base, warmup, total,
                              min_frac).numpy()
    np.testing.assert_allclose(got, want, **TOL_OPT)
    assert got.dtype == np.float32
    if warmup:
        assert got[0] == 0.0


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e6])
def test_clip_and_global_norm_match_reference(max_norm):
    tree = _np_tree(3)
    rg, rn = ROPT.clip_by_global_norm(_ref(tree), max_norm)
    pg, pn = OPT.clip_by_global_norm(_port(tree), max_norm)
    np.testing.assert_allclose(float(pn), float(rn), **TOL_OPT)
    np.testing.assert_allclose(float(OPT.global_norm(_port(tree))),
                               float(ROPT.global_norm(_ref(tree))), **TOL_OPT)
    _assert_trees_close(rg, pg, **TOL_OPT)


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    opt = OPT.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt = OPT.adamw_update(params, g, opt, lr=5e-2,
                                       weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_cosine_schedule_shape():
    lrs = [float(OPT.cosine_schedule(s, 1e-3, 10, 100))
           for s in range(0, 100, 5)]
    assert lrs[0] < lrs[1]           # warmup
    assert lrs[-1] < max(lrs)        # decay
    assert min(lrs[2:]) >= 1e-4 - 1e-9


def test_tree_order_is_the_reference_order():
    tree = {"z": 1, "a": {"y": 2, "b": (3, 4)}, "m": [5]}
    assert OPT.tree_leaves(tree) == jax.tree.leaves(tree)
    back = OPT.tree_unflatten(tree, OPT.tree_leaves(tree))
    assert back == tree and list(back) == list(tree)


# ---------------------------------------------------------------------
# Gradient compression: bit-equal
# ---------------------------------------------------------------------

def _grad_cases():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, -127.0,
                     0.0], np.float32)
    return {
        "normal": rng.standard_normal((64, 33)).astype(np.float32),
        "tiny": (rng.standard_normal(500) * 1e-20).astype(np.float32),
        "zeros": np.zeros((7, 3), np.float32),
        "ties": ties,
        "ties_scaled": ties * np.float32(3e-3),
        "ints": rng.integers(-5, 6, (40, 10)).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(_grad_cases()))
def test_quantize_int8_bit_equal(case):
    g = _grad_cases()[case]
    rq, rs = RGC.quantize_int8(jnp.asarray(g))
    pq, ps = GC.quantize_int8(torch.from_numpy(g))
    assert torch_card.bits_equal(np.asarray(rq), pq.numpy())
    assert torch_card.bits_equal(np.asarray(rs), ps.numpy())
    assert torch_card.bits_equal(np.asarray(RGC.dequantize_int8(rq, rs)),
                                 GC.dequantize_int8(pq, ps).numpy())


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 1.0])
@pytest.mark.parametrize("case", ["normal", "ints", "ties"])
def test_topk_mask_bit_equal(case, frac):
    g = _grad_cases()[case]
    want = np.asarray(RGC.topk_mask(jnp.asarray(g), frac))
    got = GC.topk_mask(torch.from_numpy(g), frac).numpy()
    assert torch_card.bits_equal(want, got)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk", "int8+topk"])
def test_compress_decompress_and_error_feedback_bit_equal(scheme):
    cfg_r = RGC.CompressionConfig(scheme, topk_frac=0.1)
    cfg_p = GC.CompressionConfig(scheme, topk_frac=0.1)
    g = _grad_cases()["normal"]
    assert torch_card.bits_equal(
        np.asarray(RGC.compress_decompress(jnp.asarray(g), cfg_r)),
        GC.compress_decompress(torch.from_numpy(g), cfg_p).numpy())
    assert GC.compression_ratio(cfg_p) == RGC.compression_ratio(cfg_r)
    rerr = RGC.init_error_state(_ref(_np_tree(0)))
    perr = GC.init_error_state(_port(_np_tree(0)))
    for rnd in range(4):
        grads = _np_tree(20 + rnd)
        rsent, rerr = RGC.apply_with_error_feedback(_ref(grads), rerr, cfg_r)
        psent, perr = GC.apply_with_error_feedback(_port(grads), perr, cfg_p)
        _assert_trees_equal(rsent, psent)
        _assert_trees_equal(rerr, perr)


def test_grad_compression_error_feedback_converges():
    """int8+topk with error feedback still drives a quadratic to zero."""
    params = {"w": torch.linspace(-2, 2, 64)}
    opt = OPT.adamw_init(params)
    err = GC.init_error_state(params)
    cfg = GC.CompressionConfig("int8+topk", topk_frac=0.25)
    for _ in range(300):
        g = {"w": 2 * params["w"]}
        g, err = GC.apply_with_error_feedback(g, err, cfg)
        params, opt = OPT.adamw_update(params, g, opt, lr=3e-2,
                                       weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.15


def test_compression_is_lossy_but_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    out = GC.compress_decompress(g, GC.CompressionConfig("int8"))
    rel = float(torch.linalg.norm(out - g) / torch.linalg.norm(g))
    assert 0 < rel < 0.02


# ---------------------------------------------------------------------
# fault.py and the data pipeline: equal
# ---------------------------------------------------------------------

def _drill(mod, clock_cls):
    clock = clock_cls(0.0)
    mon = mod.HeartbeatMonitor(8, timeout_s=10.0, clock=clock)
    log = []
    for t, beats in ((8.0, [h for h in range(8) if h != 3]),
                     (16.0, [h for h in range(8) if h not in (3, 5)]),
                     (27.0, [0, 1, 2]), (40.0, [0])):
        clock.advance(t - clock.now())
        for h in beats:
            mon.beat(h)
        log.append((mon.sweep(), mon.alive_hosts))
    plans = []
    for dph, mp, gb in ((4, 4, 256), (8, 2, 100), (1, 1, 7), (2, 3, 64)):
        try:
            plans.append(dataclasses.asdict(mod.elastic_plan(
                mon.alive_hosts + [6, 7], dph, mp, gb, 120)))
        except RuntimeError as e:
            plans.append(str(e))
    try:
        mod.elastic_plan([0], 1, 4, 8, None)
    except RuntimeError as e:
        plans.append(str(e))
    return log, plans


def test_heartbeat_and_elastic_plan_equal_reference():
    want = _drill(RF, RefVirtualClock)
    assert _drill(F, VirtualClock) == want
    assert want[0][0] == ([], list(range(8)))


@pytest.mark.parametrize("pattern", ["periodic", "ramp", "noisy"])
def test_straggler_detector_equal_reference(pattern):
    rng = np.random.default_rng(1)
    dts = {"periodic": [1.0 if s % 13 else 5.0 for s in range(60)],
           "ramp": [1.0 + 0.2 * s for s in range(60)],
           "noisy": list(rng.exponential(1.0, 80))}[pattern]

    def run(mod):
        det = mod.StragglerDetector(window=16, threshold=2.0)
        flags = [det.observe(s, dt) for s, dt in enumerate(dts)]
        return flags, det.events, det.advice()

    want = run(RF)
    assert run(F) == want
    if pattern == "periodic":
        assert any(want[0]) and want[2] in ("transient", "persistent")


@pytest.mark.parametrize("vocab,seed", [(512, 0), (49152, 0), (1000, 3)])
def test_synthetic_batches_equal_reference(vocab, seed):
    ref, port = RefSyntheticLM(vocab, seed), SyntheticLM(vocab, seed)
    assert np.array_equal(ref.successors, port.successors)
    for step, b, s in ((0, 8, 32), (7, 2, 64), (123, 3, 5)):
        want = ref.batch(step, b, s)
        for st in (step, np.int64(step), torch.tensor(step)):
            got = port.batch(st, b, s)
            for k in ("tokens", "labels"):
                assert got[k].dtype == np.int32
                assert np.array_equal(got[k], want[k])


def test_prefetcher_delivers_batches_in_order():
    src = SyntheticLM(512, seed=0)
    pf = Prefetcher(src, 4, 16, start_step=5, device="cpu")
    try:
        for step in range(5, 9):
            b = next(pf)
            assert isinstance(b["tokens"], torch.Tensor)
            assert np.array_equal(b["tokens"].numpy(),
                                  src.batch(step, 4, 16)["tokens"])
    finally:
        pf.close()
    # sharding=: each batch placed with distribute_tensor on a 1-rank mesh
    with _one_rank_mesh() as mesh:
        rep = (mesh, [Replicate()])
        pf = Prefetcher(src, 4, 16, sharding={"tokens": rep, "labels": rep},
                        start_step=2)
        try:
            b = next(pf)
            assert isinstance(b["tokens"], DTensor)
            assert np.array_equal(b["tokens"].full_tensor().numpy(),
                                  src.batch(2, 4, 16)["tokens"])
        finally:
            pf.close()


@contextlib.contextmanager
def _one_rank_mesh():
    """A 1-rank gloo process group and its ("data",) ``DeviceMesh``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield DeviceMesh("cpu", [0], mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------

def _smoke_params(arch: str):
    """(ref cfg, port cfg, JAX params, the same as numpy arrays)."""
    rcfg, cfg = ref_smoke(REF_ARCHS[arch]), smoke_config(ARCHS[arch])
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, jax.tree.map(np.asarray, rp)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "mamba2-130m",
                                  "internvl2-26b"])
def test_checkpoint_leaf_names_equal_reference(arch):
    _rcfg, _cfg, rp, nparams = _smoke_params(arch)
    pp = _port(nparams)
    want = RCKPT._leaf_paths((rp, ROPT.adamw_init(rp)))
    got = CKPT._leaf_paths((pp, OPT.adamw_init(pp)))
    assert got == want
    assert "0__embed" in got and "1__.step" in got
    assert got.index("1__.step") < got.index(
        "1__.m__embed") < got.index("1__.v__embed")


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}
    CKPT.save(tmp_path, 7, tree, extra={"note": "x"})
    CKPT.save(tmp_path, 9, tree)
    assert CKPT.latest_step(tmp_path) == 9
    restored, manifest = CKPT.restore(tmp_path, tree, step=7)
    assert manifest["extra"]["note"] == "x"
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32
    assert not list(tmp_path.glob("*.tmp"))
    # elastic restore onto a sharded layout (a 1-rank mesh), as the JAX
    # package's test_elastic_restore_across_mesh
    with _one_rank_mesh() as mesh:
        sh = {"a": (mesh, [Shard(0)]), "b": {"c": (mesh, [Replicate()])}}
        sharded, _ = CKPT.restore(tmp_path, tree, step=7, shardings=sh)
        assert isinstance(sharded["a"], DTensor)
        assert sharded["a"].placements == (Shard(0),)
        assert torch.equal(sharded["a"].full_tensor(), tree["a"])
        assert torch.equal(sharded["b"]["c"].full_tensor(), tree["b"]["c"])
    with pytest.raises(ValueError, match="ckpt"):
        CKPT.restore(tmp_path, dict(tree, a=torch.zeros(4, 3)), step=7)


def test_async_checkpointer_gc_and_snapshot(tmp_path):
    ck = CKPT.AsyncCheckpointer(tmp_path, keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
        tree["w"].add_(1.0)          # the snapshot is a copy
    ck.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    restored, _ = CKPT.restore(tmp_path, tree, step=3)
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def _ref_trainer(rcfg, rp, ckpt_dir, **kw):
    tcfg = RT.TrainConfig(ckpt_dir=str(ckpt_dir), **kw)
    return RT.Trainer(rcfg, tcfg, params=rp)


def _np_batches(cfg, start, b=4, s=16):
    """``SyntheticLM`` batches from ``start`` on (with seeded patches for
    a prefix-patch model) as numpy arrays."""
    src = SyntheticLM(cfg.vocab, seed=0)
    step = start
    while True:
        batch = src.batch(step, b, s)
        if cfg.prefix_patches:
            batch["patches"] = (np.random.default_rng(step).standard_normal(
                (b, cfg.prefix_patches, cfg.d_model)) * 0.1).astype(
                    np.float32)
        yield batch
        step += 1


def _ref_batches(cfg, start, b=4, s=16):
    for batch in _np_batches(cfg, start, b, s):
        yield {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batches(cfg, start, b=4, s=16):
    yield from _np_batches(cfg, start, b, s)


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
    rcfg, cfg, rp, nparams = _smoke_params("granite-8b")
    kw = dict(lr=3e-3, warmup=1, total_steps=10, microbatches=2,
              ckpt_every=3, remat=True)
    rt = _ref_trainer(rcfg, rp, tmp_path / "jax", **kw)
    rt.train(_ref_batches(cfg, 0), 3, log_every=1000)
    pt = T.Trainer(cfg, T.TrainConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                   params=_port(nparams))
    assert pt.restore_latest() and pt.step == 3
    _assert_trees_equal((rt.params, rt.opt), (pt.params, pt.opt))
    rh = rt.train(_ref_batches(cfg, 3), 1, log_every=1000)
    ph = pt.train(_port_batches(cfg, 3), 1, log_every=1000)
    np.testing.assert_allclose(ph[-1]["loss"], rh[-1]["loss"], **TOL_LOSS)
    _assert_adam_close(rt.params, pt.params,
                       float(OPT.cosine_schedule(3, 3e-3, 1, 10)))
    # and back: the port's checkpoint restores into the JAX package
    CKPT.save(tmp_path / "port", pt.step, (pt.params, pt.opt))
    (back, _bopt), manifest = RCKPT.restore(tmp_path / "port",
                                            (rt.params, rt.opt))
    assert manifest["step"] == 4
    _assert_trees_equal(back, pt.params)


# ---------------------------------------------------------------------
# The loss and its grads; remat and chunked cross-entropy
# ---------------------------------------------------------------------

def _train_batch(rcfg, b=2, s=16, seed=0):
    toks = s - rcfg.prefix_patches
    batch = SyntheticLM(rcfg.vocab, seed=seed).batch(seed, b, toks)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :3] = -1               # masked positions
    if rcfg.prefix_patches:
        batch["patches"] = (np.random.default_rng(seed).standard_normal(
            (b, rcfg.prefix_patches, rcfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _loss_and_grads_agree(arch, remat=True):
    rcfg, cfg, rp, nparams = _smoke_params(arch)
    batch = _train_batch(rcfg)
    (rl, rmet), rg = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                             remat=remat), has_aux=True)(rp)
    pp = _port(nparams)
    leaves = OPT.tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    pl, pmet = M.loss_fn(cfg, pp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, remat=remat)
    pg = OPT.tree_unflatten(pp, torch.autograd.grad(pl, leaves,
                                                    allow_unused=True))
    np.testing.assert_allclose(float(pl.detach()), float(rl), **TOL_LOSS)
    np.testing.assert_allclose(float(pmet["loss"].detach()),
                               float(rmet["loss"]),
                               **TOL_LOSS)
    np.testing.assert_allclose(float(pmet["aux"].detach()),
                               float(rmet["aux"]),
                               rtol=1e-5, atol=1e-7)
    _assert_close_of_max(rg, pg)
    return float(pl.detach())


@pytest.mark.parametrize("chunks", [0, 3])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_variants_match_reference_on_granite(remat, chunks):
    M.CE_CHUNKS = RM.CE_CHUNKS = chunks
    if not remat:
        M.REMAT_POLICY = RM.REMAT_POLICY = "none"
    _loss_and_grads_agree("granite-8b", remat=remat)


@pytest.mark.parametrize("policy", ["dots", "moe-save", "tp-save"])
def test_distribution_only_policies_and_specs_raise(policy):
    """The dry-run's selective remat policies: the loss and every grad
    are bit-equal to ``"full"`` on the port and hold to the JAX package
    under the same policy; ``param_logical`` / ``param_specs`` /
    ``input_specs`` have the reference's trees (``tests/
    test_torch_distribution.py`` checks them at every arch)."""
    arch = "granite-moe-3b-a800m" if policy == "moe-save" else "granite-8b"
    rcfg, cfg, _rp, nparams = _smoke_params(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             _train_batch(rcfg).items()}

    def loss_and_grads():
        pp = _port(nparams)
        leaves = OPT.tree_leaves(pp)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = M.loss_fn(cfg, pp, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)

    full_loss, full_grads = loss_and_grads()
    M.REMAT_POLICY = policy
    loss, grads = loss_and_grads()
    assert torch.equal(loss, full_loss)
    for g, h in zip(grads, full_grads):
        assert (g is None and h is None) or torch.equal(g, h)
    RM.REMAT_POLICY = policy
    _loss_and_grads_agree(arch)
    assert [p for p, _ in SH.leaves_with_paths(M.param_specs(cfg))] == \
        [tuple(k.key for k in p) for p, _ in
         jax.tree_util.tree_flatten_with_path(RM.param_specs(rcfg))[0]]
    assert set(M.input_specs(cfg, SHAPES["decode_32k"])) == set(
        RM.input_specs(rcfg, REF_SHAPES["decode_32k"]))


def test_serving_forward_is_unchanged_by_remat():
    _rcfg, cfg, _rp, nparams = _smoke_params("granite-8b")
    pp = _port(nparams)
    toks = {"tokens": torch.from_numpy(_train_batch(_rcfg)["tokens"])}
    with torch.no_grad():
        want, _ = M.forward(cfg, pp, toks, remat=False)
    got, _ = M.forward(cfg, pp, toks, remat=True)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------

def _five_steps(arch, compression):
    rcfg, cfg, rp, nparams = _smoke_params(arch)
    kw = dict(lr=3e-3, warmup=2, total_steps=5, microbatches=2,
              ckpt_every=1000, remat=True)
    with tempfile.TemporaryDirectory() as d:
        rt = RT.Trainer(rcfg, RT.TrainConfig(
            compression=RGC.CompressionConfig(compression), ckpt_dir=d,
            **kw), params=rp)
        rh = rt.train(_ref_batches(cfg, 0), 5, log_every=1000)
        pt = T.Trainer(cfg, T.TrainConfig(
            compression=GC.CompressionConfig(compression), ckpt_dir=d,
            **kw), params=_port(nparams))
        ph = pt.train(_port_batches(cfg, 0), 5, log_every=1000)
    lr_sum = sum(float(OPT.cosine_schedule(s, 3e-3, 2, 5)) for s in range(5))
    return rt, rh, pt, ph, lr_sum


def test_trainer_with_int8_compression_within_the_adam_bound():
    rt, rh, pt, ph, lr_sum = _five_steps("granite-8b", "int8")
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in rh], **TOL_LOSS)
    _assert_adam_close(rt.params, pt.params, lr_sum, frac=0.01)


def test_trainer_loss_decreases_and_restarts(tmp_path):
    cfg = smoke_config(ARCHS["granite-8b"])
    tcfg = T.TrainConfig(lr=3e-3, warmup=5, total_steps=60, microbatches=2,
                         ckpt_every=25, ckpt_dir=str(tmp_path), remat=False)
    trainer = T.Trainer(cfg, tcfg, device="cpu")
    hist = trainer.train(_port_batches(cfg, 0, 8, 32), steps=50,
                         log_every=1000)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    trainer.ckpt.wait()
    t2 = T.Trainer(cfg, tcfg, device="cpu")
    assert t2.restore_latest()
    assert t2.step == 50
    _assert_trees_equal(params_to_numpy(trainer.params), t2.params)


def test_trainer_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = smoke_config(ARCHS["granite-8b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Trainer(cfg, T.TrainConfig())


def test_train_launcher_drill(tmp_path, capsys):
    train_launcher.main(["--smoke", "--steps", "10", "--microbatches", "2",
                         "--compression", "int8", "--simulate-failure",
                         "--ckpt-dir", str(tmp_path), "--device", "cpu",
                         "--batch", "4", "--seq", "16"])
    out = capsys.readouterr().out
    assert "dead hosts [2]; survivor plan: dp=3 batch-=1 restore@5" in out
    assert "restored at step 5; continuing" in out
    done = [ln for ln in out.splitlines() if ln.startswith("done:")]
    assert done and done[0].startswith("done: step=10 final_loss=")
    assert math.isfinite(float(done[0].split("final_loss=")[1]))


def test_train_small_example_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_small.py"),
         "--steps", "12", "--device", "cpu"], capture_output=True,
        text=True, timeout=120, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")).stdout
    assert "== checkpoint/restart drill at step 6 ==" in out
    assert "restored step 6; continuing to 12" in out


# ---------------------------------------------------------------------
# The fixture and its procedure
# ---------------------------------------------------------------------

def _ref_train_run(run: dict, rcfg, rparams) -> dict:
    """The fixture's procedure on the JAX package: the mirror of
    ``torch_card.port_train_run``."""
    tr = dict(run["train"])
    with tempfile.TemporaryDirectory() as d:
        tcfg = RT.TrainConfig(
            compression=RGC.CompressionConfig(tr.pop("compression")),
            ckpt_every=1 << 30, ckpt_dir=d, **tr)
        trainer = RT.Trainer(rcfg, tcfg, params=rparams)
        hist = trainer.train(_ref_batches(rcfg, 0, run["batch"],
                                          run["seq"]),
                             run["steps"], log_every=1 << 30)
    state = (trainer.params, trainer.opt)
    named = [(n, np.asarray(leaf)) for n, leaf in
             zip(RCKPT._leaf_paths(state), jax.tree.leaves(state))
             if not n.endswith(".step")]
    lrs = [float(ROPT.cosine_schedule(jnp.asarray(s, jnp.int32), tcfg.lr,
                                      tcfg.warmup, tcfg.total_steps))
           for s in range(run["steps"])]
    return dict(losses=[h["loss"] for h in hist], lrs=lrs,
                leaves=torch_card.train_state_records(named))


def test_fixture_procedure_at_smoke_size():
    rcfg, cfg, rp, nparams = _smoke_params("granite-8b")
    run = dict(FIXTURE_RUN, batch=4, seq=16)
    fx = dict(run, records=_ref_train_run(run, rcfg, rp))
    got = torch_card.port_train_run(fx, cfg, _port(nparams), "cpu")
    msg, worst = torch_card.train_mismatch(fx, got)
    assert msg is None, msg
    assert all(0 <= v <= 1 for v in worst.values())
    # and the comparison catches a wrong run
    bad = json.loads(json.dumps(got))
    bad["losses"][-1] *= 1.001
    assert torch_card.train_mismatch(fx, bad)[0].startswith("step 4 loss")


def test_train_fixture_is_well_formed():
    fx = json.loads(FIXTURE.read_text())
    assert {k: fx[k] for k in FIXTURE_RUN} == FIXTURE_RUN
    cfg = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == (4096, 32, 8, 14336, 49152)
    rec = fx["records"]
    assert len(rec["losses"]) == len(rec["lrs"]) == fx["steps"] == 4
    assert rec["lrs"][0] == 0.0
    assert all(math.isfinite(x) for x in rec["losses"])
    # granite-8b's tree (the smoke config has the same leaves)
    small = dataclasses.replace(smoke_config(ARCHS["granite-8b"]),
                                n_layers=2)
    pp = M.init_params(small, device="cpu")
    names = [n for n in CKPT._leaf_paths((pp, OPT.adamw_init(pp)))
             if n != "1__.step"]
    assert sorted(rec["leaves"]) == sorted(names)
    for leaf in rec["leaves"].values():
        assert len(leaf["idx"]) == len(leaf["val"]) == 64


def _fixture() -> dict:
    """The full-width fixture, computed by the JAX package's Trainer."""
    rcfg = dataclasses.replace(REF_ARCHS["granite-8b"],
                               n_layers=FIXTURE_RUN["n_layers"])
    cfg = dataclasses.replace(ARCHS["granite-8b"],
                              n_layers=FIXTURE_RUN["n_layers"])
    tree = draw_numpy_params(cfg, FIXTURE_RUN["seed"])
    rparams = jax.tree.map(jnp.asarray, tree)
    del tree
    return dict(FIXTURE_RUN, records=_ref_train_run(FIXTURE_RUN, rcfg,
                                                    rparams))


def _port_distance() -> dict:
    """The port on the CPU against the committed fixture: the shares of
    each tolerance that ``torch_card.train_mismatch`` reports."""
    fx = json.loads(FIXTURE.read_text())
    cfg = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    params = params_from_numpy(draw_numpy_params(cfg, fx["seed"]), "cpu")
    got = torch_card.port_train_run(fx, cfg, params, "cpu")
    msg, worst = torch_card.train_mismatch(fx, got)
    return dict(mismatch=msg, worst_share_of_limit=worst,
                losses=got["losses"], fixture_losses=fx["records"]["losses"])


if __name__ == "__main__":
    if sys.argv[1:] == ["--port-distance"]:     # the port on the CPU
        print(json.dumps(_port_distance(), indent=1))
    else:                                       # regenerate the fixture
        FIXTURE.write_text(json.dumps(_fixture(), indent=1, sort_keys=True))
        print(f"wrote {FIXTURE}")
