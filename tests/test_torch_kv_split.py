"""Tensor-parallel and KV page-split serving of the PyTorch port against the
JAX package, on the CPU (float32).

The JAX side runs on the 8-device CPU mesh that ``conftest.py`` sets up,
with the Pallas kernels in interpret mode; the port's mesh puts every shard
on the CPU (``["cpu"] * n``), where the kernels' wrappers run their plain
versions. Inputs are made with numpy from a seed and fed to both. Checked:
the mesh plan, each shard's params against ``param_shardings``' device
slices, the partial kernels' plain versions against the Pallas partial
kernel and the XLA ``_partial_flash`` (2e-5), the page-split write, the
merged attention (1e-5), the forward on model=2 x seq=2 and model=2 x
seq=1 (2e-4), and greedy engine streams on both meshes.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu.parallel import kv_split as jkv
from runbookai_tpu.parallel.mesh import MODEL_AXIS as JMODEL
from runbookai_tpu.parallel.mesh import SEQ_AXIS as JSEQ
from runbookai_tpu.parallel.mesh import build_mesh as jbuild_mesh
from runbookai_tpu.parallel.sharding import kv_pool_sharding, param_shardings
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.kv_cache import PagePool
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.quant import quantize_params
from runbookai_tpu_torch.ops import paged_attention as tpa
from runbookai_tpu_torch.parallel import kv_split as tkv
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import shard_params
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

from test_torch_engine import SCENARIOS, _run

ROOT = Path(__file__).resolve().parent.parent
NAME = "llama3-test"
CFG = tllama.CONFIGS[NAME]
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)  # test_sharded_engine.py
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
PS, N_KV, HD = 4, 2, 16
NUM_PAGES, MAX_PAGES = 16, 8  # + 1 trash column


def _t(x):
    return torch.from_numpy(np.array(x))


def _meshes(model, seq):
    """(JAX mesh on the virtual CPU devices, the port's mesh on the CPU)."""
    return (jbuild_mesh(1, model=model, seq=seq),
            build_mesh(model, seq, ["cpu"] * (model * seq)))


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS[NAME],
                                 dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _shard(tparams, mesh):
    """``shard_params`` on a copy of the dicts (it consumes its input)."""
    return shard_params({**tparams, "layers": dict(tparams["layers"])}, CFG, mesh)


# ------------------------------------------------------------------- plan


def test_plan_matches_jax():
    class Cfg:
        pass

    for n_heads, n_kv in ((4, 2), (32, 8), (64, 8), (28, 4), (24, 8), (8, 8)):
        for tp in (0, 1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 128, 256):
            cfg = Cfg()
            cfg.n_heads, cfg.n_kv_heads = n_heads, n_kv
            try:
                want = jkv.plan_kv_split(cfg, tp)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tkv.plan_kv_split(cfg, tp)
                assert str(got.value) == str(e)
                continue
            got = tkv.plan_kv_split(cfg, tp)
            assert (got.tp, got.kv_shards, got.pg_shards, got.pg_shards > 1) == \
                (want.tp, want.kv_shards, want.pg_shards, want.split)


def test_build_mesh_counts_cards_unless_given_devices():
    mesh = build_mesh(2, 2, ["cpu"] * 4)
    assert (mesh.tp, mesh.rank(1, 0), mesh.coords(3)) == (4, 2, (1, 1))
    with pytest.raises(ValueError):
        build_mesh(2, 2, ["cpu"] * 3)
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="CUDA devices"):
            build_mesh(2, 2)


# --------------------------------------------------------------- sharding


@pytest.mark.parametrize("model,seq", [(2, 2), (2, 1), (3, 1)])
def test_shards_equal_jax_device_slices(weights, model, seq):
    """Shard (m, s) holds what ``param_shardings`` places on the device at
    mesh coordinates (seq s, model m): model-major TP ranks, ``wk``/``wv``
    over ``model`` only, and the replicate branches (vocab 262 and, on a
    model=3 mesh, every head and FFN leaf)."""
    jparams, tparams = weights
    jmesh, tmesh = _meshes(model, seq)
    sharded = jax.tree.map(jax.device_put, jparams, param_shardings(jllama.CONFIGS[NAME], jmesh))
    shards = _shard(tparams, tmesh)
    coords = {d: (int(s), int(m)) for (_, _, s, m), d in np.ndenumerate(jmesh.devices)}

    def check(jleaf, leaf_of):
        for piece in jleaf.addressable_shards:
            s, m = coords[piece.device]
            got = leaf_of(shards[tmesh.rank(m, s)]).numpy()
            np.testing.assert_array_equal(got, np.asarray(piece.data))

    for name, jleaf in sharded["layers"].items():
        check(jleaf, lambda sh: sh["layers"][name])
    for name in ("embed", "lm_head", "final_norm"):
        check(sharded[name], lambda sh: sh[name])
    # The TP-split leaves concatenate back to the full params in rank order.
    for name, dim in (("wq", 2), ("wo", 1), ("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        whole = torch.cat([sh["layers"][name] for sh in shards], dim=dim)
        if CFG.n_heads % tmesh.tp == 0 and CFG.ffn_dim % tmesh.tp == 0:
            np.testing.assert_array_equal(whole.numpy(), np.asarray(jparams["layers"][name]))


def test_shard_params_consumes_the_full_params(weights):
    _, tparams = weights
    full = {**tparams, "layers": dict(tparams["layers"])}
    shards = shard_params(full, CFG, build_mesh(2, 2, ["cpu"] * 4))
    assert full == {} and len(shards) == 4
    assert shards[0]["layers"]["wk"] is shards[1]["layers"]["wk"]  # one device, one slice
    assert shards[0]["layers"]["wk"] is not shards[2]["layers"]["wk"]


def test_pool_shards_like_kv_pool_sharding():
    jmesh, tmesh = _meshes(2, 2)
    pool = PagePool.create(CFG.n_layers, NUM_PAGES, PS, CFG.n_kv_heads, CFG.head_dim,
                           torch.float32, device="cpu", mesh=tmesh)
    shape = (CFG.n_layers, NUM_PAGES * PS, CFG.n_kv_heads, CFG.head_dim)
    jpool = jax.device_put(jnp.zeros(shape), kv_pool_sharding(jllama.CONFIGS[NAME], jmesh))
    assert [tuple(k.shape) for k in pool.kv_k] == \
        [piece.data.shape for piece in jpool.addressable_shards]
    with pytest.raises(ValueError, match="divide"):
        PagePool.create(1, 63, PS, N_KV, HD, torch.float32, device="cpu", mesh=tmesh)


# ------------------------------------------------------- partial kernels


def _split_tables(rng, ctx_lens, pg):
    """Tables over the whole pool. Sequence 1 keeps every page on the last
    shard (the other shards own none of its pages); the others draw pages
    from all shards. Entries past ctx are random pages; trash column 0."""
    local = NUM_PAGES // pg
    tables = np.zeros((len(ctx_lens), MAX_PAGES + 1), np.int32)
    free = list(rng.permutation(np.arange(1, NUM_PAGES - local)))
    last = list(rng.permutation(np.arange(NUM_PAGES - local, NUM_PAGES)))
    for i, ctx in enumerate(ctx_lens):
        need = -(-ctx // PS)
        src = last if i == 1 else free
        tables[i, :need] = [src.pop() for _ in range(need)]
        tables[i, need:MAX_PAGES] = rng.integers(1, NUM_PAGES, MAX_PAGES - need)
    return tables


def _pools(rng):
    return [rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("pg", [2, 4])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_decode_partial_matches_pallas(group, pg):
    """ctx 0, 1, a page boundary and two pages; sequence 1 lies on the last
    shard only, so the other shards return (0, -1e30, 0) for it."""
    rng = np.random.default_rng(10 * group + pg)
    ctx = np.asarray([0, 2 * PS + 3, PS, 1, 2 * PS], np.int32)
    k, v = _pools(rng)
    tables = _split_tables(rng, ctx, pg)
    q = rng.normal(size=(len(ctx), N_KV * group, HD)).astype(np.float32)
    tokens_local = NUM_PAGES // pg * PS
    for shard in range(pg):
        sl = slice(shard * tokens_local, (shard + 1) * tokens_local)
        want = jpallas.paged_decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]), jnp.asarray(tables),
            jnp.asarray(ctx), jnp.int32(shard), page_size=PS,
            pages_local=NUM_PAGES // pg, interpret=True)
        got = tpa.paged_decode_attention_partial(
            _t(q), _t(k[sl]), _t(v[sl]), _t(tables), _t(ctx), shard, PS, NUM_PAGES // pg)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        if shard < pg - 1:
            assert float(got[2][1].abs().max()) == 0
            assert float(got[1][1].max()) == float(np.float32(-1e30))
        assert float(got[0][0].abs().max()) == 0  # ctx 0


def test_plain_chunk_partial_matches_partial_flash():
    """The T > 1 partial against the XLA ``_partial_flash`` it replaces, run
    per page shard under ``shard_map`` (it reads the shard index there)."""
    rng = np.random.default_rng(7)
    pg, t, group = 2, 5, 2
    ctx = np.asarray([t, 2 * PS + 5, PS + 1, 3 * PS], np.int32)
    k, v = _pools(rng)
    tables = _split_tables(rng, ctx, pg)
    q = rng.normal(size=(len(ctx), t, N_KV * group, HD)).astype(np.float32)
    qpos = (ctx[:, None] - t + np.arange(t)).astype(np.int32)
    jmesh = jbuild_mesh(1, model=1, seq=pg)
    local = NUM_PAGES // pg

    def per_shard(q_, k_, v_, tab, c, qp):
        m, l, acc = jkv._partial_flash(q_, k_, v_, tab, c, qp, page_size=PS,
                                       block_pages=4, pages_local=local,
                                       my_pg=jax.lax.axis_index(JSEQ))
        return m[None], l[None], acc[None]

    rep = P()
    want_m, want_l, want_acc = jax.shard_map(
        per_shard, mesh=jmesh, in_specs=(rep, P(JSEQ), P(JSEQ), rep, rep, rep),
        out_specs=(P(JSEQ), P(JSEQ), P(JSEQ)), check_vma=False)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(qpos))
    b = len(ctx)
    for shard, (kk, vv) in enumerate(zip(_t(k).chunk(pg), _t(v).chunk(pg))):
        acc, m, l = tpa.paged_chunk_attention_partial(
            _t(q), kk, vv, _t(tables), _t(ctx), _t(qpos), shard, PS, local)
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc[shard]).reshape(
            b, t, -1, HD), **TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(want_m[shard]).reshape(b, t, -1),
                                   **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(want_l[shard]).reshape(b, t, -1),
                                   **TOL)


# ------------------------------------------------------- write and merge


def _local_slices(pool, mesh, num_pages=NUM_PAGES):
    """Shard (m, s)'s [tokens / seq, n_kv / model, hd] slice of a global pool."""
    tokens = num_pages * PS // mesh.seq
    nkv = pool.shape[1] // mesh.model
    return [pool[s * tokens:(s + 1) * tokens, m * nkv:(m + 1) * nkv].clone()
            for m, s in map(mesh.coords, range(mesh.tp))]


def _assemble(slices, mesh):
    rows = [torch.cat([slices[mesh.rank(m, s)] for m in range(mesh.model)], dim=1)
            for s in range(mesh.seq)]
    return torch.cat(rows, dim=0)


@pytest.mark.parametrize("case", ["foreign_slot", "batch"])
def test_split_write_matches_jax(case):
    """Each shard keeps only the writes to its own pages. ``foreign_slot``:
    page 1 lies on shard 0, so on shard 1 the destination is negative and
    must not wrap into its mirror slot (test_sharded_engine.py)."""
    rng = np.random.default_rng(3)
    jmesh, tmesh = _meshes(2, 2)
    pool = np.zeros((NUM_PAGES * PS, N_KV, HD), np.float32)
    if case == "foreign_slot":
        new = np.ones((1, 2, N_KV, HD), np.float32)
        pos = np.asarray([[0, 1]], np.int32)
        tables = np.asarray([[1, 0, 0, 0]], np.int32)
    else:
        new = rng.normal(size=(3, 6, N_KV, HD)).astype(np.float32)
        tables = _split_tables(rng, [6, 9, 2], 2)
        trash = MAX_PAGES * PS
        pos = np.asarray([np.arange(6), np.arange(3, 9), [0, 1] + [trash] * 4], np.int32)
    want = np.asarray(jkv.write_kv_pages_batch_kv_split(
        jmesh, jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pos),
        jnp.asarray(tables), PS))
    slices = _local_slices(_t(pool), tmesh)
    nkv = N_KV // tmesh.model
    for r, kv in enumerate(slices):
        m, s = tmesh.coords(r)
        dests = tkv.split_destinations(_t(pos), _t(tables), PS, s, kv.shape[0])
        out = tkv.write_rows(kv, _t(new[:, :, m * nkv:(m + 1) * nkv]), *dests)
        assert out is kv  # in place
    got = _assemble(slices, tmesh).numpy()
    # Page 0 takes the duplicate pad writes (never read); the rest is exact.
    np.testing.assert_array_equal(got[PS:], want[PS:])
    if case == "foreign_slot":
        np.testing.assert_array_equal(got, want)
        assert float(np.abs(got[NUM_PAGES * PS // 2:]).max()) == 0.0


def test_merge_of_unseen_rows_is_zero():
    acc = torch.zeros(2, 3, 4)
    m, l = torch.full((2, 3), -1e30), torch.zeros(2, 3)
    seen = (torch.ones(2, 3, 4), torch.zeros(2, 3), torch.ones(2, 3))
    out = tkv.merge_partials([(acc, m, l), (acc, m, l)], torch.device("cpu"))
    assert torch.equal(out, torch.zeros(2, 3, 4))
    out = tkv.merge_partials([(acc, m, l), seen], torch.device("cpu"))
    assert torch.equal(out, torch.ones(2, 3, 4))


def test_merged_attention_matches_jax_kv_split():
    """Decode: the merged partials against ``paged_decode_attention_kv_split_pallas``
    (Pallas partial kernel, interpret mode) at 1e-5. T > 1: against the XLA
    ``paged_attention_kv_split`` on contiguous query positions."""
    rng = np.random.default_rng(5)
    jmesh, tmesh = _meshes(2, 2)
    n_q = 4 * N_KV  # group 4: two query heads per seq shard
    ctx = np.asarray([9, 17, 0, PS], np.int32)
    k, v = _pools(rng)
    tables = _split_tables(rng, ctx, 2)
    q = rng.normal(size=(len(ctx), n_q, HD)).astype(np.float32)
    want = np.asarray(jkv.paged_decode_attention_kv_split_pallas(
        jmesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), page_size=PS, interpret=True))
    ks, vs = _local_slices(_t(k), tmesh), _local_slices(_t(v), tmesh)
    nql = n_q // tmesh.tp
    rep = [_t(tables)] * 4, [_t(ctx)] * 4
    got = tkv.paged_decode_attention_kv_split(
        tmesh, [_t(q[:, r * nql:(r + 1) * nql]) for r in range(4)], ks, vs, *rep, PS)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want, **MERGE_TOL)
    assert float(np.abs(want[2]).max()) == 0  # ctx 0 -> zeros

    t = 4
    ctx = np.maximum(ctx, t)
    qc = rng.normal(size=(len(ctx), t, n_q, HD)).astype(np.float32)
    qpos = (ctx[:, None] - t + np.arange(t)).astype(np.int32)
    want = np.asarray(jkv.paged_attention_kv_split(
        jmesh, jnp.asarray(qc), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(qpos), page_size=PS, block_pages=4))
    got = tkv.paged_attention_kv_split(
        tmesh, [_t(qc[:, :, r * nql:(r + 1) * nql]) for r in range(4)], ks, vs,
        [_t(tables)] * 4, [_t(ctx)] * 4, [_t(qpos)] * 4, PS)
    np.testing.assert_allclose(torch.cat(got, dim=2).numpy(), want, **MERGE_TOL)


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("model,seq", [(2, 2), (2, 1)])
def test_forward_matches_jax_on_mesh(weights, model, seq):
    """A prefill chunk, a decode step and a T=4 verify over pools whose
    pages lie on both page shards, against JAX ``forward_impl`` on the same
    mesh with ``attn_impl="pallas"``, at 2e-4."""
    jparams, tparams = weights
    jcfg = jllama.CONFIGS[NAME]
    jmesh, tmesh = _meshes(model, seq)
    jsharded = jax.tree.map(jax.device_put, jparams, param_shardings(jcfg, jmesh))
    shards = _shard(tparams, tmesh)
    num_pages, max_pages = 16, 8
    shape = (CFG.n_layers, num_pages * PS, CFG.n_kv_heads, CFG.head_dim)
    jk = jax.device_put(jnp.zeros(shape), kv_pool_sharding(jcfg, jmesh))
    jv = jax.device_put(jnp.zeros(shape), kv_pool_sharding(jcfg, jmesh))
    pool = PagePool.create(*shape[:1], num_pages, PS, CFG.n_kv_heads, CFG.head_dim,
                           torch.float32, device="cpu", mesh=tmesh)
    tables = np.zeros((2, max_pages + 1), np.int32)
    tables[0, :5] = [9, 2, 12, 3, 15]
    tables[1, :5] = [4, 11, 5, 13, 6]
    rng = np.random.default_rng(1)
    trash = max_pages * PS
    steps = []
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 8))
    pos = np.asarray([np.arange(8), list(range(5)) + [trash] * 3], np.int32)
    steps.append((prompt, pos, np.asarray([8, 5], np.int32)))
    steps.append((rng.integers(0, CFG.vocab_size, size=(2, 1)),
                  np.asarray([[8], [5]], np.int32), np.asarray([9, 6], np.int32)))
    steps.append((rng.integers(0, CFG.vocab_size, size=(2, 4)),
                  np.asarray([np.arange(9, 13), np.arange(6, 10)], np.int32),
                  np.asarray([13, 10], np.int32)))
    for tokens, p, c in steps:
        want, jk, jv = jllama.forward_impl(
            jsharded, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(p), jk, jv,
            jnp.asarray(tables), jnp.asarray(c), page_size=PS, block_pages=4,
            attn_impl="pallas", mesh=jmesh)
        got = tllama.forward_impl(shards, CFG, _t(tokens).long(), _t(p), pool.kv_k,
                                  pool.kv_v, _t(tables), _t(c), PS, mesh=tmesh)
        live = p < trash
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **LOGIT_TOL)
    # The pools hold what JAX's hold, on both page shards.
    for r, kk in enumerate(pool.kv_k):
        m, s = tmesh.coords(r)
        tokens_local = num_pages * PS // seq
        nkv = CFG.n_kv_heads // model
        want = np.asarray(jk)[:, s * tokens_local:(s + 1) * tokens_local,
                              m * nkv:(m + 1) * nkv]
        np.testing.assert_allclose(kk.numpy()[:, PS:] if s == 0 else kk.numpy(),
                                   want[:, PS:] if s == 0 else want, **LOGIT_TOL)


def test_forward_on_mesh_matches_unsharded_forward(weights):
    """tp=4 (model=2 x seq=2) against the port's own unsharded forward."""
    _, tparams = weights
    tmesh = build_mesh(2, 2, ["cpu"] * 4)
    shards = _shard(tparams, tmesh)
    shape = dict(n_layers=CFG.n_layers, num_pages=NUM_PAGES, page_size=PS,
                 n_kv_heads=CFG.n_kv_heads, head_dim=CFG.head_dim, dtype=torch.float32,
                 device="cpu")
    split, whole = PagePool.create(**shape, mesh=tmesh), PagePool.create(**shape)
    tables = np.zeros((1, MAX_PAGES + 1), np.int32)
    tables[0, :3] = [10, 1, 14]
    tok = _t(np.arange(10)[None] % CFG.vocab_size).long()
    pos = _t(np.arange(10, dtype=np.int32)[None])
    args = (tok, pos)
    rest = (_t(tables), _t(np.asarray([10], np.int32)), PS)
    got = tllama.forward_impl(shards, CFG, *args, split.kv_k, split.kv_v, *rest, mesh=tmesh)
    want = tllama.forward_impl(tparams, CFG, *args, whole.kv_k, whole.kv_v, *rest)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


# --------------------------------------------------------------- engine


# Pools small enough that the lowest-first allocator reaches the second
# page shard in every scenario (preemption brings its own 20 pages).
MESH_PAGES = {"prefix_cache": dict(num_pages=20)}
BASE = dict(page_size=4, num_pages=32, max_batch_slots=4, prefill_chunk=8,
            max_seq_len=128)


def _tcore(tparams, mesh, kw):
    core = EngineCore(CFG, _shard(tparams, mesh) if mesh else tparams, ByteTokenizer(),
                      EngineConfig(kv_dtype=torch.float32, **kw), mesh=mesh)
    used: set[int] = set()
    alloc = core.kv.allocator.alloc

    def spy(n):
        pages = alloc(n)
        used.update(pages)
        return pages

    core.kv.allocator.alloc = spy
    return core, used


@pytest.mark.parametrize("scenario", ["concurrent", "preemption", "prefix_cache",
                                      "speculation"])
def test_greedy_streams_match_jax_engine_on_page_split_mesh(weights, scenario):
    """model=2 x seq=2: greedy streams equal to the JAX ``EngineCore`` on the
    same mesh (``attn_impl="pallas"``: the Pallas partial kernel for decode,
    the XLA page-split path for T > 1), with pages of both page shards in
    use."""
    spec = SCENARIOS[scenario]
    jparams, tparams = weights
    jmesh, tmesh = _meshes(2, 2)
    kw = dict(BASE, **MESH_PAGES.get(scenario, {}))
    kw.update(spec.get("cfg", {}))
    jsharded = jax.tree.map(jax.device_put, jparams,
                            param_shardings(jllama.CONFIGS[NAME], jmesh))
    jcore = JEngineCore(jllama.CONFIGS[NAME], jsharded, JByteTokenizer(),
                        JEngineConfig(block_pages=4, kv_dtype=jnp.float32,
                                      attn_impl="pallas", **kw), mesh=jmesh)
    tcore, used = _tcore(tparams, tmesh, kw)
    want = _run(jcore, JRequest, JSampling, spec)
    got = _run(tcore, EngineRequest, SamplingParams, spec)
    assert got == want
    assert tcore.kv.allocator.free_pages == kw["num_pages"] - 1  # all returned
    assert {p // (kw["num_pages"] // 2) for p in used} == {0, 1}
    if scenario == "preemption":
        assert tcore.metrics["preemptions"] >= 1
    if scenario == "prefix_cache":
        assert tcore.metrics["cached_prefix_tokens"] > 0
    if scenario == "speculation":
        assert tcore.metrics["spec_drafted"] > 0


@pytest.mark.parametrize("model,seq", [(2, 1), (2, 2)])
def test_mesh_engine_matches_unsharded_engine(weights, model, seq):
    """tp=2 (heads only) and tp=4 (heads and pages) give the unsharded
    engine's greedy streams, which ``test_torch_engine.py`` holds to JAX."""
    _, tparams = weights
    spec = SCENARIOS["concurrent"]
    kw = BASE
    want = _run(_tcore(tparams, None, kw)[0], EngineRequest, SamplingParams, spec)
    mesh = build_mesh(model, seq, ["cpu"] * (model * seq))
    got = _run(_tcore(tparams, mesh, kw)[0], EngineRequest, SamplingParams, spec)
    assert got == want


def test_engine_refuses_what_the_mesh_does_not_serve(weights):
    _, tparams = weights
    split, heads = build_mesh(2, 2, ["cpu"] * 4), build_mesh(2, 1, ["cpu"] * 2)
    int8_kv = EngineConfig(kv_dtype=torch.int8, **BASE)
    with pytest.raises(ValueError, match="page-split"):  # as the JAX engine
        EngineCore(CFG, _shard(tparams, split), ByteTokenizer(), int8_kv, mesh=split)
    with pytest.raises(NotImplementedError):  # JAX serves it on XLA
        EngineCore(CFG, _shard(tparams, heads), ByteTokenizer(), int8_kv, mesh=heads)
    with pytest.raises(NotImplementedError):
        EngineCore(CFG, [quantize_params(tparams)] * 2, ByteTokenizer(),
                   EngineConfig(kv_dtype=torch.float32, **BASE), mesh=heads)
    with pytest.raises(NotImplementedError):  # refused before the cut
        TorchCudaClient.build(NAME, device="cpu", dtype="int8", tp=2)
    with pytest.raises(ValueError, match="split"):
        build = build_mesh(3, 1, ["cpu"] * 3)
        EngineCore(CFG, _shard(tparams, build), ByteTokenizer(),
                   EngineConfig(kv_dtype=torch.float32, **BASE), mesh=build)


def test_cli_chat_on_a_cpu_mesh():
    proc = subprocess.run(
        [sys.executable, "-m", "runbookai_tpu_torch", "chat", "hello", "--model", NAME,
         "--device", "cpu", "--tp", "4", "--max-new-tokens", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["mesh"] == {"data": 1, "seq": 2, "model": 2}
    assert stats["completion_tokens"] == 4
    assert not any(stats["kernel_launches"].values())  # plain versions on the CPU


def test_mesh_axes_are_the_jax_ones():
    from runbookai_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS

    assert (MODEL_AXIS, SEQ_AXIS) == (JMODEL, JSEQ)
