"""The knowledge path of the PyTorch port against the JAX package, on the CPU.

The bge encoder (``models/bge.py``) with the JAX package's params carried
across, on padded batches with ragged masks; the port's HF loader against
the checked-in ``hf-tiny-bert`` golden; the tanh GELU; the embedder with
``model_path`` set to that fixture in both packages (embeddings, stats, the
md5 LRU cache, length buckets); chunker, FTS store and vector top-k; a
``knowledge.db`` synced by one package and searched by the other in all
three hybrid modes; the service graph, both context managers, the
``search_knowledge`` tool and the orchestrator's knowledge leg over the real
retriever. The markdown trees come from ``chip_smoke.knowledge_tree``, the
generator of the card's phase 19, at a few documents.
"""

import dataclasses
import json
import os
import shutil
import sqlite3
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import runbookai_tpu.agent.knowledge_context as j_kctx
import runbookai_tpu.agent.orchestrator as j_orch
import runbookai_tpu.agent.service_context as j_sctx
import runbookai_tpu.agent.state_machine as j_sm
import runbookai_tpu.knowledge.chunker as j_chunker
import runbookai_tpu.knowledge.embedder as j_embedder
import runbookai_tpu.knowledge.retriever as j_retriever
import runbookai_tpu.knowledge.sources as j_sources
import runbookai_tpu.knowledge.sources.html_markdown as j_html
import runbookai_tpu.knowledge.store.graph as j_graph
import runbookai_tpu.knowledge.store.sqlite_fts as j_fts
import runbookai_tpu.knowledge.store.vector as j_vector
import runbookai_tpu.models.bge as j_bge
import runbookai_tpu.tools.registry as j_registry
import runbookai_tpu.utils.config as j_config
import runbookai_tpu_torch.agent.knowledge_context as t_kctx
import runbookai_tpu_torch.agent.orchestrator as t_orch
import runbookai_tpu_torch.agent.service_context as t_sctx
import runbookai_tpu_torch.agent.state_machine as t_sm
import runbookai_tpu_torch.knowledge.chunker as t_chunker
import runbookai_tpu_torch.knowledge.embedder as t_embedder
import runbookai_tpu_torch.knowledge.retriever as t_retriever
import runbookai_tpu_torch.knowledge.sources as t_sources
import runbookai_tpu_torch.knowledge.sources.html_markdown as t_html
import runbookai_tpu_torch.knowledge.store.graph as t_graph
import runbookai_tpu_torch.knowledge.store.sqlite_fts as t_fts
import runbookai_tpu_torch.knowledge.store.vector as t_vector
import runbookai_tpu_torch.models.bge as t_bge
import runbookai_tpu_torch.tools.registry as t_registry
import runbookai_tpu_torch.utils.config as t_config
from runbookai_tpu_torch.models.convert import bge_params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

BERT = Path(__file__).parent / "fixtures" / "hf-tiny-bert"
QUERIES = ["connection pool exhausted on payment-api", "how to mitigate certificate expiry",
           "redis clients maxed out", "OOMKilled pods crashloop", "checkout-web 5xx errors",
           "postmortem kafka-broker consumer lag"]
MODES = ["fts", "vector", "hybrid"]


@dataclasses.dataclass
class Stack:
    """One package's knowledge modules."""
    chunker: object
    embedder: object
    retriever: object
    fts: object
    vector: object
    graph: object
    kctx: object
    sctx: object
    config: object


STACKS = {"jax": Stack(j_chunker, j_embedder, j_retriever, j_fts, j_vector, j_graph, j_kctx,
                       j_sctx, j_config),
          "port": Stack(t_chunker, t_embedder, t_retriever, t_fts, t_vector, t_graph, t_kctx,
                        t_sctx, t_config)}


def embedder(stack: str, model_path: Path = BERT, **kw):
    """The encoder of the HF directory ``model_path`` in ``stack``'s
    embedder (the port's on the CPU)."""
    kw = {"model_path": str(model_path), "max_length": 64, **kw}
    if stack == "port":
        kw["device"] = "cpu"
    return STACKS[stack].embedder.Embedder(**kw)


def vector_store(stack: str, db):
    mod = STACKS[stack].vector
    return mod.VectorStore(db, device="cpu") if stack == "port" else mod.VectorStore(db)


def retriever(stack: str, db_path, tree: Path, model_path: Path):
    """``stack``'s retriever facade over ``db_path``, the encoder of
    ``model_path`` and ``tree`` as one filesystem source."""
    s = STACKS[stack]
    store = s.fts.KnowledgeStore(db_path)
    hybrid = s.retriever.HybridRetriever(store, vectors=vector_store(stack, store.db),
                                         embedder=embedder(stack, model_path))
    return s.retriever.KnowledgeRetriever(
        store, hybrid, sources=[s.retriever.FilesystemSource(tree, name="runbooks")])


def write_bert_dir(params, cfg, path: Path) -> Path:
    """The JAX package's bge params as an HF BERT directory that both
    packages' ``load_params`` read back (projections transposed to
    ``[out, in]``)."""
    from safetensors.numpy import save_file

    p = jax.tree.map(np.asarray, params)
    tensors = {"embeddings.word_embeddings.weight": p["word_emb"],
               "embeddings.position_embeddings.weight": p["pos_emb"],
               "embeddings.token_type_embeddings.weight": p["type_emb"],
               "embeddings.LayerNorm.weight": p["emb_norm_w"],
               "embeddings.LayerNorm.bias": p["emb_norm_b"]}
    for leaf, (tmpl, transpose) in j_bge._HF_LAYER.items():
        for i in range(cfg.n_layers):
            w = p["layers"][leaf][i]
            tensors[tmpl.format(i=i)] = w.T if transpose else w
    path.mkdir(parents=True)
    save_file({k: np.ascontiguousarray(v, dtype=np.float32) for k, v in tensors.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["BertModel"], "model_type": "bert", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "intermediate_size": cfg.ffn_dim,
        "max_position_embeddings": cfg.max_positions, "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.norm_eps}))
    return path


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory) -> Path:
    """``bge-test`` with the JAX package's random params (seed 0) as an HF
    directory. The retrieval tests use it, not ``hf-tiny-bert``: the
    fixture's embeddings of any two texts lie within a cosine of 5e-5, so
    its vector rankings are float rounding; these spread from 0.85 to 0.99."""
    cfg = j_bge.CONFIGS["bge-test"]
    return write_bert_dir(j_bge.init_params(jax.random.PRNGKey(0), cfg), cfg,
                          tmp_path_factory.mktemp("bert") / "bge-test")


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """Eight generated documents and the three example runbooks."""
    root = tmp_path_factory.mktemp("kb") / "tree"
    made = chip_smoke.knowledge_tree(root, n_docs=8)
    assert made["documents"] == 11
    return root


def hit_row(hit) -> tuple:
    return (hit.chunk.chunk_id, hit.doc.doc_id, hit.mode, hit.score)


# ------------------------------------------------------------------ encoder


def test_gelu_is_jax_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; so does the port's
    helper, and the exact erf form is far enough from it to be caught."""
    x = np.linspace(-6.0, 6.0, 12_001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = t_bge.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 4 + 1
    w, b = rng.normal(size=32).astype(np.float32), rng.normal(size=32).astype(np.float32)
    want = np.asarray(j_bge.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12))
    got = t_bge.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def ragged_batch(rng, cfg, b: int, t: int):
    """Token ids and a ragged mask [b, t]: one full row, one of length 1."""
    tokens = rng.integers(0, cfg.vocab_size, size=(b, t))
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[1] = t, 1
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    return tokens.astype(np.int32), mask


@pytest.mark.parametrize("t", [16, 32, 64])
def test_encode_matches_jax_with_jax_params(t):
    """``bge-test`` with the JAX package's random params carried across
    (``bge_params_from_jax``): padded batches at the embedder's buckets."""
    cfg = j_bge.CONFIGS["bge-test"]
    jparams = j_bge.init_params(jax.random.PRNGKey(3), cfg)
    enc = t_bge.BertEncoder(t_bge.CONFIGS["bge-test"],
                            bge_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    tokens, mask = ragged_batch(np.random.default_rng(t), cfg, 6, t)
    want = np.asarray(j_bge.encode(jparams, cfg, jnp.asarray(tokens), jnp.asarray(mask)))
    got = enc.encode(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, cfg.dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_init_params_keeps_jax_layout_and_scale():
    """Same leaves, shapes and dtypes as the JAX package's; matrices drawn
    at 1/sqrt(fan_in), biases 0, norms 1; one seed gives one set of weights."""
    cfg = t_bge.CONFIGS["bge-test"]
    got = t_bge.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(np.asarray, j_bge.init_params(jax.random.PRNGKey(0),
                                                      j_bge.CONFIGS["bge-test"]))
    flat = lambda p: {k: v for k, v in p.items() if k != "layers"} | {  # noqa: E731
        f"layers.{k}": v for k, v in p["layers"].items()}
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert tuple(g[k].shape) == w[k].shape and str(g[k].dtype) == f"torch.{w[k].dtype}", k
    assert abs(float(got["word_emb"].std()) * np.sqrt(cfg.dim) - 1) < 0.05
    assert abs(float(got["layers"]["w2"].std()) * np.sqrt(cfg.ffn_dim) - 1) < 0.05
    assert float(got["layers"]["bq"].abs().max()) == 0
    assert float((got["layers"]["mlp_norm_w"] - 1).abs().max()) == 0
    again = t_bge.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flat(got).values(), flat(again).values()))


def test_load_params_matches_hf_golden_and_jax():
    """The port's HF loader on ``hf-tiny-bert``: the transformers BertModel
    golden at the JAX test's tolerance, the JAX loader's params exactly and
    its embeddings within 1e-5."""
    cfg, params = t_bge.load_params(BERT, device="cpu")
    jcfg, jparams = j_bge.load_params(BERT, dtype=jnp.float32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for k, v in jax.tree.map(np.asarray, jparams)["layers"].items():
        np.testing.assert_array_equal(params["layers"][k].numpy(), v)
    np.testing.assert_array_equal(params["word_emb"].numpy(), np.asarray(jparams["word_emb"]))
    blob = np.load(BERT / "expected_embeddings.npz")
    got = t_bge.BertEncoder(cfg, params).encode(torch.from_numpy(blob["input_ids"]),
                                                torch.from_numpy(blob["attention_mask"]))
    np.testing.assert_allclose(got.numpy(), blob["cls_norm"], atol=2e-4, rtol=2e-3)
    want = np.asarray(j_bge.encode(jparams, jcfg, jnp.asarray(blob["input_ids"]),
                                   jnp.asarray(blob["attention_mask"])))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_load_or_init_falls_back_to_bge_test_config():
    cfg, _ = t_bge.load_or_init("no-such-model", None, device="cpu")
    assert cfg == t_bge.CONFIGS["bge-test"]
    cfg, _ = t_bge.load_or_init("bge-test", str(BERT), device="cpu")
    assert cfg.vocab_size == 200 and cfg.max_positions == 64


# ----------------------------------------------------------------- embedder


def recorded_lengths(stack: str, emb) -> list:
    """Wrap ``emb``'s encoder so each call appends its [B, T]."""
    seen = []
    if stack == "port":
        encode = emb.encoder.encode

        def port_encode(tokens, mask):
            seen.append(tuple(tokens.shape))
            return encode(tokens, mask)
        emb.encoder.encode = port_encode
    else:
        encode = emb._encode

        def jax_encode(params, cfg, tokens, mask):
            seen.append(tuple(tokens.shape))
            return encode(params, cfg, tokens, mask)
        emb._encode = jax_encode
    return seen


def embedder_run(stack: str) -> dict:
    """One embedder through batches at each bucket, the cache, its LRU
    evictions and queries; every output, stat and batch shape."""
    emb = embedder(stack, batch_size=3, cache_max_entries=5)
    seen = recorded_lengths(stack, emb)
    texts = ["pool", "redis clients", "tls cert expired on ingress",
             "connection pool exhausted on payment-api " * 2, "x" * 200]
    outs = [emb.embed_texts(texts), emb.embed_texts(texts[:2] + ["a new text"]),
            emb.embed_texts(["pool", "another", "pool"]),
            emb.embed_texts(["redis clients"], is_query=True),
            emb.embed_text("x" * 200), emb.embed_text("never seen before, long enough " * 3)]
    return {"outs": outs, "stats": dict(emb.stats), "keys": list(emb._cache),
            "seen": seen, "estimate": emb.estimate_tokens(texts),
            "buckets": [emb._bucket_len(n) for n in (1, 16, 17, 33, 63, 64, 500)],
            "dim": emb.dim}


def test_embedder_matches_jax_with_the_fixture():
    want, got = embedder_run("jax"), embedder_run("port")
    for g, w in zip(got["outs"], want["outs"]):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    for key in ("stats", "keys", "seen", "estimate", "buckets", "dim"):
        assert got[key] == want[key], key
    assert got["stats"]["cache_evictions"] > 0 and got["stats"]["cache_hits"] > 0
    assert {t for _, t in got["seen"]} == {16, 32, 64}


# ------------------------------------------------------ chunker and stores


def documents(stack: str, tree: Path) -> list:
    return STACKS[stack].retriever.FilesystemSource(tree, name="runbooks").load()


def test_chunker_rows_match_jax(tree):
    want = [dataclasses.asdict(d) for d in documents("jax", tree)]
    got = [dataclasses.asdict(d) for d in documents("port", tree)]
    assert got == want
    assert sum(len(d["chunks"]) for d in got) > 40
    assert {d["knowledge_type"] for d in got} > {"runbook", "reference"}
    text = (tree / "generated" / "doc-000.md").read_text()
    assert t_chunker.parse_frontmatter(text) == j_chunker.parse_frontmatter(text)


def test_fts_store_search_matches_jax(tree):
    rows = {}
    for stack in STACKS:
        store = STACKS[stack].fts.KnowledgeStore(":memory:")
        for doc in documents(stack, tree):
            store.upsert_document(doc)
        rows[stack] = ([[hit_row(h) for h in store.search(q, limit=6)] for q in QUERIES]
                       + [[hit_row(h) for h in store.search(
                           "latency errors", knowledge_type="runbook", service=svc)]
                          for svc in ("payment-api", "checkout-web")],
                       store.stats(), [dataclasses.asdict(c) for c in store.all_chunks()])
    assert rows["port"] == rows["jax"]
    assert all(rows["port"][0][:len(QUERIES)])


def test_vector_topk_matches_jax():
    """Random rows (two of them equal) and queries: the same ids in the
    same order, scores within 1e-6."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(40, 24)).astype(np.float32)
    vecs[7] = vecs[3]
    queries = rng.normal(size=(6, 24)).astype(np.float32)
    out = {}
    for stack in STACKS:
        vs = vector_store(stack, sqlite3.connect(":memory:"))
        vs.store_many([(f"c{i:02d}", f"d{i % 9}", v) for i, v in enumerate(vecs)])
        vs.store("c99", "d99", vecs[5] * 3)
        vs.delete_doc("d4")
        out[stack] = (vs.count(), [vs.search(q, limit=k) for q, k in zip(
            queries, (1, 3, 5, 10, 50, 8))]
            + [vs.search(vecs[3], limit=4)])
    assert out["port"][0] == out["jax"][0] == 37
    for got, want in zip(out["port"][1], out["jax"][1]):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)


def test_vector_store_raises_on_a_card_it_lacks():
    """The matrix goes to the card asked for, with no numpy fallback."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: the matrix would go to it")
    vs = t_vector.VectorStore(sqlite3.connect(":memory:"), device="cuda")
    vs.store("c0", "d0", np.ones(4, np.float32))
    with pytest.raises((RuntimeError, AssertionError)):
        vs.search(np.ones(4, np.float32))


# --------------------------------------------------------------- retrieval


def search_record(r, queries=QUERIES) -> dict:
    """Every mode's hits for each query, and the grouped results."""
    rec = {mode: [[hit_row(h) for h in r.hybrid.search(q, limit=5, mode=mode)]
                  for q in queries] for mode in MODES}
    rec["filtered"] = [[hit_row(h) for h in r.hybrid.search(
        q, limit=4, knowledge_type="runbook", service="payment-api")] for q in queries[:3]]
    rec["grouped"] = [dataclasses.asdict(r.search_grouped(q, service=svc))
                      for q, svc in zip(queries, (None, "payment-api", None))]
    return rec


def assert_same_search(got: dict, want: dict) -> None:
    """Ids, documents and modes equal; fts and hybrid (RRF) scores equal,
    vector scores (cosines) within 1e-5."""
    for key in (*MODES, "filtered"):
        for g, w in zip(got[key], want[key]):
            assert [r[:3] for r in g] == [r[:3] for r in w], key
            np.testing.assert_allclose([r[3] for r in g], [r[3] for r in w],
                                       atol=1e-5 if key == "vector" else 0, rtol=0)
    assert got["grouped"] == want["grouped"]


@pytest.fixture(scope="module")
def synced(tree, bert_dir, tmp_path_factory):
    """A ``knowledge.db`` synced by each package from the same tree."""
    root = tmp_path_factory.mktemp("dbs")
    out = {}
    for stack in STACKS:
        db = root / f"{stack}.db"
        r = retriever(stack, db, tree, bert_dir)
        out[stack] = (db, r.sync(), r.stats(), search_record(r))
        r.store.close()
    return out


def test_sync_and_search_match_jax(synced):
    """Each package syncs and searches its own db; counts, stats and every
    search are the same."""
    _, counts, stats, rec = synced["port"]
    _, jcounts, jstats, jrec = synced["jax"]
    assert counts == jcounts == {"runbooks": 11}
    assert stats == jstats and stats["embeddings"] == stats["chunks"] > 40
    assert_same_search(rec, jrec)
    assert all(rec["hybrid"]) and all(h[2] == "hybrid" for h in rec["hybrid"][0])


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_db_from_one_package_serves_the_other(writer, reader, synced, tree, bert_dir,
                                              tmp_path):
    """One package's ``knowledge.db`` (a copy) searched by the other: the
    writer's own hits; a second sync of the reader finds nothing new."""
    db = tmp_path / "copy.db"
    shutil.copy(synced[writer][0], db)
    r = retriever(reader, db, tree, bert_dir)
    assert_same_search(search_record(r), synced[writer][3])
    assert r.sync() == {"runbooks": 0}


def test_hybrid_falls_back_to_fts_without_vectors(tree, bert_dir):
    """No vectors: hybrid is FTS alone in both packages (the reference's
    semantics, not a device fallback)."""
    out = {}
    for stack in STACKS:
        s = STACKS[stack]
        store = s.fts.KnowledgeStore(":memory:")
        for doc in documents(stack, tree):
            store.upsert_document(doc)
        h = s.retriever.HybridRetriever(store, vectors=vector_store(stack, store.db),
                                        embedder=embedder(stack, bert_dir))
        out[stack] = [[hit_row(x) for x in h.search(q, limit=4)] for q in QUERIES]
    assert out["port"] == out["jax"]
    assert {r[2] for hits in out["port"] for r in hits} == {"fts"}


def test_create_retriever_builds_the_stack_on_the_device(tree, bert_dir, tmp_path):
    """``create_retriever`` from a config: the fixture's encoder and the
    vectors on the CPU when asked; without a card, asking for it raises."""
    kcfg = {"sources": [{"type": "filesystem", "name": "runbooks", "path": str(tree)}],
            "db_path": str(tmp_path / "k.db"),
            "embedder": {"model": "bge-test", "model_path": str(bert_dir), "max_length": 64}}
    config = t_config.Config.model_validate({"knowledge": kcfg})
    r = t_retriever.create_retriever(config, device="cpu")
    assert r.hybrid.embedder.device.type == r.hybrid.vectors.device.type == "cpu"
    assert r.sync() == {"runbooks": 11}
    jr = j_retriever.create_retriever(j_config.Config.model_validate({"knowledge": kcfg}))
    assert_same_search(search_record(r, QUERIES[:3]), search_record(jr, QUERIES[:3]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_retriever.create_retriever(config)


def test_sources_port_the_filesystem_kind_and_refuse_remote_ones(tree):
    cfg = t_config.KnowledgeSourceConfig
    jcfg = j_config.KnowledgeSourceConfig
    got = t_sources.load_from_source(cfg(type="filesystem", path=str(tree), name="fs"))
    want = j_sources.load_from_source(jcfg(type="filesystem", path=str(tree), name="fs"))
    assert [dataclasses.asdict(d) for d in got] == [dataclasses.asdict(d) for d in want]
    assert t_sources.build_source(cfg(type="confluence")) is None
    for src in (cfg(type="confluence", base_url="https://x.atlassian.net", space="OPS"),
                cfg(type="google-drive", folder_id="f1")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            t_sources.build_source(src)
    html = ("<h1>Payments</h1><p>Check the <strong>error rate</strong> "
            "<a href='https://x'>here</a>.</p><ul><li>one</li></ul><pre>kubectl get pods</pre>"
            "<table><tr><th>svc</th></tr><tr><td>payments</td></tr></table>")
    assert t_html.html_to_markdown(html) == j_html.html_to_markdown(html)


# ------------------------------------------- graph, contexts, tool, orchestrator


def test_service_graph_save_load_match_jax(tmp_path):
    """The phase-19 graph: saved by each package byte for byte the same,
    loaded by the other, the same queries and stats."""
    path = tmp_path / "service-graph.json"
    path.write_text(chip_smoke.knowledge_graph_json())
    graphs = {s: STACKS[s].graph.ServiceGraph.load(path) for s in STACKS}
    for s, g in graphs.items():
        g.add_dependency("kafka-broker", "order-service", kind="async", description="events")
        g.save(tmp_path / f"{s}.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    g, j = graphs["port"], graphs["jax"]
    for svc in chip_smoke.KNOWLEDGE_SERVICES:
        assert g.downstream_impact(svc) == j.downstream_impact(svc)
        assert g.upstream_impact(svc, max_depth=2) == j.upstream_impact(svc, max_depth=2)
        assert g.find_path("checkout-web", svc) == j.find_path("checkout-web", svc)
    assert g.find_cycles() == j.find_cycles() != []
    assert g.stats() == j.stats()
    assert [vars(n) for n in g.filter(team="payments")] == [vars(n) for n in j.filter(
        team="payments")]
    mgr = {s: STACKS[s].sctx.ServiceContextManager(graphs[s], max_services=3) for s in STACKS}
    for s in STACKS:
        assert mgr[s].observe_services(["payment-api", "nope", "checkout-web", "payments-db",
                                        "redis-cache"]) == ["payment-api", "checkout-web",
                                                            "payments-db", "redis-cache"]
    assert mgr["port"].system_prompt_block() == mgr["jax"].system_prompt_block() != ""
    assert mgr["port"].blast_radius("payments-db") == mgr["jax"].blast_radius("payments-db")


async def test_knowledge_context_and_tool_match_jax(synced, tree, bert_dir, tmp_path):
    """The knowledge context manager (prime, absorb, re-query on new terms)
    and the registered ``search_knowledge`` tool over each package's
    retriever on the same db."""
    out = {}
    for stack, registry in (("jax", j_registry), ("port", t_registry)):
        db = tmp_path / f"{stack}.db"
        shutil.copy(synced["jax"][0], db)
        r = retriever(stack, db, tree, bert_dir)
        mgr = STACKS[stack].kctx.KnowledgeContextManager(r, max_index_entries=6)
        primed = await mgr.prime("payment-api connection pool")
        again = await mgr.observe_terms(["payment-api", "certificate", "expiry"])
        none = await mgr.observe_terms(["certificate"])
        config = STACKS[stack].config.Config()
        tools = {t.name: t for t in registry.get_runtime_tools(config, knowledge=r)}
        tool = tools["search_knowledge"]
        result = await tool.execute({"query": "redis clients maxed out", "limit": 4})
        filtered = await tool.execute({"query": "latency", "type": "runbook",
                                       "service": "payment-api"})
        out[stack] = (dataclasses.asdict(primed), again and dataclasses.asdict(again), none,
                      mgr.system_prompt_block(), tool.schema(), tool.category, result,
                      filtered, sorted(tools))
    assert out["port"] == out["jax"]
    assert out["port"][3].startswith("# Available knowledge") and out["port"][6]["results"]


async def test_orchestrator_knowledge_leg_matches_jax(synced, tree, bert_dir, tmp_path):
    """The orchestrator over the real retriever (until now the port's tests
    reached it with a stub): triage's fallback chain stops at the
    ``search_knowledge`` step, and ``fetch_relevant_runbooks`` gives the
    same runbooks for a root cause with and without a service."""
    out = {}
    for stack, orch_mod, sm_mod, registry in (("jax", j_orch, j_sm, j_registry),
                                              ("port", t_orch, t_sm, t_registry)):
        db = tmp_path / f"{stack}.db"
        shutil.copy(synced["jax"][0], db)
        r = retriever(stack, db, tree, bert_dir)
        tools = {t.name: t for t in registry.get_runtime_tools(
            STACKS[stack].config.Config(), knowledge=r)}
        machine = sm_mod.InvestigationStateMachine(incident_id="PD-7")
        orch = orch_mod.InvestigationOrchestrator(None, orch_mod.ToolExecutor(tools),
                                                  machine=machine, knowledge=r)
        context = await orch.gather_triage_context("PD-7", "redis connection exhaustion")
        runbooks = []
        for cause, services in (("connection pool exhausted", []),
                                ("certificate expired", ["payment-api"]),
                                ("", ["no-such-service"])):
            machine.root_cause, machine.affected_services = cause, services
            runbooks.append(await orch.fetch_relevant_runbooks())
        no_kb = await orch_mod.InvestigationOrchestrator(
            None, orch_mod.ToolExecutor({}), machine=machine).fetch_relevant_runbooks()
        out[stack] = (context, runbooks, no_kb, machine.errors)
    assert out["port"] == out["jax"]
    context, runbooks, no_kb, errors = out["port"]
    assert "search_knowledge: {" in context and not errors
    assert runbooks[0].startswith("[") and runbooks[2] == "(none found)"
    assert no_kb == "(no knowledge base)"


# -------------------------------------------------------- the card's phase


def test_knowledge_tree_is_seeded_and_shaped_like_the_examples(tmp_path):
    a = chip_smoke.knowledge_tree(tmp_path / "a", n_docs=20)
    b = chip_smoke.knowledge_tree(tmp_path / "b", n_docs=20)
    assert a == b
    files = sorted((tmp_path / "a" / "generated").glob("*.md"))
    assert [f.read_text() for f in files] == [
        f.read_text() for f in sorted((tmp_path / "b" / "generated").glob("*.md"))]
    for f in files:
        meta, body = t_chunker.parse_frontmatter(f.read_text())
        assert meta["type"] in chip_smoke._KNOWLEDGE_TYPES and meta["services"]
        assert 2048 <= len(f.read_text()) <= 8192 + 1200
        assert "## Triage" in body and "\n1. " in body and "```" in body
    assert len(chip_smoke.knowledge_queries(32)) == len(set(chip_smoke.knowledge_queries(32)))


def test_encoder_work_counts_real_tokens():
    """Phase 19's bound: projections per real token and attention over each
    row's real keys, padding not counted."""
    cfg = t_bge.CONFIGS["bge-test"]
    mask = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]])
    n_bytes, flops = chip_smoke.encoder_work(cfg, mask)
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    assert flops == L * (2 * 4 * (4 * d * d + 2 * d * f) + 4 * (9 + 1) * d)
    assert n_bytes > 4 * L * (4 * d * d + 2 * d * f)


def test_compare_rankings_allows_only_swaps_within_the_error():
    """Phase 19's card-vs-CPU check: ranks may part only between chunks
    whose cosines lie within twice the largest score error."""
    card = [("a", 0.9), ("b", 0.8), ("c", 0.7000004), ("d", 0.7)]
    cpu = [("a", 0.9), ("b", 0.8), ("d", 0.7000003), ("c", 0.7000002)]
    got = chip_smoke.compare_rankings(card, cpu, 4)
    assert got["swaps"] == [{"rank": 2, "gap": pytest.approx(4e-7)},
                            {"rank": 3, "gap": pytest.approx(4e-7)}]
    assert chip_smoke.compare_rankings(card, card, 4) == {"max_score_err": 0.0, "swaps": []}
    with pytest.raises(AssertionError, match="rank 1"):
        chip_smoke.compare_rankings(card, [("a", 0.9), ("c", 0.7000004), ("b", 0.8),
                                           ("d", 0.7)], 4)
    with pytest.raises(AssertionError, match="off the CPU"):
        chip_smoke.compare_rankings(card, [(i, s + 1e-4) for i, s in card], 4)
