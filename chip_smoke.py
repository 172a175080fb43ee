#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure exits non-zero; one JSON object per phase on stdout,
its name and seconds on stderr; past ``WATCHDOG_S`` seconds the run dumps
every thread's stack to stderr and exits 1). The profiled reruns of the
serving configurations but int8's, the witnesses and the mesh serving
phases (12 and 16's page split and tp=8) run at 4 of the 32 layers
(``CUT_LAYERS``):

1. build every kernel from ``runbookai_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source (ptxas report in ``OUT_DIR/ptxas.txt``);
2. hold the decode kernel against its plain version at the serving shapes
   (B=8, 32 query / 8 kv heads, head_dim 128, 16-token pages, 513-wide
   tables, ctx 0..8191) for bf16 and f32 pools, and time it (CUDA events
   over back-to-back calls and, L2 cold, one call at a time; profiler
   device time; host time a call): bf16 queries take the tensor-core kernel
   (``decode_attention.cu``, with its split count), also on the served
   contexts (at most 950 tokens) and at head_dim 64 (32 query / 8 kv
   heads); f32 queries the CUDA-core kernel;
3. hold the chunk kernels against their plain version on a 4 x 512 prefill
   at offsets 0 and 512, a T=8 verify from ctx-1, and a chunk with a pad
   tail: bf16 queries take the tensor-core kernel (``chunk_attention.cu``),
   also on a one-row 512-token prefill at offset 4096 (64-row tiles, split
   in two), a T=8 verify at the served contexts (at most 950 tokens) and
   the tp=8 head shard's shape (4 query heads over 1 kv head), each input
   with its split count, and each split input once more unsplit; f32
   queries take the CUDA-core kernel. The merge of a split call is held
   against ``merge_partials``. The prefill and verify inputs are timed;
   both kernel phases show that the tolerance rejects a result with the
   last page dropped;
4. the same two checks over int8 pools (values + one f32 scale per token
   and kv head, quantized from random bf16) with bf16 and f32 queries: the
   int8 decode kernel (K3: bf16 queries on the tensor-core kernel of
   ``decode_attention.cu``, also at head_dim 64; f32 queries on the
   CUDA-core kernel) and the chunk kernels over int8 pools;
5. hold the int8 weight matmul kernel (K5) against its plain version at
   the 8B's four (K, N) shapes and M = 5, 8, 64, 256 (the mma.sync route
   for M <= 8 and M > 64, wgmma for 8 < M <= 64) with each call's split
   count, each one launch and no allocation but the output a call (split
   partials merged in the launch), f32 x on the CUDA-core kernel, show
   that the tolerance rejects a result with the last K slice dropped, and
   time it rotating over 32 layer slices so that no call finds its weight
   in L2 (its cold time);
6. check the forward on the card (both kernels) against the checked-in HF
   golden logits and against the same forward on the CPU, then the same
   forward with int8 weights over an int8 pool against the CPU;
7. serve llama3-8b-instruct at full width (random weights from a seed)
   through ``TorchCudaClient.chat``: 5 concurrent greedy requests of 64 to
   1024 prompt tokens, 32 new tokens each. Kernel launch counts are zeroed
   just before and read just after; both must rise;
8. serve the same requests once more under torch.profiler: device time by
   kernel class and the device's idle share; it fails unless the bf16
   chunk and decode calls ran the tensor-core kernels (over int8 pools in
   phase 9) and never a removed bf16-query instantiation of the CUDA-core
   kernel (with int8 weights also K5's mma.sync and wgmma kernels, never
   its removed CUDA-core bf16 kernel or second-launch merge). Both serving
   phases fail if the engine loop crashed or a request was aborted, and
   the first if no split chunk call was merged;
9. phases 7 and 8 again with int8 weights and an int8 KV pool
   (``TorchCudaClient.build(dtype="int8", kv_cache_dtype="int8")``): the
   int8 kernels' counts must rise and the bf16 attention counts stay 0;
   then, for both configurations, the requests served twice more with every
   chunk and decode call of the forward (and, with int8 weights, every K5
   call) held against its plain version on the same inputs (fails beyond
   TOL), once serving the
   kernel's result and once the plain version's, and where the plain
   run's greedy streams part from the kernel run's;
10. the page-split partial kernels (K4 for decode, the chunk partial for
   T > 1) on phase 2's and phase 3's inputs cut into two page shards of
   1024 pages (the chunk partial on the prefill, the verify, and the verify
   with each sequence's pages on one shard), at the shape of one call of
   phase 12's path (one model group's 4 query heads over its kv head) and
   over all heads: each shard's (acc, m, l) against its plain version, the
   same result with the other shard's pages set to NaN (no foreign page is
   loaded), the merge of both shards against K1/K2 on the unsplit pool,
   the rejection of a result with the last page dropped, and per-call
   times (events, device, host) beside the memory-efficient SDPA call that
   returns the same partial normalised (out, log-sum-exp); bf16 partials
   take the tensor-core kernels (K4 ``decode_attention.cu``'s, the chunk
   partial ``chunk_attention.cu``'s), with their split counts, and K4 runs
   also at head_dim 64;
11. the tensor-parallel forward of llama3-8b-instruct at full width, depth
   cut to 2 layers, f32 weights and pool, on a model=8 x seq=2 and a
   model=8 x seq=1 mesh of 16 and 8 shards on the one card, against the
   unsharded forward: a prefill chunk, a decode step and a T=8 verify;
12. the requests of phase 7 served at 4 of the 32 layers (``CUT_LAYERS``)
   through ``TorchCudaClient.build(tp=16, devices=["cuda:0"] * 16)``
   (model=8 x seq=2) over a 256-page pool: pages of both page shards must
   be allocated, the partial kernels' counts must rise and K1's and K2's
   stay 0; then once more under torch.profiler, as phase 8 (it fails unless the chunk and
   decode partials ran the tensor-core kernels), and twice more with every
   chunk- and decode-partial call held against its plain version, as the
   witness of phase 9;
13. W1 (``paged_ragged_attention``, run after phase 4) on the serving
   configuration's mixed batch (N = 576 tokens in 72 blocks of 8, 13
   rows): 8 decode rows at the served contexts with a 512-token prefill
   at offset 4096, and 7 decode rows up to 8191 tokens with a free slot
   and a 500-token prefill ending in a pad block, the latter also over an
   int8 pool and at a GQA group of 7 and at head_dim 64; each through its
   per-layer launch on a tile list built beforehand (the ragged kernel of
   ``ragged_attention.cu``), against its plain version, pad blocks exactly
   zero, one kernel and no allocation but the output a call, timed (also
   L2-cold) beside its bound and SDPA on each block's gathered K/V, with
   its tile count and modeled key visits, and the whole call; the tile
   list's kernel (``ragged_plan.cu``, one launch) against its plain
   version record for record, timed beside it; a batch of 18 long decode
   rows, of which the first 16 split and the last two do not, against the
   plain version; K2's one-row prefill at offset 4096 is timed beside them;
14. (after phase 9) the requests served with mixed dispatch on
   (``engine={"mixed_dispatch": True}``): it fails unless mixed steps ran
   and W1 and its tile list launched; its profiled rerun (the ragged kernel
   once per W1 call, the list's kernel once per list, K2's kernel once per
   K2 call); its witness (W1's calls, its lists exactly, chunk and decode
   calls each held against the plain version); then bf16 serving
   with the overlapped pipeline off, whose greedy streams must equal phase
   7's wherever both runs issued the same forwards (the serving phases log
   each forward's entry point and token shape), and its profiled rerun
   beside phase 8's idle share;
15. (after phase 14) the structured orchestrator's completions at the JAX
   client's defaults: llama3-8b-instruct at full width, bf16, random
   weights from seed 0, byte tokenizer, the serving engine, schema limits
   of 16 string bytes, 2 array items, 64 free-form bytes; concurrently
   ``complete(prompt)`` under the generic JSON grammar and
   ``complete(prompt, schema=name)`` for the six orchestrator schemas (512
   new tokens at most), the chat turns of phase 7's first two prompts, and
   through the engine one request with ``logit_bias`` +100 on one byte,
   one with ``frequency_penalty=2.0``, one with ``logprobs=5`` and a seeded
   row at temperature 0.8 (32 new tokens each). It fails unless every
   guided output parses and validates and finished on a stop token (or,
   its document complete, padded the rest of its budget with the
   whitespace the grammar admits beside the stop), K1 and K2 launched, no
   guided token lies past the byte tokenizer's 262 ids (the masks are the
   model's 128,256 wide), the biased stream is the forced byte, the
   logprobs are sorted, at most 0 and the greedy token's the top-1 within
   1e-3, and the seeded row served again alone gives the same tokens. Then
   the guided completions once more with grammar fast-forward on (forced
   tokens must be folded); a profiled window of 32 engine steps of the same
   requests, beside phase 8's idle share; and the witness of every K1 and
   K2 call of the phase held against the plain version within TOL. Each
   line carries the guided tokens, the k = 1 dispatches, the forced
   tokens, the wall and the guided tokens a second.

16. fp8 (e4m3) KV pools, each phase beside the one whose inputs or path it
   shares: after phase 13, ``fp8_cast`` (every bf16 bit pattern and every
   4,099th f32 one written into an fp8 pool on the card, byte for byte the
   CPU's write, NaN past 464 included), then K1, K2 and W1 over fp8 pools
   written from phase 2's, 3's and 13's inputs (``decode_fp8_kernel``: the
   decode input, served contexts, head_dim 64, f32 queries;
   ``chunk_fp8_kernel``: the prefill, the verify, the one-row prefill, f32
   queries on the verify; ``ragged_fp8_kernel``: the served mixed batch),
   each within TOL of its plain version, equal bit for bit to the bf16
   instantiation over ``pool.to(bfloat16)``, and timed with its bound from
   the fp8 bytes beside SDPA over the widened gather; after phase 9,
   ``engine_fp8`` (bf16 weights, ``kv_cache_dtype="fp8"``: half of phase
   7's pool bytes, only the fp8 counters rise), its profile (the fp8
   instantiations and no bf16-pool kernel) and its witness (every K1 and K2
   call within TOL of the plain version); after phase 14,
   ``engine_mixed_fp8`` (W1's fp8 instantiation on the mixed steps); after
   phase 10, ``partial_fp8_kernel`` (K4 and the chunk partial over fp8 page
   shards at the tp=16 call's shape, as phase 10 checks them, and equal to
   their bf16 instantiations); after phase 12, ``engine_kv_split_fp8`` (the
   page split over fp8 page shards: half the pool, the fp8 partials'
   counters) and ``engine_tp8_fp8`` (the requests on a tp=8 mesh, model=8 x
   seq=1 on the one card, over fp8 pool shards: K1 and K2's fp8
   instantiations per head shard).
17. step graphs: every serving phase runs with the engine's step graphs
   on (the default: every step program as one CUDA graph a bucket, the
   batched prefill at 1, 2 and 4 rows, the decode forward at T = 1, the
   greedy k-step loop at k = 2, 4 and 8, the verify at T = 2, 4 and 8 and,
   with mixed dispatch, the mixed step, all captured while the client is
   built, inside ``build_s``), and fails unless a replay ran and the split
   workspace that the graphs took at capture is still theirs alone after
   serving. Every served configuration (bf16, int8, fp8, mixed, mixed fp8,
   overlap off, the page split, the page split over fp8, tp=8 over fp8
   and the guided completions) is served again with graphs off
   (``*_graphs_off``): their greedy streams (guided: the documents and the
   extras' streams) must equal the graphs-on run's token for token. Each
   serving line reports the TTFTs, ``graph_capture_s``, the buckets
   (``graph_buckets``), the wall of each prefill and mixed dispatch and
   the peak memory. bf16 is profiled both ways; each profiled client then
   steps the requests once more in this thread under the profiler: the
   prefill dispatches (with mixed dispatch, the mixed ones), then 4 decode
   steps, for the runtime calls a prefill forward, a mixed forward, a
   decode forward and a greedy decode step; with graphs on, a prefill or
   mixed dispatch must be one graph launch and its input copies, and a
   greedy decode step at most 2 calls. The witnesses serve with graphs off
   (a replay calls no module function). The kernel phases report
   ``graph_ms`` beside ``device_ms``: the calls captured in one CUDA
   graph, one replay timed with events, which needs no profiler window.
18. (after phase 15) ``runbook investigate`` and ``runbook ask`` through
   the port's CLI, in this process (``runbookai_tpu_torch.__main__.main``
   with ``--yes`` and a ``config.yaml`` written to a temporary directory):
   ``llm.provider: jax-tpu``, llama3-8b-instruct at full width cut to 4 of
   its 32 layers (``AGENT_LAYERS``), bf16, random weights from seed 0,
   byte tokenizer, phase 15's schema limits, 512 new tokens a call (256
   for ``ask``), the e2e test's budgets (2 hypotheses, depth 1, 2
   cycles); ``investigate PD-424242`` with the five simulated providers
   (aws, kubernetes, datadog, pagerduty, github), ``ask`` with aws alone
   (its first prompt, 7,816 byte tokens, fits the 8,192 context). Each
   runs with the step graphs on and again off; the printed output, every
   call's tokens and the final checkpoint must be equal. Each fails unless
   K1 and K2 launched, the graphs replayed (on) or not (off), every guided
   call's document parses under its schema and ended on a stop or padded
   whitespace, and ``investigate`` printed its root cause with the
   machine complete. Each line carries the LLM calls with their prompt
   and completion tokens, TTFT and wall, the forced tokens, each FSM
   phase's wall and the guided tokens a second. ``--agent`` runs the
   build and this phase alone.
19. (after phase 18) the knowledge path. ``knowledge_encode``: the
   bge-base-en-v1.5 encoder at full width (dim 768, 12 layers, 12 heads,
   ffn 3072, 512 positions), f32 with TF32 off, random weights from seed 0
   (drawn on the CPU, so the CPU copy is the same), at B = 64 and each
   length bucket (T = 16, 64, 256, 512, ragged masks): events, device and
   cold ms beside the bound (real tokens only, at the f32 peak); the first 4
   rows of each bucket against the same encoder on the CPU (max |err| <=
   1e-4); the hf-tiny-bert golden on the card (atol 2e-4, rtol 2e-3).
   ``knowledge_sync``: ``knowledge sync`` through the port's CLI over a
   markdown tree drawn from seed 0 (512 documents shaped like
   ``examples/runbooks/*.md``, 2-8 KB each, and the three example
   runbooks): documents, chunks, embedded tokens, the sync wall, encoder
   seconds, chunks and tokens a second; then 32 hybrid searches
   (``knowledge search``'s call) with p50/p99 latency, split into query
   encode, vector top-k and FTS, held against the same searches on a
   retriever on the CPU over the same db and weights (every cosine within
   1e-5; hit ids equal, up to ranks that a tie within that error swaps);
   ``knowledge search``, ``add``, ``stats`` and ``validate`` once each.
   Then phase 18's runs over that knowledge base and a
   ``service-graph.json`` (``agent_investigate_knowledge``,
   ``agent_ask_knowledge``), graphs on and off, equal, K1 and K2
   launched: ``investigate``'s triage prompt must carry the
   ``search_knowledge`` step's hits and its remediation prompt the
   runbooks a retriever on the CPU gives for its root cause; ``ask`` must
   print ``knowledge_retrieved``. Each first prompt of ``ask`` is counted
   before it is served: phase 18's question with aws's tools, then with
   none, else a how-to question (answered from the knowledge alone, no
   tool schemas), the first to leave its 256 tokens inside 8,192. Then
   ``agent_ask_knowledge_32k``: phase 18's question with aws's tools (the
   tool loop) on llama3.1-8b-instruct (``llm.max_seq_len`` 32,768) at the
   same depth, graphs on and off, equal.
   ``--knowledge`` runs the build and this phase alone.
20. (after phase 19) the eval suite through the port's CLI, in this
   process, as phase 18 runs its commands (``llm.provider: jax-tpu``,
   llama3-8b-instruct at full width, bf16, random weights from seed 0,
   byte tokenizer, phase 15's schema limits, 512 new tokens a call,
   ``time.time`` pinned). ``eval_simulated``: ``simulate eval --n 8 --seed
   0 --concurrency 4`` at CUT_LAYERS of the 32 layers, graphs on: eight generated
   scenarios, four investigations at a time on the one engine, each at
   ``run_live``'s own budgets (20 iterations, the state machine's
   defaults). It fails unless the command exits 0 with no engine crash,
   every case row is ``completed``, every guided document parses under its
   schema, K1 and K2 launched, the graphs replayed, ``summary.json`` and
   the report with its fault-family and adversarial breakdown were
   written, and the decode forwards carried more than one row on average
   and two or more at most (rows counted a forward, not tokens a step).
   ``eval_fixtures`` and ``eval_fixtures_graphs_off``: ``eval`` over the
   sample's ``payment-db-pool`` case alone (``--concurrency 1``) at 2 of
   the 32 layers (``EVAL_FIXTURE_LAYERS``), graphs on and off: the case
   rows (result, score, dimensions, event counts, iterations) and every
   call's tokens must be equal. The concurrent run is not compared on and off: its batches
   follow the host's timing. Each line carries the wall, cases a minute,
   guided tokens a second, each case's calls, prompt and completion tokens
   and TTFT p50/p99, the rows a decode forward (mean, largest), the triage
   baseline and pass@1 (random weights: it measures nothing about the
   model). ``--eval`` runs the build and this phase alone.
21. (after phase 20) ``serve``: the OpenAI-compatible HTTP server built
   by ``__main__.build_server``, the ``serve`` command's own construction
   (``llm.provider: jax-tpu``, llama3-8b-instruct at full width and all
   32 layers, bf16, random weights from seed 0, the serving engine's
   defaults with step graphs on, 64 new tokens a call; phase 19's random
   bge-base as the embedder), on port 0. ``serve``: the solo greedy chat
   non-streaming, streaming and through ``client.chat`` in this process,
   after a one-token request of the same prompt so that all three reuse one
   cached prefix (same text and same tokens: most of the random 8B's ids
   lie past the byte tokenizer's and decode to nothing); then eight concurrent client threads (four greedy chats,
   two streams with ``include_usage``, an ``n = 2`` seeded sample at
   temperature 0.8 and top-p 0.95, a ``json_object`` chat; prompts()'s
   83 to 918 tokens) beside one ``/v1/embeddings`` request of 32 texts;
   then a legacy completion with ``logprobs: 5`` and a stream the client
   drops after four chunks. It fails unless every response is a 200 with a
   valid ``finish_reason`` and ``usage`` equal to the tokens the engine
   served for its echoed x-request-id, the JSON parses, the two seeded
   choices drew from seeds 7 and 8 and differ in their tokens (and
   ``sample_tokens``' seeded rows draw apart on the card over a flat
   distribution), the embeddings are within 1e-6 of ``embed_texts`` alone,
   the dropped request is aborted and its pages return, ``/metrics`` counts
   each route's requests, ``/debug/steps`` holds one record a step, K1 and
   K2 launched under the load, the graphs replayed and the load's decode
   forwards averaged more than one row. It reports the HTTP TTFT of the
   streams (to the first chunk after the role chunk: the first token's
   piece, or the finish), the engine's TTFT, the load's wall
   and completion tokens a second, rows a decode forward, the solo
   request's HTTP, SSE and in-process walls, and the memory plan (the
   card's ``total_memory``) beside the bytes allocated by the weights and
   by the pool. ``serve_graphs``: a greedy chat (JSON and SSE), a seeded
   sample, penalties with ``logit_bias`` and a logprob chat through
   ``serve`` at CUT_LAYERS layers with the step graphs on and again off:
   equal bodies apart from ``id`` and ``created``, equal tokens, logprobs
   within LOGPROB_TOL. ``--serve`` runs the build and this phase alone.
22. (after phase 21) multi-LoRA serving and draft-model speculation.
   ``lora_draft``: ``serve``'s construction from ``llm.lora_adapters``
   (three PEFT directories of random adapters, rank 8 over wq and wv, from
   seeds 0 to 2, written here in the safetensors layout) and
   ``--allow-adapter-loading``, llama3-8b-instruct at full width cut to 8
   of its 32 layers, bf16, speculation off and one prefill row a dispatch
   (each row's stream then depends on its own prompt and adapter only).
   One batch of the base model and the three adapters on one 15-token
   prompt, 48 new tokens each: every row must equal its solo stream and
   every adapter change the stream; graphs off must give the same batch,
   and an engine without a registry the base row. A fourth adapter loads
   over ``POST /v1/adapters``: every bucket must be captured again (its
   seconds reported), ``/v1/models`` list it, the next HTTP request naming
   it serve with its row, and a batch of all five rows equal the solo
   streams of before the load. It reports one decode forward's device ms
   (the ("forward", 1) graph replayed over the batch's last inputs) with
   adapters and without a registry. ``lora_draft_speculation``:
   llama3.2-1b-instruct (random, bf16, all 16 layers, head_dim 64) drafts
   for the 8B at 8 layers through ``llm.draft_model``: prompts()'s first
   four requests together, 64 new tokens each, with the draft, with prompt
   lookup alone and with speculation off: acceptance, drafted tokens, rows
   a verify forward, the worker's seconds, tokens a second; the worker's own
   dispatches must launch K1 and K2. Then the 8B at 2 layers in float32
   drafting for itself: each of two solo requests' streams with the draft
   must equal speculation off. The kernels' line gives K1's, K2's and the
   merge's launches in this phase (``lora_draft_launches``). ``--lora``
   runs the build and this phase alone.
23. Mixtral mixture-of-experts serving (after phase 22). ``moe_ffn``:
   ``ops/moe.py::moe_ffn`` at mixtral-8x7b-instruct's widths (D 4096, F
   14336, E 8, top 2), one layer of random experts in bf16 and in int8,
   dropless, at N = 8 and 512 tokens against a float32 per-token
   reference on the card (``tests/test_moe.py::_ref_moe``'s form): every
   token's top-2 set equal to the reference's unless its 2nd and 3rd
   probabilities lie within MOE_ROUTE_TOL, the outputs of the others
   within MOE_TOL; then timed (CUDA events) at N = 8, 512 and 2,048 beside
   its bound, with the bytes one call allocates above its inputs.
   ``moe_bf16``: bf16 Mixtral at MOE_BF16_LAYERS of 32 layers through
   ``TorchCudaClient.build``, eight greedy requests with the step graphs
   on, then on a graphs-off twin over the same params: equal streams.
   ``moe_int8``: the one-card deployment, int8 weights at all 32 layers
   through ``TorchCudaClient.from_config``: its weight bytes must equal
   ``plan_serving``'s; eight requests of 64 new tokens (tokens a second,
   decode seconds a step, TTFT, peak memory), then eight other requests of
   16 tokens on the same engine and on a graphs-off twin: equal streams.
   Each serving run must launch K1 and K2 (int8 also K5); the kernels'
   line gives their launches with the graphs on (``moe_launches``).
   ``--moe`` runs the build and this phase alone.
24. Fine-tuning, weight checkpoints and ``chat --raw`` (after phase 23).
   ``train_attention``: the training forward's dense causal attention
   (``models/llama.py::dense_causal_attention``, plain torch ops) forward
   and forward + backward at the two fine-tunes' shapes (4 x 255 tokens;
   the 8B's 32/8 heads at head_dim 128 in bf16, the 1B's 32/8 at 64 in
   float32; CUDA events) beside their bounds and
   ``scaled_dot_product_attention``'s times. ``train_lora``:
   llama3-8b-instruct at full width and all 32 layers, bf16, served through
   ``TorchCudaClient.build`` with a registry (rank 8 over wq and wv, one
   random PEFT adapter) and speculation off; a fresh all-zero adapter is
   registered and ``train/lora_trainer.py::LoraTrainer`` tunes it for
   TRAIN_LORA_STEPS steps on one seeded 4 x 256 batch: the loss must fall
   and no kernel wrapper may launch during the steps (K5 included: the
   training forward widens int8 and has no K5). ``publish`` and the live
   engine's ``refresh_lora`` then serve it (graphs on): each prompt's greedy
   stream must differ from the base model's and equal the stream of a fresh
   engine over the same base whose registry loaded ``export_peft``'s
   directory, with the graphs on and off; the other adapter's row stays as
   it was. ``train_full``: ``train/trainer.py::Trainer`` on
   llama3.2-1b-instruct at full width (16 layers), float32, AdamW, for
   TRAIN_FULL_STEPS steps on one seeded 4 x 256 batch (the loss must fall);
   ``save_checkpoint``, ``weights info`` (the config as JSON) and
   ``load_or_init`` from the directory: every restored tensor bit-equal to
   the trained one; the restored model through ``TorchCudaClient.build
   (model_path=...)`` and the trained params in memory must serve equal
   greedy streams (the float32 kernels). Each reports ms a step, trained
   tokens a second, peak memory and its last step's device time (profiler:
   matmuls and the rest) and idle share; ``train_full`` also the checkpoint's
   bytes and its write and read seconds. ``train_chat``: ``chat --raw`` on
   the 8B at CUT_LAYERS layers with two turns piped into standard input:
   two requests, the second's prompt carrying the first turn. The serving
   runs must launch K1 and K2; the kernels' line gives their launches
   (``train_launches``). ``--train`` runs the build and this phase alone.
25. Long contexts and llama3-70b-instruct on one card (after phase 5).
   ``long_kernel``: K1 (bf16 and fp8 pools), K4 (the tp=16 call's heads on
   PG page shards), K2 (bf16 and fp8; the last 512-token chunk of a 32k
   prompt) and W1 (a decode row at 32,767 keys; that last chunk as its
   prefill row beside decode rows, bf16 and fp8) over 2,049-column tables
   (max_seq_len 32,768) and a 4,096-page pool, decode rows of up to 32,767
   keys. ``group8_kernel``: K1, K3, K2, K2-int8 and W1 at the 70B's 64/8
   heads. ``qmm_70b_kernel``: K5 at the 70B's four (K, N) shapes and M = 8
   and 64. Each against its plain version with TOL, timed beside its bound
   and SDPA's or cuBLAS's time. ``long_serve``: llama3.1-8b-instruct at 32
   layers through ``TorchCudaClient.from_config`` (bf16 weights, an fp8
   pool, ``llm.max_seq_len`` 32,768, ``llm.num_pages`` 4,096) serves a
   32,000-token prompt with phase 7's five, 32 greedy tokens each: step
   graphs on, off (equal streams), mixed dispatch on and mixed with graphs
   off (equal streams); the long request's TTFT, decode seconds a step,
   peak memory, K1/K2/W1 launches, and its first token's logits on the
   split and the mixed path (graphs off). ``long_split``: the long request alone
   at CUT_LAYERS on the unsharded engine and on the tp=16 page split (both
   page shards in use), graphs on and off: equal streams. ``big_serve``:
   llama3-70b-instruct, int8 weights at all 80 layers drawn on the card,
   through ``from_config`` over a bf16 pool sized from ``plan_serving``'s
   budget: weight bytes equal to the plan's, phase 7's five requests
   graphs on and off (equal streams), tokens a second, decode seconds a
   step, TTFT, peak memory, K5/K1/K2 launches and a profiled decode window
   (K5's device time and the rest). ``--long`` runs the build and this
   phase alone.

A ``profiler_clock`` line at the start and at the end of the run: eight
launches of one kernel under torch.profiler, without and with 100 ms of
padding, the device events each window kept and how far each kernel's
start lies after its host op's. Every profiled window that splits device
time by kernel class fails when it kept fewer of the port's kernels than
the wrappers launched in it.

Then it prints the kernels' line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profiler-clock SECONDS

runs instead that probe every PROBE_EVERY_S seconds for SECONDS, the card
busy with bf16 matmuls in between, a line a probe (no kernel is built).

    python3 chip_smoke.py --serve-ab DIR [bfloat16] [int8] [mixed]

runs instead a same-card A/B of serving phases (by default phases 7 to 9:
bf16 and int8 serving; ``mixed``: phase 14's mixed dispatch; each after an
unrecorded warm-up run, and their profiled reruns) between DIR,
another checkout of the repository (for example a parent commit unpacked
with ``git archive``), and this one, each by its own ``chip_smoke.py`` in a
fresh process, in the order DIR, this, this, DIR; every line goes to
``OUT_DIR/serve_ab.jsonl``. It lives here because a checkout's serving
phases are reached only through its own ``chip_smoke.py``, and it is the
committed source of PERF.md's same-card serving comparisons.

    python3 chip_smoke.py --kernel-ab DIR

runs instead the attention kernel phases (2, 3 and 13) of DIR and of this
checkout, each by its own ``chip_smoke.py`` in a fresh process, in the
order DIR, this, this, DIR, and writes their device times (K1 on the
decode input; K2 on the 4 x 512 prefill, the T=8 verify and the one-row
prefill; W1 in its five cases) and this checkout's mean over DIR's to
``OUT_DIR/kernel_ab.jsonl``.

    python3 chip_smoke.py --forward-ab DIR

times one mixed forward of the 8B at full depth on phase 13's served batch
(events over back-to-back forwards, device time, host time to issue one)
with DIR's package and with this one's, each in a fresh process, in the
order DIR, this, this, DIR, measured by this file's code; lines in
``OUT_DIR/forward_ab.jsonl``. The mixed path's A/B apart from the
greedy streams, which change the serving phases' dispatches.

    python3 chip_smoke.py --streams-ab DIR [CONFIG ...]

serves each unguided serving configuration (default: bfloat16, int8,
mixed, bfloat16:overlap_off, kv_split: phases 7, 9, 14 and 12) once with
DIR's package and once with this one's, each by its own ``chip_smoke.py``
in a fresh process, and fails unless their greedy streams and kernel launch
counts are equal; lines in ``OUT_DIR/streams_ab.jsonl``.

    python3 chip_smoke.py --overlap-ab

profiles each serving configuration (bf16, int8, page split) with the
overlapped pipeline on, off, off, on, after an unrecorded warm-up run, in
one process: idle share and wall of each run, in
``OUT_DIR/overlap_ab.jsonl``.
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"
ENGINE_MODEL = "llama3-8b-instruct"

# Decode-kernel shapes: the llama3-8b-instruct serving geometry.
B, N_Q, N_KV, HD, PS = 8, 32, 8, 128, 16
MAX_PAGES = 8192 // PS  # + 1 trash column
NUM_PAGES = 2048
DECODE_CTX = [0, 1, 16, 17, 1000, 8191, 300, 4097]
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: summation order only.
# bf16: both versions compute in f32 and round the output once to bf16, so
# they may differ by one bf16 ulp (at most 2**-7 relative, under RTOL).
# Each kernel phase also shows that a result with the last page of every
# sequence dropped lies outside these limits.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1e-2)}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
PEAK_BYTES_S = 3.35e12
# int8 weight matmul: llama3-8b-instruct's (K, N) per layer matrix, and the
# rows of a decode step (8 slots), of a T=8 verify (64) and two edges.
QMM_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
              "wo": (4096, 4096), "w_gate": (4096, 14336), "w_up": (4096, 14336),
              "w_down": (14336, 4096)}
QMM_ROWS = (8, 64, 5, 256)
QMM_LAYERS = 32
# Page-split checks: the pool of phases 2 and 3 cut into PG page shards.
PG = 2
# forward_tp: f32 logits of the sharded forward against the unsharded one on
# the card. The row-parallel products sum 8 or 16 partial products over a
# slice of the contraction each, in another order than one cuBLAS call, and
# the page-split attention merges two flash partials: f32 rounding only.
FORWARD_TP_TOL = 1e-3
FORWARD_TP_LAYERS = 2
TP_PAGES = 256  # engine_kv_split: about 190 pages in use cross 128 per shard
# Depth of the profiled reruns of the serving configurations but int8's, of
# every witness and of the mesh serving phases (the page split, its fp8
# pool, tp=8 over fp8): with these at full depth (the page split's checks at
# 4) the whole run took 1,067.9 s on an H100 at 700 W, too near the 1,200 s
# it must finish in; these phases took 527.4 s of it.
CUT_LAYERS = 4
WATCHDOG_S = 1140  # under the 1,200 s a run must end in, build included


_LOG = OUT_DIR / "chip_smoke.jsonl"  # every line of a run, beyond the tool's 24 KB
_START = time.perf_counter()
_since = [_START]


def emit(obj: dict) -> None:
    """Print one JSON line and keep it in ``_LOG``; a phase's line gains the
    seconds since the previous phase line (``phase_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - _since[0]}
        _since[0] = now
        print(f"chip_smoke: {obj['phase']} {obj['phase_s']:.1f} s "
              f"(at {now - _START:.1f} s)", file=sys.stderr, flush=True)
    line = json.dumps(obj)
    print(line, flush=True)
    with _LOG.open("a") as f:
        f.write(line + "\n")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler keeps only the device events that fall inside its window
# by the host's clock, and the device's clock, as CUPTI reports it, falls
# behind the host's as the process ages: kernels seemed to start 1.14 ms
# before their host ops 1,000 s into a run (0.01 ms at its start; the
# ``profiler_clock`` lines, H100 at 700 W), and a window whose first
# kernels came sooner than that after its start kept none of them. So each
# window opens and closes with this much host time around its work.
PROFILE_PAD_S = 0.01


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block (CPU and CUDA activities), padded by
    PROFILE_PAD_S before and after it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        time.sleep(PROFILE_PAD_S)


def device_ms(fn, iters: int, warmup: int = 2):
    """Device time per call of ``fn``: the kernels it launches, summed by
    torch.profiler over ``iters`` calls, without the host's gaps between
    them (for calls short enough that the host's launch rate sets the
    CUDA-event time); None (not measured) when three windows in a row kept
    fewer device kernels than calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window that lost events is taken again
        with profiled() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        if len(kernels) >= iters:
            return sum(kernels) / iters / 1e3
    return None


PROBE_CALLS = 8  # launches of the profiler's clock probe


def profiler_clock(torch, pad_s: float = 0.0) -> dict:
    """The profiler's two clocks on a known window: PROBE_CALLS launches of
    one elementwise kernel under torch.profiler, with ``pad_s`` of host
    sleep inside the window before and after them. Returns the device events
    the window kept, and for each kept kernel how far its start (the device
    clock, as CUPTI reports it) lies after the start of the host op that
    launched it (the host clock), in microseconds: a few where the clocks
    agree."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 16, device=DEVICE)
    x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(PROBE_CALLS):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    ops = sorted(e.time_range.start for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU and e.name == "aten::add_")
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
    after = [k - o for k, o in zip(kernels, ops)] if len(kernels) == len(ops) else None
    return {"process_s": time.perf_counter() - _START, "pad_ms": pad_s * 1e3,
            "calls": PROBE_CALLS, "host_ops": len(ops), "device_events": len(kernels),
            "kernel_after_op_us": after}


def phase_profiler_clock(torch, what: str) -> dict:
    """The clock probe (:func:`profiler_clock`) without padding and with
    100 ms of it."""
    return {"phase": "profiler_clock", "at": what, "unpadded": profiler_clock(torch),
            "padded": profiler_clock(torch, 0.1)}


def profiler_clock_run(torch, seconds: float) -> int:
    """The clock probe every PROBE_EVERY_S seconds for ``seconds``, the card
    kept busy with bf16 matmuls in between; a line a probe."""
    a = torch.randn((8192, 8192), device=DEVICE, dtype=torch.bfloat16)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        emit(phase_profiler_clock(torch, "run"))
        busy_until = time.perf_counter() + PROBE_EVERY_S
        while time.perf_counter() < busy_until:
            for _ in range(20):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
    return 0


PROBE_EVERY_S = 3


def graph_ms(fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` from a CUDA graph: ``iters`` calls
    captured in one graph on a side stream (after one eager call there, which
    builds what the calls make lazily), one replay timed with CUDA events,
    over ``iters``. The kernels run back to back with no host gap between
    them, as ``device_ms`` sums them, but no profiler window is needed, so
    it reads a time where the profiler records no device event."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host time per call of ``fn`` (checks, allocations, launches), calls
    back to back without a sync: what a serving step pays on the CPU."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def cold_ms(fn, iters: int = 10) -> float:
    """Time of one call of ``fn`` that finds the 50 MB L2 cold, as a serving
    step finds the pool (CUDA events, mean over ``iters`` calls): before each
    call a 256 MB write evicts the L2, and a spin kernel first keeps the
    device busy while the host enqueues the write, the events and the call,
    so that the call alone lies between the events."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # about 1 ms of device time
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    del flush
    return total / iters


def bound(n_bytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def excess(got, want, dtype_name: str):
    """|got - want| beyond the tolerance (> 0 where it fails), and |got - want|."""
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    return diff - (atol + rtol * want.float().abs()), diff


def compare(got, want, dtype_name: str, what: str) -> float:
    over, diff = excess(got, want, dtype_name)
    if not bool(diff.isfinite().all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    if float(over.max()) > 0:
        atol, rtol = TOL[dtype_name]
        raise AssertionError(f"{what}: max |err| {float(diff.max()):.3e} beyond "
                             f"atol {atol} rtol {rtol}")
    return float(diff.max())


def one_launch(what: str) -> int:
    """The kernel launches counted since ``reset_counts``: one wrapper call
    must have made exactly one (no separate merge)."""
    n = sum(counts().values())
    if n != 1:
        raise AssertionError(f"{what}: {counts()} launches for one call")
    return n


def not_slower(ms: float, library_ms: float, what: str) -> None:
    """A tensor-core decode kernel must not take longer (CUDA events) than
    the library call that computes the same function on the same inputs."""
    if ms > library_ms:
        raise AssertionError(f"{what}: {ms:.4f} ms, slower than the library's "
                             f"{library_ms:.4f} ms")


def cut_last_page(ctx):
    """Context lengths with the last (partial or full) page cut off."""
    return ((ctx - 1).clamp_min(0) // PS * PS).to(ctx.dtype)


def drop_last_page(pa, q, k, v, tables, ctx, q_start, ref, dtype_name: str,
                   gate: bool = True) -> dict:
    """What the tolerance makes of a wrong kernel: the plain version with
    the last page of every sequence dropped, held against the sound result.
    With ``gate``, fails unless the check rejects it in every sequence that
    had keys."""
    short = cut_last_page(ctx)
    wrong = pa.plain_paged_attention(q, k, v, tables, short, q_start, PS)
    over, diff = excess(wrong, ref, dtype_name)
    live = [i for i, c in enumerate(ctx.tolist()) if c > 0]
    per_row = [float(diff[i].max()) for i in live]
    rejected = [bool(over[i].max() > 0) for i in live]
    if gate and not all(rejected):
        raise AssertionError(f"{dtype_name}: the tolerance accepts a result with the "
                             f"last page dropped (rows {live}, rejected {rejected})")
    return {"max_abs_err_by_row": per_row, "rows_rejected": sum(rejected),
            "rows": len(live)}


def make_pool(gen, dtype, ctx_lens, device, n_kv: int = N_KV, hd: int = HD,
              columns: int = MAX_PAGES, pages: int = NUM_PAGES):
    """Random pools of ``pages`` pages, and tables of ``columns`` columns and
    the trash column whose live pages are distinct per sequence; entries
    past ctx point at random pages, the trash column at page 0."""
    import torch

    k = torch.randn((pages * PS, n_kv, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((pages * PS, n_kv, hd), generator=gen, device=device).to(dtype)
    tables = torch.randint(1, pages, (len(ctx_lens), columns + 1),
                           generator=gen, device=device, dtype=torch.int32)
    tables[:, columns] = 0
    perm = torch.randperm(pages - 1, generator=gen, device=device) + 1
    nxt = 0
    for i, ctx in enumerate(ctx_lens):
        need = -(-ctx // PS)
        tables[i, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    return k, v, tables


def pool_suffix(pa, pool) -> str:
    """The suffix the launch counters give a pool's calls: ``_int8``,
    ``_fp8`` or none."""
    if isinstance(pool, tuple):
        return "_int8"
    return "_fp8" if pool.dtype == pa.FP8 else ""


def dequantized(pool, dtype):
    """A pool as one tensor of ``dtype`` (an int8 pool dequantized, an fp8
    pool widened)."""
    if isinstance(pool, tuple):
        return (pool[0].float() * pool[1][..., None]).to(dtype)
    return pool.to(dtype) if pool.element_size() == 1 else pool


def token_bytes(pool) -> int:
    """Bytes of one cached token's K (or V) over the pool's kv heads."""
    if isinstance(pool, tuple):
        vals, scales = pool
        return vals.shape[1] * (vals.shape[2] * vals.element_size() + scales.element_size())
    return pool.shape[1] * pool.shape[2] * pool.element_size()


def gather_for_library(q4, k, v, tables, ctx_lens, kv_len):
    """[B, n_q, *, hd] operands for scaled_dot_product_attention (K/V
    dequantized, gathered through the tables and repeated over the GQA
    group)."""
    import torch

    k, v = dequantized(k, q4.dtype), dequantized(v, q4.dtype)
    n_pages = -(-kv_len // PS)
    rows = (tables[:, :n_pages].long()[:, :, None] * PS
            + torch.arange(PS, device=k.device)).reshape(len(ctx_lens), -1)
    group = q4.shape[2] // k.shape[1]
    kk = k[rows].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v[rows].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    return q4.permute(0, 2, 1, 3).contiguous(), kk, vv


def phase_build() -> dict:
    from runbookai_tpu_torch.ops import build

    t0 = time.perf_counter()
    path, report = build.build()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text(report)
    return {"phase": "build", "library": str(path.relative_to(ROOT)),
            "seconds": time.perf_counter() - t0}


def decode_case(pa, torch, q, k, v, tables, ctx, name: str, gate_drop: bool = True) -> dict:
    """Decode kernel against its plain version on one pool (a tensor or an
    int8 tuple), the dropped-last-page check (gated with ``gate_drop``), and
    its times (CUDA events over back-to-back calls and, L2 cold, one call at
    a time; profiler device time; host time a call), its route and split
    count, and its bound."""
    import torch.nn.functional as F

    dev = q.device
    ctx_l = ctx.tolist()
    pool = k[0] if isinstance(k, tuple) else k
    n_q, hd = q.shape[1:]

    def call():
        return pa.paged_decode_attention(q, k, v, tables, ctx, PS)

    reset_counts()
    out = call()
    per_call = one_launch(f"decode {name} {list(q.shape)}")
    ref = pa.plain_paged_attention(q[:, None], k, v, tables, ctx, None, PS)[:, 0]
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"decode {name}")
    if any(bool(out[i].abs().max() != 0) for i, c in enumerate(ctx_l) if c == 0):
        raise AssertionError("decode: a ctx-0 row must be zeros")
    wrong = drop_last_page(pa, q[:, None], k, v, tables, ctx, None,
                           ref[:, None], name, gate=gate_drop)
    ms = time_ms(call)
    plain_ms = time_ms(lambda: pa.plain_paged_attention(
        q[:, None], k, v, tables, ctx, None, PS), iters=3, warmup=1)
    q4, kk, vv = gather_for_library(q[:, None], k, v, tables, ctx_l, max(ctx_l))
    mask = (torch.arange(kk.shape[2], device=dev)[None, :] < ctx[:, None].long()
            )[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del kk, vv
    tokens = sum(ctx_l)
    n_bytes = (2 * q.numel() * q.element_size() + tokens * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in ctx_l) * 4 + len(ctx_l) * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * tokens * n_q * hd, name)
    route = pa.decode_route(q.dtype, hd, pool.dtype)
    if route == "mma":
        not_slower(ms, library_ms, f"decode {name} {list(q.shape)}")
    plan = pa.decode_plan(q.shape[0], n_q, pool.shape[1], hd, tables.shape[1])
    return {"route": route, "splits": plan.splits if route == "mma" else 1,
            "heads": [n_q, pool.shape[1]], "head_dim": hd, "launches_per_call": per_call,
            "max_abs_err": err, "tol": TOL[name], "ms": ms, "cold_ms": cold_ms(call),
            "device_ms": device_ms(call, iters=20), "graph_ms": graph_ms(call),
            "host_ms": host_ms(call), "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ctx_lens": ctx_l,
            "drop_last_page": wrong}


# A second geometry for the tensor-core decode kernels: the catalogue's
# head_dim-64 model (llama3.2-1b-instruct: 32 query heads over 8 kv heads).
HD64 = (32, 8, 64)


def phase_decode(pa, torch, int8: bool = False) -> dict:
    """K1 over bf16 and f32 pools or, with ``int8``, K3 over int8 pools
    quantized from them, with queries of the same two types, on the decode
    input (ctx 0..8191); bf16 queries (the tensor-core kernel) also at
    head_dim 64 (``hd64``) and, for K1, on the served contexts (at most 950
    tokens)."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3 if int8 else 1)
    result: dict = {"phase": "decode_int8_kernel" if int8 else "decode_kernel",
                    "ctx_lens": DECODE_CTX}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        inputs = [("decode", DECODE_CTX, (N_Q, N_KV, HD))]
        if dtype == torch.bfloat16:
            inputs.append(("hd64", DECODE_CTX, HD64))
            if not int8:
                inputs.append(("served", SERVED_CTX, (N_Q, N_KV, HD)))
        for kind, ctx_l, (n_q, n_kv, hd) in inputs:
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
            k, v, tables = make_pool(gen, dtype, ctx_l, dev, n_kv, hd)
            if int8:
                k, v = quantize_kv(k), quantize_kv(v)
            q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(dtype)
            case = decode_case(pa, torch, q, k, v, tables, ctx, name)
            if kind == "decode":
                result[name] = case
            else:
                result[name][kind] = case
            del k, v
    return result


# Served contexts before a T=8 verify: the serving phases' prompts (83 to
# 918 tokens) plus their completions; every ctx at most 950.
SERVED_CTX = [83, 150, 266, 397, 512, 640, 800, 942]


def chunk_inputs(torch, dev, gen, dtype, kind, geo=(N_Q, N_KV, HD), columns: int = MAX_PAGES,
                 pages: int = NUM_PAGES):
    """(q, k, v, tables, ctx, positions, real tokens per row) over
    :func:`make_pool`'s ``columns`` and ``pages``. ``tp8_shard``
    is the verify input cut to one head shard of tp=8: 4 query heads over
    1 kv head. ``prefill_one_row`` is the engine's prefill of a single row
    (padded to 512 tokens): 256 blocks of 64 rows, so ``chunk_plan`` splits
    it in two; at offset 4096 both splits hold keys, and causal rows.
    ``prefill_32k`` is the same row as the last chunk of a 32k prompt
    (tables of LONG_TABLE columns)."""
    trash = columns * PS
    if kind == "prefill":  # 4 x 512 tokens at offsets 0 and 512
        t, starts, real = 512, [0, 512, 0, 512], [512] * 4
    elif kind == "prefill_one_row":  # 512 tokens at offset 4096: ctx 4608, 288 columns
        t, starts, real = 512, [4096], [512]
    elif kind == "prefill_32k":  # a 32k prompt's last chunk: ctx 32,768 (phase 25)
        t, starts, real = 512, [LONG_CHUNK_START], [512]
    elif kind in ("verify", "tp8_shard", "verify_served"):  # T=8 from ctx-1
        t = 8
        before = (SERVED_CTX if kind == "verify_served"
                  else [1, 16, 17, 1000, 8100, 300, 4097, 64])
        starts, real = [c - 1 for c in before], [8] * 8
    else:  # pad tail: 100 real tokens, a full chunk, a pad row, 37 tokens
        t, starts, real = 512, [0, 512, trash, 1024], [100, 512, 0, 37]
    ctx_lens = [s + n if n else 1 for s, n in zip(starts, real)]
    n_q, n_kv, hd = geo  # query heads, kv heads, head_dim
    k, v, tables = make_pool(gen, dtype, ctx_lens, dev, n_kv, hd, columns, pages)
    pos = torch.full((len(starts), t), trash, dtype=torch.int32, device=dev)
    for i, (s, n) in enumerate(zip(starts, real)):
        if n:
            pos[i, :n] = torch.arange(s, s + n, dtype=torch.int32, device=dev)
        else:
            tables[i] = 0  # the engine's pad row: null table, ctx 1
    q = torch.randn((len(starts), t, n_q, hd), generator=gen, device=dev).to(dtype)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    if kind == "tp8_shard":
        n_q = N_Q // N_KV
        q, k, v = q[..., :n_q, :].contiguous(), k[:, :1].contiguous(), v[:, :1].contiguous()
    return q, k, v, tables, ctx, pos, real


def time_chunk(pa, torch, q, k, v, tables, ctx, pos, dtype_name: str) -> dict:
    """Kernel, plain-version and SDPA times of one chunk call, and its bound."""
    import torch.nn.functional as F

    dev = q.device
    q_start = pos[:, 0].contiguous()

    def call():
        return pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: pa.plain_paged_attention(
        q, k, v, tables, ctx, q_start, PS), iters=3, warmup=1)
    t = q.shape[1]
    q4, kk, vv = gather_for_library(q, k, v, tables, ctx.tolist(), int(ctx.max()))
    kpos = torch.arange(kk.shape[2], device=dev)
    qpos = pos[:, :1].long() + torch.arange(t, device=dev)
    mask = ((kpos[None, None, :] < ctx[:, None, None].long())
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del kk, vv
    ctx_l, start_l = ctx.tolist(), q_start.tolist()
    pairs = sum(min(c, s + i + 1) for c, s in zip(ctx_l, start_l) for i in range(t))
    n_bytes = (2 * q.numel() * q.element_size() + sum(ctx_l) * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in ctx_l) * 4 + 2 * len(ctx_l) * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * q.shape[2] * HD, dtype_name)
    return {"ms": ms, "device_ms": device_ms(call, iters=10), "graph_ms": graph_ms(call),
            "cold_ms": cold_ms(call), "host_ms": host_ms(call), "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def unsplit_case(pa, torch, q, k, v, tables, ctx, pos, ref, dtype_name: str) -> dict:
    """The tensor-core kernel on a split input run unsplit (one block per
    sequence, kv head and row tile walks every column, no merge), held
    against the plain version, with its times: what the split buys, or
    costs, at this input."""
    import dataclasses

    ks = vs = None
    if isinstance(k, tuple):
        (k, ks), (v, vs) = k, v
    b, t, n_q, hd = q.shape
    plan = pa.chunk_plan(b, t, n_q, k.shape[1], hd, tables.shape[1])
    whole = dataclasses.replace(plan, splits=1, cols=tables.shape[1], workspace_bytes=0)
    q_start = pos[:, 0].contiguous()

    def call():
        return pa._chunk_mma(q, k, v, ks, vs, tables, ctx, q_start, PS, whole)

    err = compare(call(), ref, dtype_name, f"chunk unsplit {dtype_name}")
    return {"max_abs_err": err, "ms": time_ms(call), "device_ms": device_ms(call, iters=10)}


# Inputs of the chunk phases: f32 queries (the CUDA-core kernel) on the first
# three, bf16 queries (the tensor-core kernel) on all six. The prefill and the
# verify inputs are timed for both, the last three for bf16; a split bf16
# input is also timed unsplit.
CHUNK_KINDS = ("prefill", "verify", "pad_tail")
MMA_KINDS = CHUNK_KINDS + ("prefill_one_row", "verify_served", "tp8_shard")


def chunk_plan_of(pa, q, k, tables):
    """``chunk_plan`` of a chunk call on these inputs (k a pool or an int8
    tuple)."""
    b, t, n_q, hd = q.shape
    n_kv = (k[0] if isinstance(k, tuple) else k).shape[1]
    return pa.chunk_plan(b, t, n_q, n_kv, hd, tables.shape[1])


def merge_case(pa, torch, q, k, v, tables, ctx, q_start) -> dict:
    """The merge kernel against ``merge_partials`` and the cast, in bf16 and
    f32, on the plain partials of the splits ``chunk_plan`` gives these
    inputs; its times, and its bound (the partials read once, the output
    written once)."""
    plan = chunk_plan_of(pa, q, k, tables)
    acc, m, l = pa.plain_chunk_partials(q, k, v, tables, ctx, q_start, PS, plan.cols)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        got = pa.chunk_merge(acc, m, l, dtype)
        want = pa.merge_partials(list(zip(acc, m, l)), q.device).to(dtype)
        torch.cuda.synchronize()
        errs[name] = compare(got, want, name, f"chunk merge of {plan.splits} splits ({name})")
    n_bytes = 4 * (acc.numel() + m.numel() + l.numel()) + 2 * acc[0].numel()
    bound_ms, bound_by = bound(n_bytes, 3.0 * acc.numel(), "float32")

    def merge():
        return pa.chunk_merge(acc, m, l, torch.bfloat16)

    return {"splits": plan.splits, "max_abs_err": errs["bfloat16"], "errs": errs,
            "ms": time_ms(merge), "device_ms": device_ms(merge, iters=20),
            "graph_ms": graph_ms(merge), "cold_ms": cold_ms(merge),
            "plain_ms": time_ms(lambda: pa.merge_partials(list(zip(acc, m, l)), q.device)
                                .to(torch.bfloat16), iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_chunk(pa, torch, int8: bool = False) -> dict:
    """The chunk kernels over bf16 and f32 pools or, with ``int8``, over int8
    pools quantized from them: bf16 queries on the tensor-core kernel with
    its split count per input, f32 queries on the CUDA-core kernel; the
    merge kernel on the verify input's splits."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4 if int8 else 2)
    result: dict = {"phase": "chunk_int8_kernel" if int8 else "chunk_kernel"}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        mma = dtype == torch.bfloat16
        errs, wrong, timed, splits = {}, {}, {}, {}
        for kind in (MMA_KINDS if mma else CHUNK_KINDS):
            q, k, v, tables, ctx, pos, real = chunk_inputs(torch, dev, gen, dtype, kind)
            if int8:
                k, v = quantize_kv(k), quantize_kv(v)
            q_start = pos[:, 0].contiguous()
            splits[kind] = chunk_plan_of(pa, q, k, tables).splits
            out = pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)
            ref = pa.plain_paged_attention(q, k, v, tables, ctx, q_start, PS)
            torch.cuda.synchronize()
            errs[kind] = compare(out, ref, name, f"chunk {kind} {name}")
            # The engine's pad row has ctx 1 on the null page: not a sequence.
            live = [i for i, n in enumerate(real) if n]
            sel = torch.tensor(live, device=dev)
            wrong[kind] = drop_last_page(pa, q[sel], k, v, tables[sel], ctx[sel],
                                         q_start[sel], ref[sel], name)
            # Time the prefill input (the heaviest chunk call), the T=8
            # verify (most of the main path's chunk launches) and, in bf16,
            # the one-row prefill, the verify at the served contexts and on
            # one tp=8 head shard.
            if kind != "pad_tail":
                timed[kind] = time_chunk(pa, torch, q, k, v, tables, ctx, pos, name)
                if mma and splits[kind] > 1:
                    timed[kind]["unsplit"] = unsplit_case(pa, torch, q, k, v, tables, ctx,
                                                          pos, ref, name)
            if mma and kind == "verify":
                timed["merge"] = merge_case(pa, torch, q, k, v, tables, ctx, q_start)
            del q, k, v, out, ref
        result[name] = {"route": "mma" if mma else "cuda_core",
                        "max_abs_err": max(errs.values()), "errs": errs, "splits": splits,
                        "tol": TOL[name], **timed.pop("prefill"), **timed,
                        "drop_last_page": wrong}
    return result


# The serving configuration's mixed batch (EngineCore._run_mixed): one
# 8-token block per decode slot, then the 512-token prefill budget; rows =
# 8 slots + 4 prefill rows + the null row. N = 576 tokens in 72 blocks.
RQ = 8
MIX_PF_TOKENS = 512
MIX_PF_START = 4096  # the prefill row's offset in the ragged inputs
MIX_ROWS = B + 4 + 1
# Ragged inputs: decode contexts per slot (None = a free slot, whose block is
# a pad block of the null row) and the prefill row's tokens at offset 4096
# (at a third entry's offset where there is one).
# "long" ends its prefill region with a pad block (500 tokens in 63 blocks).
RAGGED_KINDS = {"served": (SERVED_CTX, 512),
                "long": ([1, 16, 17, 1000, 8191, 300, 4097, None], 500)}
# Geometries beyond the 8B's (query heads, kv heads, head_dim):
# qwen2-7b-instruct's group of 7, llama3.2-1b-instruct's head_dim 64.
RAGGED_GEOMETRIES = {"group7": (28, 4, 128), "hd64": HD64}


def ragged_inputs(torch, dev, gen, dtype, kind, n_q=N_Q, n_kv=N_KV, hd=HD,
                  columns: int = MAX_PAGES, pages: int = NUM_PAGES):
    """A flat mixed batch in the engine's layout over :func:`make_pool`'s
    ``columns`` and ``pages``: (q [N, n_q, hd], k, v, tables [R, P + 1],
    ctx [R], positions [N], row_ids [N], the indices of the tokens of pad
    blocks). The prefill row starts at MIX_PF_START, or where the kind
    says."""
    dec_ctx, pf_len, *start = {**RAGGED_KINDS, **RAGGED_LONG_KINDS}[kind]
    trash, null, pf_start = columns * PS, MIX_ROWS - 1, (start or [MIX_PF_START])[0]
    ctx_rows = [c or 0 for c in dec_ctx] + [pf_start + pf_len] + [0] * (MIX_ROWS - B - 1)
    k, v, tables = make_pool(gen, dtype, ctx_rows, dev, n_kv, hd, columns, pages)
    n = B * RQ + MIX_PF_TOKENS
    pos = torch.full((n,), trash, dtype=torch.int32, device=dev)
    rows = torch.full((n,), null, dtype=torch.int32, device=dev)
    for s, c in enumerate(dec_ctx):
        if c:
            pos[s * RQ] = c - 1
            rows[s * RQ:(s + 1) * RQ] = s
    off = B * RQ
    pos[off:off + pf_len] = torch.arange(pf_start, pf_start + pf_len, dtype=torch.int32,
                                         device=dev)
    rows[off:off + -(-pf_len // RQ) * RQ] = B
    for r, c in enumerate(ctx_rows):
        if not c:
            tables[r] = 0  # the engine's null rows
    ctx = torch.tensor(ctx_rows, dtype=torch.int32, device=dev)
    q = torch.randn((n, n_q, hd), generator=gen, device=dev).to(dtype)
    pads = [i for i, r in enumerate(rows.tolist()) if ctx_rows[r] == 0]
    return q, k, v, tables, ctx, pos, rows, pads


def modeled_kv_bytes(pa, plan, k) -> dict:
    """A model, not a measurement: the key visits of the ragged kernel's
    live tiles (``ragged_plan``; each tile loads its keys for its kv head,
    from L2 or device memory) and those visits times the K and V bytes of a
    key and kv head. No byte counter of the card is read."""
    pool = k[0] if isinstance(k, tuple) else k
    per_key = 2 * token_bytes(k) // pool.shape[1]  # K and V of one kv head
    live = int(plan.live)
    visits = int(plan.weight[:live].sum())
    return {"tiles": live, "modeled_key_visits": visits,
            "modeled_kv_bytes": visits * per_key}


def modeled_k2_block_bytes(k, block_ctx, block_start) -> int:
    """The same model for K2's kernel at ``[N / 8, 8]`` on the same batch, as
    W1 ran before: each block visits the keys below min(ctx, its last
    position + 1), every kv head."""
    return sum(max(0, min(c, s + RQ)) for c, s in zip(block_ctx, block_start)) * 2 * \
        token_bytes(k)


def plan_case(pa, torch, rows, ctx, pos, n_q: int, n_kv: int, hd: int, p: int) -> dict:
    """W1's tile list: the kernel (``ragged_plan``, one launch a call)
    against its plain version (``plain_ragged_plan``, tensor ops on the
    card), record for record; their times, and the bound of the kernel's
    bytes (the blocks' row ids and positions and the rows' contexts read
    once, the records, weights and live count written once)."""
    def kernel():
        return pa.ragged_plan(rows, ctx, pos, n_q, n_kv, hd, p, PS, RQ)

    def plain():
        return pa.plain_ragged_plan(rows, ctx, pos, n_q, n_kv, hd, p, PS, RQ)

    reset_counts()
    got = kernel()
    torch.cuda.synchronize()
    launched = counts()
    if launched["ragged_plan"] != 1 or sum(launched.values()) != 1:
        raise AssertionError(f"ragged_plan: {launched} launches for one call")
    want = plain()
    diff = max(int((got.tiles - want.tiles).abs().max()),
               int((got.weight - want.weight).abs().max()), abs(int(got.live) - int(want.live)))
    if diff:
        raise AssertionError(f"ragged_plan: the kernel's list differs from the plain "
                             f"version's by up to {diff}")
    names = kernel_names(torch, kernel, 2)
    if len(names) != 2 or not all(PLAN_KERNEL in nm for nm in names):
        raise AssertionError(f"ragged_plan: 2 calls ran {names}, not 2 x {PLAN_KERNEL}")
    n_bytes = (2 * (rows.numel() // RQ) * 4 + ctx.numel() * 4
               + got.tiles.numel() * 4 + got.weight.numel() * 4 + 4)
    bound_ms, bound_by = bound(n_bytes, 0.0, "bfloat16")
    return {"max_abs_err": diff, "records": got.tiles.shape[0], "live": int(got.live),
            "ms": time_ms(kernel), "device_ms": device_ms(kernel, iters=10),
            "graph_ms": graph_ms(kernel), "cold_ms": cold_ms(kernel), "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain, iters=10),
            "plain_host_ms": host_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


RAGGED_KERNEL = "ragged_attention_kernel<"
PLAN_KERNEL = "ragged_plan_kernel"


def ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, name: str) -> dict:
    """W1 against its plain version (the blocks' tables gathered, then the
    plain chunk attention), pad blocks exactly zero; the per-layer launch on
    a tile list built beforehand (``ragged_tile_attention``, as the ragged
    forward makes it): one ragged kernel a call, no merge launch and no
    allocation but the output after the first call; its times (events,
    device, L2-cold, host) beside its bound and SDPA on each block's gathered
    K/V with its causal mask; the list's kernel against its plain version
    (:func:`plan_case`) and the whole call (``paged_ragged_attention``: list,
    then launch); the tile count, and the modeled key visits and K/V bytes
    a call beside K2's at ``[N / 8, 8]`` (a model, not a measurement)."""
    import torch.nn.functional as F

    n, n_q, hd = q.shape
    nb = n // RQ
    pool = k[0] if isinstance(k, tuple) else k
    name_w1 = "paged_ragged_attention" + pool_suffix(pa, k)

    plan_res = plan_case(pa, torch, rows, ctx, pos, n_q, pool.shape[1], hd, tables.shape[1])
    plan = pa.ragged_plan(rows, ctx, pos, n_q, pool.shape[1], hd, tables.shape[1], PS, RQ)

    def call():
        return pa.ragged_tile_attention(q, k, v, tables, ctx, pos, rows, plan, PS)

    def whole():
        return pa.paged_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, ragged_block=RQ)

    reset_counts()
    out = call()
    torch.cuda.synchronize()
    launched = counts()
    per_call = sum(launched.values())
    if per_call != 1 or launched[name_w1] != 1:
        raise AssertionError(f"ragged {name}: {launched} launches for one call")
    names = kernel_names(torch, call, 4)
    if len(names) != 4 or not all(RAGGED_KERNEL in nm for nm in names):
        raise AssertionError(f"ragged {name}: 4 calls ran {names}, not 4 x {RAGGED_KERNEL}")
    before = torch.cuda.memory_allocated()
    again = call()
    grew = torch.cuda.memory_allocated() - before
    del again
    if grew != out.numel() * out.element_size():
        raise AssertionError(f"ragged {name}: a call allocated {grew} bytes, its output "
                             f"{out.numel() * out.element_size()}")

    def plain():
        return pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, RQ)

    ref = plain()
    torch.cuda.synchronize()
    err = compare(out, ref, "bfloat16", f"ragged {name}")
    err_whole = compare(whole(), ref, "bfloat16", f"ragged {name} (whole call)")
    if pads and bool((out[pads] != 0).any()):
        raise AssertionError(f"ragged {name}: a pad block is not exactly zero")
    block_rows = rows.view(nb, RQ)[:, 0].long()
    bt, bc = tables[block_rows], ctx[block_rows]
    qb, pb = q.view(nb, RQ, n_q, hd), pos.view(nb, RQ)
    q_start = pb[:, 0].contiguous()
    ctx_l, start_l = bc.tolist(), q_start.tolist()
    q4, kk, vv = gather_for_library(qb, k, v, bt, ctx_l, int(ctx.max()))
    kpos = torch.arange(kk.shape[2], device=q.device)
    qpos = q_start[:, None].long() + torch.arange(RQ, device=q.device)
    mask = ((kpos[None, None, :] < bc[:, None, None].long())
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del q4, kk, vv, mask
    # Work the kernel does on these inputs: every query of a block (a decode
    # block's seven pads included) over its row's causal keys; bytes: q in,
    # out, each row's context of K and V once, the tables' live entries.
    pairs = sum(min(c, s + t + 1) for c, s in zip(ctx_l, start_l) for t in range(RQ))
    row_ctx = ctx.tolist()
    n_bytes = (2 * q.numel() * q.element_size() + sum(row_ctx) * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in row_ctx) * 4 + 2 * n * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * n_q * hd, "bfloat16")
    return {"max_abs_err": err, "max_abs_err_whole_call": err_whole, "tol": TOL["bfloat16"],
            "pad_tokens": len(pads),
            "pad_max_abs": float(out[pads].abs().max()) if pads else None,
            "launches_per_call": per_call, "kernel": names[0][:80], "allocated_per_call": grew,
            "ctas": plan.shape.ctas, "capacity": plan.shape.capacity,
            "keys_per_split": plan.shape.keys_per_split,
            "splits": max(1, int(plan.tiles[:int(plan.live), 7].max())),
            **modeled_kv_bytes(pa, plan, k),
            "modeled_kv_bytes_k2_blocks": modeled_k2_block_bytes(k, ctx_l, start_l),
            "ms": time_ms(call), "device_ms": device_ms(call, iters=10),
            "graph_ms": graph_ms(call), "cold_ms": cold_ms(call), "host_ms": host_ms(call),
            "plan": plan_res,
            "call_device_ms": device_ms(whole, iters=10),
            "plain_ms": time_ms(plain, iters=2, warmup=1),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "decode_ctx": ctx_l[:B], "q": list(q.shape)}


def wide_runs_case(pa, torch, dev, gen) -> dict:
    """W1 on more long decode rows than split: 18 one-block rows of 1,100
    to 1,440 keys (two splits of 1,088 each), a 64-token prefill at offset
    512 and two pad blocks. The first 16 rows split in their workspace
    slots, the last two walk their keys in one tile; against the plain
    version (whole call: list, then launch), pad blocks exactly zero."""
    slots, pf_len, pf_start = 18, 64, 512
    ctx_rows = [1100 + 20 * s for s in range(slots)] + [pf_start + pf_len, 0]
    null = len(ctx_rows) - 1
    k, v, tables = make_pool(gen, torch.bfloat16, ctx_rows, dev)
    tables[null] = 0
    n = slots * RQ + pf_len + 2 * RQ
    pos = torch.full((n,), MAX_PAGES * PS, dtype=torch.int32, device=dev)
    rows = torch.full((n,), null, dtype=torch.int32, device=dev)
    for s_ in range(slots):
        pos[s_ * RQ] = ctx_rows[s_] - 1
        rows[s_ * RQ:(s_ + 1) * RQ] = s_
    off = slots * RQ
    pos[off:off + pf_len] = torch.arange(pf_start, pf_start + pf_len, dtype=torch.int32,
                                         device=dev)
    rows[off:off + pf_len] = slots
    ctx = torch.tensor(ctx_rows, dtype=torch.int32, device=dev)
    q = torch.randn((n, N_Q, HD), generator=gen, device=dev).to(torch.bfloat16)
    plan = pa.ragged_plan(rows, ctx, pos, N_Q, N_KV, HD, tables.shape[1], PS, RQ)
    want = pa.plain_ragged_plan(rows, ctx, pos, N_Q, N_KV, HD, tables.shape[1], PS, RQ)
    if not all(torch.equal(getattr(plan, f), getattr(want, f))
               for f in ("tiles", "live", "weight")):
        raise AssertionError("wide runs: the tile list kernel differs from its plain version")
    live = plan.tiles[:int(plan.live)]
    split_rows = sorted({int(t[1]) // RQ for t in live if int(t[7]) > 1})
    if split_rows != list(range(pa.RAGGED_SPLIT_RUNS)):
        raise AssertionError(f"wide runs: rows {split_rows} split, not the first "
                             f"{pa.RAGGED_SPLIT_RUNS}")
    out = pa.paged_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, ragged_block=RQ)
    ref = pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, RQ)
    err = compare(out, ref, "bfloat16", "ragged wide runs")
    pads = list(range(n - 2 * RQ, n))
    if bool((out[pads] != 0).any()):
        raise AssertionError("ragged wide runs: a pad block is not exactly zero")
    return {"max_abs_err": err, "split_rows": len(split_rows),
            "unsplit_wide_rows": slots - len(split_rows), "tiles": int(plan.live),
            "q": list(q.shape)}


def phase_ragged(pa, torch) -> dict:
    """W1 (``paged_ragged_attention``; its per-layer launch
    ``ragged_tile_attention``) on the card at the serving configuration's
    mixed shape (N = 576, R = 13): 8 decode rows at the served contexts with
    a 512-token prefill at offset 4096; 7 decode rows up to 8191 tokens, a
    free slot and a 500-token prefill ending in a pad block; the latter over
    an int8 pool and at two more geometries (a GQA group of 7, head_dim 64).
    Then more long decode rows than split (:func:`wide_runs_case`). Beside
    them, in the same phase, K2 on its one-row prefill of 512 tokens at
    offset 4096 (the served case's prefill row alone)."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    result: dict = {"phase": "ragged_kernel", "rows": MIX_ROWS, "tokens": B * RQ + MIX_PF_TOKENS}
    for kind in RAGGED_KINDS:
        q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(torch, dev, gen,
                                                              torch.bfloat16, kind)
        result[kind] = ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, kind)
        if kind == "long":
            k8, v8 = quantize_kv(k), quantize_kv(v)
            result["int8"] = ragged_case(pa, torch, q, k8, v8, tables, ctx, pos, rows, pads,
                                         "long int8")
            del k8, v8
        del q, k, v
    for geo, (n_q, n_kv, hd) in RAGGED_GEOMETRIES.items():
        q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(
            torch, dev, gen, torch.bfloat16, "long", n_q, n_kv, hd)
        result[geo] = {"heads": [n_q, n_kv], "head_dim": hd,
                       **ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, geo)}
        del q, k, v
    q, k, v, tables, ctx, pos, _ = chunk_inputs(torch, dev, gen, torch.bfloat16,
                                                "prefill_one_row")

    def k2_call():
        return pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)

    result["k2_one_row_prefill"] = {"device_ms": device_ms(k2_call, iters=10),
                                    "cold_ms": cold_ms(k2_call), "ms": time_ms(k2_call)}
    del q, k, v
    result["wide_runs"] = wide_runs_case(pa, torch, dev, gen)
    result["max_abs_err"] = max(result[x]["max_abs_err"]
                                for x in (*RAGGED_KINDS, "int8", *RAGGED_GEOMETRIES,
                                          "wide_runs"))
    return result


def owned_work(tables, ctx, q_start, t: int, shard: int, pages_local: int):
    """What page shard ``shard`` must do for these inputs: (keys on its pages
    below ctx, causal (query, key) pairs over them, page-table entries read)."""
    import numpy as np

    tab = tables.cpu().numpy()
    starts = None if q_start is None else q_start.tolist()
    keys = pairs = entries = 0
    for i, c in enumerate(ctx.tolist()):
        n_pages = -(-c // PS)
        if starts is not None:
            last = starts[i] + t - 1
            n_pages = min(n_pages, last // PS + 1) if last >= 0 else 0
        entries += n_pages
        owned = np.repeat(tab[i, :n_pages] // pages_local == shard, PS)[:c]
        keys += int(owned.sum())
        if starts is None:
            pairs += int(owned.sum())
        else:
            cum = np.concatenate([[0], np.cumsum(owned)])
            lim = np.clip(np.minimum(len(owned), starts[i] + np.arange(t) + 1), 0, None)
            pairs += int(cum[lim].sum())
    return keys, pairs, entries


def library_partial(torch, q4, k_local, v_local, tables, ctx, q_start, shard: int,
                    pages_local: int):
    """One PyTorch call that computes page shard ``shard``'s flash partial in
    normalised form: memory-efficient SDPA with its log-sum-exp (out = acc /
    l, lse = m + log l) over the keys the shard owns, gathered through the
    tables beforehand and repeated over the GQA group, with ctx and
    causality in an additive bias. Returns the call (timed here, never made
    by the port) and a check of its result against the kernel's (acc, m,
    l): max |err| of out and of lse over the rows that saw a key."""
    import numpy as np

    b, t, n_q, _ = q4.shape
    dev = q4.device
    tab = tables.cpu().numpy().astype(np.int64)
    rows, kpos = [], []
    for i, c in enumerate(ctx.tolist()):
        n_pages = -(-c // PS)
        pages, pos = tab[i, :n_pages], np.arange(n_pages * PS)
        keep = np.repeat(pages // pages_local == shard, PS) & (pos < c)
        local = np.repeat(pages - shard * pages_local, PS) * PS + pos % PS
        rows.append(local[keep])
        kpos.append(pos[keep])
    s = max(16, -(-max(map(len, rows)) // 16) * 16)  # bias rows 16-aligned
    row_t = np.zeros((b, s), np.int64)
    pos_t = np.full((b, s), -1, np.int64)  # -1: a pad key
    for i, (r, p) in enumerate(zip(rows, kpos)):
        row_t[i, :len(r)], pos_t[i, :len(p)] = r, p
    row_t, pos_t = torch.from_numpy(row_t).to(dev), torch.from_numpy(pos_t).to(dev)
    group = n_q // k_local.shape[1]
    k_local, v_local = dequantized(k_local, q4.dtype), dequantized(v_local, q4.dtype)
    kk = k_local[row_t].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v_local[row_t].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    qq = q4.permute(0, 2, 1, 3).contiguous()
    allowed = (pos_t >= 0)[:, None, :].expand(b, t, s)
    if q_start is not None:
        qpos = q_start[:, None].long() + torch.arange(t, device=dev)
        allowed = allowed & (pos_t[:, None, :] <= qpos[:, :, None])
    bias = torch.zeros((b, n_q, t, s), dtype=q4.dtype, device=dev)
    bias.masked_fill_(~allowed[:, None], float("-inf"))

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(qq, kk, vv, bias, True)

    def check(acc, m, l) -> dict:  # [B, T, n_q, hd], [B, T, n_q], [B, T, n_q]
        out, lse = call()[:2]
        seen = l > 0
        want = acc / l.clamp_min(1e-30)[..., None]
        err = (out.permute(0, 2, 1, 3).float() - want).abs()[seen]
        lse_err = (lse[:, :, :t].permute(0, 2, 1).float() - (m + l.log())).abs()[seen]
        return {"out": float(err.max()), "lse": float(lse_err.max())}

    return call, check


def shard_case(pa, torch, q, k, v, tables, ctx, q_pos, name: str,
               gate_drop: bool = True) -> dict:
    """The partial kernel on each of PG page shards of (k, v) against its
    plain version (acc, m and l); the merge of all shards against K1 (decode,
    ``q_pos`` None) or K2 on the unsplit pool; the dropped-last-page check on
    the merged result (gated with ``gate_drop``); per call, that is per page
    shard: kernel, plain and library times and bounds (the owned pages'
    bytes, or the operations on them), and their means over the shards'
    calls."""
    from runbookai_tpu_torch.parallel.kv_split import merge_partials

    decode = q_pos is None
    pages_local = k.shape[0] // PS // PG
    ks, vs = k.chunk(PG), v.chunk(PG)  # page shard s: global pages [s, s + 1) * pages_local
    q_start = None if decode else q_pos[:, 0].contiguous()
    q4 = q[:, None] if decode else q
    what = "decode partial" if decode else "chunk partial"

    def kernel(s):
        if decode:
            return pa.paged_decode_attention_partial(q, ks[s], vs[s], tables, ctx, s, PS,
                                                     pages_local)
        return pa.paged_chunk_attention_partial(q, ks[s], vs[s], tables, ctx, q_pos, s, PS,
                                                pages_local)

    def plain(s):
        acc, m, l = pa.plain_paged_attention_partial(q4, ks[s], vs[s], tables, ctx, q_start,
                                                     PS, s, pages_local)
        return (acc[:, 0], m[:, 0], l[:, 0]) if decode else (acc, m, l)

    def guarded(s):
        """The kernel on shard s's slice set between pages of NaN that
        stand for every other shard's pages (local ids below 0 and past
        pages_local): a foreign page loaded would turn the result NaN."""
        slices = []
        for x in (ks[s], vs[s]):
            raw = x.view(torch.uint8) if x.element_size() == 1 else x  # fp8: its bytes
            nan = (torch.full_like(raw, 0x7F) if x.element_size() == 1  # e4m3's NaN
                   else torch.full_like(x, float("nan")))
            slices.append(torch.cat([nan, raw, nan])[x.shape[0]:2 * x.shape[0]].view(x.dtype))
        if decode:
            return pa.paged_decode_attention_partial(q, *slices, tables, ctx, s, PS,
                                                     pages_local)
        return pa.paged_chunk_attention_partial(q, *slices, tables, ctx, q_pos, s, PS,
                                                pages_local)

    parts, errs = [], []
    for s in range(PG):
        reset_counts()
        got = kernel(s)
        per_call = one_launch(f"{what} {name} shard {s}")
        want = plain(s)
        torch.cuda.synchronize()
        errs.append(max(compare(g, w, name, f"{what} {name} shard {s} {field}")
                        for g, w, field in zip(got, want, ("acc", "m", "l"))))
        if not all(torch.equal(g, x) for g, x in zip(got, guarded(s))):
            raise AssertionError(f"{what} {name} shard {s}: the result moved with the "
                                 f"other shards' pages set to NaN")
        parts.append(got)
    merged = merge_partials(parts, q.device).to(q.dtype)
    if decode:
        whole = pa.paged_decode_attention(q, k, v, tables, ctx, PS)
    else:
        whole = pa.paged_chunk_attention(q, k, v, tables, ctx, q_pos, PS)
    torch.cuda.synchronize()
    merge_err = compare(merged, whole, name, f"{what} {name}: merge vs the unsplit kernel")
    wrong = drop_last_page(pa, q4, k, v, tables, ctx, q_start,
                           merged[:, None] if decode else merged, name, gate=gate_drop)
    hd = q.shape[-1]
    shards = []
    for s in range(PG):
        keys, pairs, entries = owned_work(tables, ctx, q_start, q4.shape[1], s, pages_local)
        rows = q.numel() // hd
        n_bytes = (q.numel() * q.element_size() + keys * 2 * token_bytes(k)
                   + q.numel() * 4 + 2 * rows * 4 + entries * 4
                   + q.shape[0] * 4 * (1 if decode else 2))
        bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * q.shape[-2] * hd, name)
        lib_call, lib_check = library_partial(torch, q4, ks[s], vs[s], tables, ctx,
                                              q_start, s, pages_local)
        acc, m, l = parts[s]
        shards.append({"ms": time_ms(lambda: kernel(s)), "cold_ms": cold_ms(lambda: kernel(s)),
                       "device_ms": device_ms(lambda: kernel(s), iters=10),
                       "graph_ms": graph_ms(lambda: kernel(s)),
                       "host_ms": host_ms(lambda: kernel(s)),
                       "plain_ms": time_ms(lambda: plain(s), iters=3, warmup=1),
                       "library_ms": time_ms(lib_call, iters=5, warmup=1),
                       "library_max_abs_err": lib_check(
                           *((acc[:, None], m[:, None], l[:, None]) if decode
                             else (acc, m, l))),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "keys": keys, "max_abs_err": errs[s]})
        del lib_call, lib_check
    mean = {f: None if any(x[f] is None for x in shards) else sum(x[f] for x in shards) / PG
            for f in ("ms", "cold_ms", "device_ms", "graph_ms", "host_ms", "plain_ms",
                      "library_ms", "bound_ms")}
    b, n_q = q.shape[0], q.shape[-2]
    t, n_kv = q4.shape[1], ks[0].shape[1]
    route = pa.decode_route(q.dtype, hd, k.dtype, partial=True)
    if decode and route == "mma":
        not_slower(mean["ms"], mean["library_ms"], f"{what} {name} {list(q.shape)}")
    splits = (pa.decode_plan(b, n_q, n_kv, hd, tables.shape[1]) if decode
              else pa.chunk_plan(b, t, n_q, n_kv, hd, tables.shape[1])).splits
    return {"route": route, "splits": splits if route == "mma" else 1,
            "launches_per_call": per_call,
            "max_abs_err": max(errs), "merge_max_abs_err": merge_err, "tol": TOL[name],
            "q": list(q.shape), "kv_local": list(ks[0].shape),
            "foreign_pages_loaded": False,
            **mean, "bound_by": ("bytes" if all(x["bound_by"] == "bytes" for x in shards)
                                 else "operations"),
            "shards": shards, "drop_last_page": wrong}


def plan_heads(torch) -> tuple[int, int]:
    """(query heads, kv heads) of one page-shard call on the tp=16 mesh that
    ``plan_kv_split`` plans for ENGINE_MODEL: each model group's query heads
    (gathered over its page shards) over its kv heads."""
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.parallel.kv_split import plan_kv_split

    cfg = get_config(ENGINE_MODEL)
    plan = plan_kv_split(cfg, 16)
    if plan.pg_shards != PG or (cfg.n_heads, cfg.n_kv_heads) != (N_Q, N_KV):
        raise AssertionError(f"plan {plan} does not cut the {N_Q}/{N_KV}-head pools "
                             f"into PG={PG} page shards")
    return N_Q // plan.kv_shards, N_KV // plan.kv_shards


def partial_cases(pa, torch, q, k, v, tables, ctx, q_pos, name: str) -> dict:
    """``shard_case`` at the shape one call of the served tp=16 path has
    (``served``: one model group's query and kv heads) and over every head
    (``all_heads``). The dropped-last-page check is gated over every head,
    and at the served shape in f32 only: in bf16 a one-token last page of
    a 4097-token row moves 4 heads by less than the tolerance (it is
    recorded)."""
    nq, nkv = plan_heads(torch)
    served = shard_case(pa, torch, q[..., :nq, :].contiguous(), k[:, :nkv].contiguous(),
                        v[:, :nkv].contiguous(), tables, ctx, q_pos, name,
                        gate_drop=name == "float32")
    every = shard_case(pa, torch, q, k, v, tables, ctx, q_pos, name)
    return {"served": served, "all_heads": every,
            "max_abs_err": max(served["max_abs_err"], every["max_abs_err"])}


def phase_decode_partial(pa, torch) -> dict:
    """K4 on phase 2's decode inputs, whose live pages are drawn over the
    whole pool, cut into PG page shards of NUM_PAGES / PG pages: at the
    served shape (B=8, 4 query heads over 1 kv head) and over all heads;
    bf16 queries (the tensor-core kernel) also at head_dim 64 (``hd64``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    result: dict = {"phase": "decode_partial_kernel", "page_shards": PG,
                    "ctx_lens": DECODE_CTX}
    for dtype, geo in ((torch.float32, None), (torch.bfloat16, None),
                       (torch.bfloat16, "hd64")):
        name = str(dtype).split(".")[1]
        n_q, n_kv, hd = HD64 if geo else (N_Q, N_KV, HD)
        k, v, tables = make_pool(gen, dtype, DECODE_CTX, dev, n_kv, hd)
        q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(dtype)
        case = partial_cases(pa, torch, q, k, v, tables, ctx, None, name)
        if geo:
            result[name][geo] = {"heads": [n_q, n_kv], "head_dim": hd, **case}
            result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                              case["max_abs_err"])
        else:
            result[name] = case
        del k, v
    return result


def one_shard_tables(tables, ctx):
    """The tables with sequence i's live pages drawn in ascending order from
    page shard i % PG alone, as the engine's allocator hands out long runs
    (entries past ctx unchanged)."""
    import torch

    tables = tables.clone()
    local = NUM_PAGES // PG
    nxt = [max(1, s * local) for s in range(PG)]  # page 0 is the null page
    for i, c in enumerate(ctx.tolist()):
        need, s = -(-c // PS), i % PG
        if nxt[s] + need > (s + 1) * local:
            raise AssertionError(f"page shard {s} cannot hold sequence {i}")
        tables[i, :need] = torch.arange(nxt[s], nxt[s] + need, dtype=torch.int32)
        nxt[s] += need
    return tables


def phase_chunk_partial(pa, torch) -> dict:
    """The chunk partial on phase 3's 4 x 512 prefill and T=8 verify inputs,
    cut into PG page shards (their pages drawn over the whole pool, so
    ownership interleaves page by page), and on the verify input with each
    sequence's pages on one shard; at the served shape and over all heads.
    bf16 queries take the tensor-core kernel, f32 queries the CUDA-core
    kernel; bf16 also on the verify input at head_dim 64 (``verify_hd64``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    result: dict = {"phase": "chunk_partial_kernel", "page_shards": PG}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        cases = {}
        kinds = ("prefill", "verify", "verify_one_shard")
        for kind in kinds + (("verify_hd64",) if dtype == torch.bfloat16 else ()):
            geo = HD64 if kind.endswith("_hd64") else (N_Q, N_KV, HD)
            q, k, v, tables, ctx, pos, _ = chunk_inputs(
                torch, dev, gen, dtype, kind.split("_")[0], geo)
            if kind.endswith("_one_shard"):
                tables = one_shard_tables(tables, ctx)
            cases[kind] = partial_cases(pa, torch, q, k, v, tables, ctx, pos, name)
            del q, k, v
        worst = max(c["max_abs_err"] for c in cases.values())
        result[name] = {**cases.pop("prefill"), **cases, "max_abs_err": worst}
    return result


# ---- fp8 (e4m3) pools: K1, K2, W1, K4 and the chunk partial over fp8 pages.


def same_as_bf16(pa, torch, call, k, v, what: str) -> dict:
    """The fp8 instantiation against the bf16 one over the widened pool:
    ``call(k, v)`` once over the fp8 pool (only ``_fp8`` counters may rise)
    and once over ``pool.to(bfloat16)`` (only bf16 ones); the results must
    be equal bit for bit (every e4m3 value is a bf16 value, and both
    instantiations split the call alike)."""
    reset_counts()
    got = call(k, v)
    fp8_launched = {n: c for n, c in counts().items() if c}
    reset_counts()
    want = call(k.to(torch.bfloat16), v.to(torch.bfloat16))
    bf16_launched = {n: c for n, c in counts().items() if c}
    torch.cuda.synchronize()
    if (not fp8_launched or not bf16_launched
            or any(not n.endswith("_fp8") for n in fp8_launched if n in pa.launches)
            or any(n.endswith("_fp8") for n in bf16_launched)):
        raise AssertionError(f"{what}: fp8 call launched {fp8_launched}, the bf16 call "
                             f"{bf16_launched}")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{what}: the fp8 kernel differs from the bf16 kernel over "
                             f"the widened pool (max |diff| {diff:.3e})")
    return {"equal_to_bf16_over_widened_pool": True, "fp8_launches": fp8_launched}


def phase_decode_fp8(pa, torch) -> dict:
    """K1 over fp8 pools (written from random bf16 or f32 pools): bf16
    queries on the tensor-core kernel on phase 2's decode input, at the
    served contexts and at head_dim 64; f32 queries on the CUDA-core kernel
    on the decode input. Each as ``decode_case`` (within TOL of the plain
    version, its times, its bound from the fp8 bytes, SDPA over the widened
    gather), and equal to the bf16 instantiation over the widened pool."""
    from runbookai_tpu_torch.ops.attention import to_fp8

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(21)
    result: dict = {"phase": "decode_fp8_kernel", "ctx_lens": DECODE_CTX}
    for dtype, kind, ctx_l, (n_q, n_kv, hd) in (
            (torch.bfloat16, "decode", DECODE_CTX, (N_Q, N_KV, HD)),
            (torch.bfloat16, "served", SERVED_CTX, (N_Q, N_KV, HD)),
            (torch.bfloat16, "hd64", DECODE_CTX, HD64),
            (torch.float32, "decode", DECODE_CTX, (N_Q, N_KV, HD))):
        name = str(dtype).split(".")[1]
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
        k, v, tables = make_pool(gen, dtype, ctx_l, dev, n_kv, hd)
        k, v = to_fp8(k), to_fp8(v)
        q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(dtype)
        case = decode_case(pa, torch, q, k, v, tables, ctx, name)
        case.update(same_as_bf16(pa, torch, lambda kk, vv: pa.paged_decode_attention(
            q, kk, vv, tables, ctx, PS), k, v, f"decode fp8 {kind} {name}"))
        if kind == "decode":
            result[name] = case
        else:
            result[name][kind] = case
        del k, v
    return result


def phase_chunk_fp8(pa, torch) -> dict:
    """K2 over fp8 pools: bf16 queries (the tensor-core kernel) on phase 3's
    4 x 512 prefill, T=8 verify and one-row prefill at offset 4096; f32
    queries (the CUDA-core kernel) on the verify. Each within TOL of the
    plain version, one K2 launch a call, equal to the bf16 instantiation
    over the widened pool, and timed as phase 3 times them (bound from the
    fp8 bytes)."""
    from runbookai_tpu_torch.ops.attention import to_fp8

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(22)
    result: dict = {"phase": "chunk_fp8_kernel"}
    for dtype, kinds in ((torch.bfloat16, ("prefill", "verify", "prefill_one_row")),
                         (torch.float32, ("verify",))):
        name = str(dtype).split(".")[1]
        cases = {}
        for kind in kinds:
            q, k, v, tables, ctx, pos, _ = chunk_inputs(torch, dev, gen, dtype, kind)
            k, v = to_fp8(k), to_fp8(v)
            q_start = pos[:, 0].contiguous()
            reset_counts()
            out = pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)
            launched = counts()["paged_chunk_attention_fp8"]
            if launched != 1:
                raise AssertionError(f"chunk fp8 {kind} {name}: {counts()} for one call")
            ref = pa.plain_paged_attention(q, k, v, tables, ctx, q_start, PS)
            torch.cuda.synchronize()
            cases[kind] = {"max_abs_err": compare(out, ref, name, f"chunk fp8 {kind} {name}"),
                           "splits": (chunk_plan_of(pa, q, k, tables).splits
                                      if dtype == torch.bfloat16 else 1),
                           **same_as_bf16(pa, torch, lambda kk, vv: pa.paged_chunk_attention(
                               q, kk, vv, tables, ctx, pos, PS), k, v,
                               f"chunk fp8 {kind} {name}"),
                           **time_chunk(pa, torch, q, k, v, tables, ctx, pos, name)}
            del q, k, v, out, ref
        result[name] = {"route": "mma" if dtype == torch.bfloat16 else "cuda_core",
                        "tol": TOL[name], "max_abs_err": max(c["max_abs_err"]
                                                             for c in cases.values()),
                        **cases.pop(kinds[0]), **cases}
    return result


def phase_ragged_fp8(pa, torch) -> dict:
    """W1 over an fp8 pool on the served mixed batch (phase 13's "served"
    input): ``ragged_case`` (within TOL, pad blocks zero, one ragged kernel
    a call, times, bound from the fp8 bytes, SDPA over each block's widened
    gather) and equal to the bf16 instantiation over the widened pool."""
    from runbookai_tpu_torch.ops.attention import to_fp8

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(torch, dev, gen, torch.bfloat16,
                                                          "served")
    k, v = to_fp8(k), to_fp8(v)
    case = ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, "served fp8")
    case.update(same_as_bf16(pa, torch, lambda kk, vv: pa.paged_ragged_attention(
        q, kk, vv, tables, ctx, pos, rows, PS, ragged_block=RQ), k, v, "ragged fp8 served"))
    return {"phase": "ragged_fp8_kernel", "rows": MIX_ROWS, "tokens": B * RQ + MIX_PF_TOKENS,
            "served": case}


def phase_partial_fp8(pa, torch) -> dict:
    """K4 and the chunk partial over fp8 page shards, at the shape one call
    of the tp=16 path has (one model group's 4 query heads over its kv
    head): K4 on phase 2's decode input, the chunk partial on phase 3's
    prefill and verify inputs, cut into PG page shards. Each as
    ``shard_case`` (every shard's (acc, m, l) within TOL of the plain
    version, unchanged with the other shard's pages set to NaN, the merge
    against K1 or K2 over the whole fp8 pool, times and bounds from the
    owned fp8 bytes), and each shard's call equal to the bf16
    instantiation's over the widened slice."""
    from runbookai_tpu_torch.ops.attention import to_fp8

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(24)
    nq, nkv = plan_heads(torch)
    result: dict = {"phase": "partial_fp8_kernel", "page_shards": PG, "heads": [nq, nkv]}
    for kind in ("decode", "prefill", "verify"):
        if kind == "decode":
            ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
            k, v, tables = make_pool(gen, torch.bfloat16, DECODE_CTX, dev, N_KV, HD)
            q = torch.randn((B, N_Q, HD), generator=gen, device=dev).to(torch.bfloat16)
            pos = None
        else:
            q, k, v, tables, ctx, pos, _ = chunk_inputs(torch, dev, gen, torch.bfloat16, kind,
                                                        (N_Q, N_KV, HD))
        q = q[..., :nq, :].contiguous()
        k, v = to_fp8(k[:, :nkv].contiguous()), to_fp8(v[:, :nkv].contiguous())
        case = shard_case(pa, torch, q, k, v, tables, ctx, pos, "bfloat16", gate_drop=False)
        pages_local = k.shape[0] // PS // PG
        for s, (ks, vs) in enumerate(zip(k.chunk(PG), v.chunk(PG))):
            if pos is None:
                def call(kk, vv, s=s):
                    return pa.paged_decode_attention_partial(q, kk, vv, tables, ctx, s, PS,
                                                             pages_local)
            else:
                def call(kk, vv, s=s):
                    return pa.paged_chunk_attention_partial(q, kk, vv, tables, ctx, pos, s,
                                                            PS, pages_local)
            case["shards"][s].update(same_as_bf16(pa, torch, call, ks, vs,
                                                  f"partial fp8 {kind} shard {s}"))
        result["decode" if kind == "decode" else f"chunk_{kind}"] = case
        del q, k, v
    return result


def phase_fp8_cast(torch) -> dict:
    """The fp8 pool write on the card against the same write on the CPU,
    byte for byte: every bf16 bit pattern (65,536 values), then every
    4,099th f32 bit pattern, written through ``write_kv_pages_batch`` into
    an fp8 pool on each. The CPU write is held against
    ``jnp.astype(jnp.float8_e4m3fn)`` by tests/test_torch_fp8_kv.py, NaN
    past 464 included; equal bytes carry that to the card."""
    import numpy as np

    from runbookai_tpu_torch.ops.attention import write_kv_pages_batch

    res: dict = {"phase": "fp8_cast"}
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.int16)
    f32 = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32).view(np.float32)
    for name, x in (("bfloat16", torch.from_numpy(bits).view(torch.bfloat16)),
                    ("float32", torch.from_numpy(f32[:len(f32) // 128 * 128]))):
        tokens = x.numel() // 128
        new_kv = x.reshape(1, tokens, 1, 128)
        n_pages = -(-tokens // PS)
        tables = torch.arange(1, n_pages + 2, dtype=torch.int32)[None]
        positions = torch.arange(tokens, dtype=torch.int32)[None]
        got = {}
        for dev in ("cpu", DEVICE):
            pool = torch.zeros(((n_pages + 2) * PS, 1, 128), dtype=torch.float8_e4m3fn,
                               device=dev)
            write_kv_pages_batch(pool, new_kv.to(dev), positions.to(dev), tables.to(dev), PS)
            got[dev] = pool.view(torch.uint8).cpu()
        differ = int((got["cpu"] != got[DEVICE]).sum())
        if differ:
            raise AssertionError(f"fp8 cast ({name}): {differ} bytes of the card's write "
                                 f"differ from the CPU's")
        byte = got["cpu"][PS:PS + tokens].reshape(-1)
        res[name] = {"values": x.numel(), "bytes_differing": differ,
                     "nan_bytes": int(((byte & 0x7F) == 0x7F).sum())}
    return res


def phase_forward_tp(torch) -> dict:
    """The 8B at full width, depth cut to FORWARD_TP_LAYERS layers, f32
    weights and pool: the forward on the model=8 x seq=2 (tp=16) and
    model=8 x seq=1 (tp=8) meshes, every shard on the one card, against the
    unsharded forward, over a prefill chunk, a decode step and a T=8 verify
    whose pages lie on both page shards."""
    import dataclasses

    from runbookai_tpu_torch.engine.kv_cache import PagePool
    from runbookai_tpu_torch.models.llama import forward_impl, get_config, init_params
    from runbookai_tpu_torch.parallel.kv_split import plan_kv_split
    from runbookai_tpu_torch.parallel.mesh import build_mesh
    from runbookai_tpu_torch.parallel.sharding import shard_params

    free_device(torch)
    cfg = dataclasses.replace(get_config(ENGINE_MODEL), n_layers=FORWARD_TP_LAYERS)
    dev = torch.device(f"{DEVICE}:0")
    gen = torch.Generator(device=dev).manual_seed(6)
    params = init_params(cfg, dtype=torch.float32, device=dev, generator=gen)
    num_pages, max_pages, prompt = 64, 16, 100
    tables = torch.zeros((2, max_pages + 1), dtype=torch.int32, device=dev)
    tables[0, :7] = torch.tensor([33, 2, 40, 5, 60, 7, 50])  # pages on both shards
    tables[1, :7] = torch.tensor([3, 34, 12, 45, 14, 63, 16])

    def step(start, t):
        tok = torch.randint(0, cfg.vocab_size, (2, t), generator=gen, device=dev)
        pos = (start + torch.arange(t, device=dev, dtype=torch.int32)).expand(2, t)
        ctx = torch.full((2,), start + t, dtype=torch.int32, device=dev)
        return tok, pos.contiguous(), ctx

    steps = [step(0, prompt), step(prompt, 1), step(prompt + 1, 8)]
    pool_args = (cfg.n_layers, num_pages, PS, cfg.n_kv_heads, cfg.head_dim, torch.float32)
    ref_pool = PagePool.create(*pool_args, device=dev)
    want = [forward_impl(params, cfg, tok, pos, ref_pool.kv_k, ref_pool.kv_v, tables, ctx,
                         PS) for tok, pos, ctx in steps]
    out: dict = {"phase": "forward_tp", "model": ENGINE_MODEL,
                 "reduced": {"n_layers": [get_config(ENGINE_MODEL).n_layers,
                                          FORWARD_TP_LAYERS]},
                 "dtype": "float32", "tol": [FORWARD_TP_TOL, FORWARD_TP_TOL],
                 "steps": ["prefill T=100", "decode", "verify T=8"]}
    for tp, must, never in ((16, PARTIALS, ("paged_decode_attention",
                                            "paged_chunk_attention")),
                            (8, ("paged_decode_attention", "paged_chunk_attention"),
                             PARTIALS)):
        plan = plan_kv_split(cfg, tp)
        mesh = build_mesh(plan.kv_shards, plan.pg_shards, [dev] * tp)
        shards = shard_params({**params, "layers": dict(params["layers"])}, cfg, mesh)
        pool = PagePool.create(*pool_args, device=dev, mesh=mesh)
        reset_counts()
        t0 = time.perf_counter()
        got = [forward_impl(shards, cfg, tok, pos, pool.kv_k, pool.kv_v, tables, ctx, PS,
                            mesh=mesh) for tok, pos, ctx in steps]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        if any(launched[k] == 0 for k in must) or any(launched[k] for k in never):
            raise AssertionError(f"forward_tp tp={tp}: kernel routing {launched}")
        errs = []
        for g, w, what in zip(got, want, out["steps"]):
            diff = (g - w).abs()
            if not bool(g.isfinite().all()):
                raise AssertionError(f"forward_tp tp={tp} {what}: non-finite logits")
            if bool((diff > FORWARD_TP_TOL + FORWARD_TP_TOL * w.abs()).any()):
                raise AssertionError(f"forward_tp tp={tp} {what}: max |err| "
                                     f"{float(diff.max()):.3e} beyond atol/rtol "
                                     f"{FORWARD_TP_TOL}")
            errs.append(float(diff.max()))
        out[f"model{plan.kv_shards}_seq{plan.pg_shards}"] = {
            "max_abs_err": errs, "wall_s": wall,
            "launches": {k: v for k, v in launched.items() if v}}
        del shards, pool, got
    return out


def kernel_names(torch, fn, calls: int) -> list[str]:
    """The device kernels (and copies) that ``calls`` calls of ``fn`` run,
    by torch.profiler, after one call outside it. Every caller's ``fn``
    launches at least one kernel a call, so a profile that kept fewer
    device events than ``calls`` is taken again, up to five times; the
    callers then check the names and their count."""

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profiled() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names


QMM_KERNELS = {"mma": "qmm_mma_kernel(", "wgmma": "qmm_wgmma_kernel<", "f32": "qmm_f32_kernel("}


def qmm_one_launch(qm, torch, x, q, s, what: str) -> dict:
    """One device kernel per call, the route's (``qmm_route``: mma.sync or
    wgmma for bf16 x, the CUDA-core kernel for f32), never a second-launch
    merge; and after the first call no allocation but the output's (the
    split workspace is cached per stream)."""
    want = QMM_KERNELS[qm.qmm_route(x.shape[0], x.dtype == torch.float32)]
    names = kernel_names(torch, lambda: qm.qmm_int8(x, q, s), 4)
    if len(names) != 4 or not all(want in nm for nm in names):
        raise AssertionError(f"{what}: 4 calls ran {names}, not 4 x {want}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = qm.qmm_int8(x, q, s)
    grew = torch.cuda.memory_allocated() - before
    del out
    probe = torch.empty((x.shape[0], q.shape[1]), dtype=x.dtype, device=x.device)
    out_bytes = torch.cuda.memory_allocated() - before
    del probe
    if grew != out_bytes:
        raise AssertionError(f"{what}: a call allocated {grew} bytes, its output "
                             f"{out_bytes}")
    return {"kernels_per_call": len(names) // 4, "kernel": names[0][:80],
            "allocated_per_call": grew}


def qmm_case(qm, torch, x, q, s, deq, name: str) -> dict:
    """K5 against its plain version on layer 0 of a stacked weight, the
    dropped-K-slice check, one launch and no allocation but the output per
    call, and kernel, plain and library (``torch.matmul`` by ``deq``, the
    weights dequantized to bf16) device times, each call on the next of the
    layer slices of ``q`` and ``s`` (32 in phase 5), so that every timed
    call reads its weights from outside the 50 MB L2 (its cold time);
    ``events_ms`` is the kernel's CUDA-event time over back-to-back calls,
    which the host's launch rate can set, and ``graph_ms`` the same rotating
    calls captured in one CUDA graph."""
    m, k = x.shape
    n = q.shape[2]
    out = qm.qmm_int8(x, q[0], s[0])
    ref = qm.plain_qmm_int8(x, q[0], s[0])
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"qmm [{m}, {k}] @ [{k}, {n}]")
    launch = qmm_one_launch(qm, torch, x, q[0], s[0], f"qmm [{m}, {k}] @ [{k}, {n}]")
    # A wrong kernel: the plain version with the last bk slice of K dropped.
    bk = qm._pick(qm._BK_CANDIDATES, k)
    wrong = qm.plain_qmm_int8(x[:, :k - bk].contiguous(), q[0, :k - bk], s[0])
    over, diff = excess(wrong, ref, name)
    if not all(bool(over[i].max() > 0) for i in range(m)):
        raise AssertionError(f"qmm [{m}, {k}] @ [{k}, {n}]: the tolerance accepts a "
                             f"result with the last {bk} rows of K dropped")

    layers = q.shape[0]

    def rotating(fn, *stacked):
        layer = [0]

        def call():
            i = layer[0] = (layer[0] + 1) % layers
            return fn(x, *(w[i] for w in stacked))
        return call

    bound_ms, bound_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                               2.0 * m * k * n, name)
    plan = qm.qmm_plan(m, k, n)
    return {"max_abs_err": err,
            "ms": device_ms(rotating(qm.qmm_int8, q, s), iters=2 * layers),
            "events_ms": time_ms(rotating(qm.qmm_int8, q, s), iters=4 * layers,
                                 warmup=layers),
            "graph_ms": graph_ms(rotating(qm.qmm_int8, q, s), iters=layers),
            "plain_ms": device_ms(rotating(qm.plain_qmm_int8, q, s), iters=8),
            "library_ms": device_ms(rotating(torch.matmul, deq), iters=2 * layers),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "wrong_min_abs_err": min(float(diff[i].max()) for i in range(m)),
            "splits": plan.splits, "k_slice": plan.k_slice, "tile_n": plan.tile_n, **launch}


def gpu_clocks() -> str:
    """SM clock, power draw and temperature, read beside a timed phase."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_qmm(torch) -> dict:
    """K5 at the 8B's four (K, N) shapes and QMM_ROWS rows, bf16 x, each
    weight stacked over 32 layers (int8 with f32 scales) so that timed calls
    rotate through 32 distinct matrices, as the decode forward does; the
    library yardstick moves twice the weight bytes. The bf16 tolerance
    holds because both versions sum in f32 and round once to bf16. Every
    case also checks one launch and no allocation but the output per call,
    and, once per (K, N), f32 x on the CUDA-core kernel."""
    from runbookai_tpu_torch.ops import qmm as qm

    clocks_before = gpu_clocks()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    name = "bfloat16"
    cases: dict = {}
    f32_err = 0.0
    for k, n in sorted(set(QMM_SHAPES.values())):
        q = torch.empty((QMM_LAYERS, k, n), dtype=torch.int8, device=dev)
        for part in q:
            part.random_(-127, 128, generator=gen)
        s = (torch.rand((QMM_LAYERS, 1, n), generator=gen, device=dev) + 0.5) \
            * (3 ** 0.5 / (127 * k ** 0.5))
        deq = q.to(torch.bfloat16) * s.to(torch.bfloat16)
        for m in QMM_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases[f"{m}x{k}x{n}"] = qmm_case(qm, torch, x, q, s, deq, name)
        # f32 x: the CUDA-core kernel, on the same workspace and merge.
        x = torch.randn((QMM_ROWS[0], k), generator=gen, device=dev)
        f32_err = max(f32_err, compare(qm.qmm_int8(x, q[0], s[0]),
                                       qm.plain_qmm_int8(x, q[0], s[0]), "float32",
                                       f"qmm f32 [{x.shape[0]}, {k}] @ [{k}, {n}]"))
        qmm_one_launch(qm, torch, x, q[0], s[0], f"qmm f32 [{x.shape[0]}, {k}] @ [{k}, {n}]")
        del q, s, deq
    per_layer = {}
    for m, key in ((8, "decode"), (64, "verify")):  # one layer's seven products
        rows = [cases[f"{m}x{k}x{n}"] for k, n in QMM_SHAPES.values()]
        per_layer[key] = {f: sum(r[f] for r in rows)
                          for f in ("ms", "events_ms", "graph_ms", "plain_ms", "library_ms",
                                    "bound_ms")}
        per_layer[key]["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                                      else "operations")
    return {"phase": "qmm_kernel", "tol": TOL[name], "layers_rotated": QMM_LAYERS,
            "clocks_before_after": [clocks_before, gpu_clocks()],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "f32_cuda_core_max_abs_err": f32_err,
            "per_layer": per_layer, "cases": cases}


def phase_forward(torch) -> dict:
    """The forward on the card (kernels) against the HF golden logits, and a
    decode step against the same forward on the CPU (plain versions)."""
    import numpy as np

    from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
    from runbookai_tpu_torch.models.llama import forward_impl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"phase": "forward_vs_golden"}
    for name in ("hf-tiny-untied", "hf-tiny-qwen2", "hf-tiny-rope31"):
        d = ROOT / "tests" / "fixtures" / name
        blob = np.load(d / "expected_logits.npz")
        ids = torch.from_numpy(blob["input_ids"]).long()
        b, t = ids.shape
        ps, max_pages = 4, 16
        tables = torch.zeros((b, max_pages + 1), dtype=torch.int32)
        for i in range(b):
            tables[i, : max_pages] = torch.arange(1 + i * max_pages, 1 + (i + 1) * max_pages)
        logits = {}
        for dev in (DEVICE, "cpu"):
            cfg, params = load_params(d, config_from_hf(d, name=name),
                                      dtype=torch.float32, device=dev)
            shape = (cfg.n_layers, (1 + b * max_pages) * ps, cfg.n_kv_heads, cfg.head_dim)
            kv_k = torch.zeros(shape, device=dev)
            kv_v = torch.zeros(shape, device=dev)
            tab = tables.to(dev)
            pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t).contiguous()
            pre = forward_impl(params, cfg, ids.to(dev), pos, kv_k, kv_v, tab,
                               torch.full((b,), t, dtype=torch.int32, device=dev), ps)
            nxt = pre[:, -1].argmax(-1)[:, None]
            dec = forward_impl(params, cfg, nxt, torch.full((b, 1), t, dtype=torch.int32,
                                                          device=dev),
                               kv_k, kv_v, tab,
                               torch.full((b,), t + 1, dtype=torch.int32, device=dev), ps)
            logits[dev] = (pre.cpu(), dec.cpu())
        golden = float((logits[DEVICE][0] - torch.from_numpy(blob["logits"])).abs().max())
        np.testing.assert_allclose(logits[DEVICE][0].numpy(), blob["logits"],
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(logits[DEVICE][1].numpy(), logits["cpu"][1].numpy(),
                                   atol=1e-4, rtol=1e-4)
        out[name] = {"golden_max_abs_err": golden,
                     "decode_vs_cpu_max_abs_err":
                         float((logits[DEVICE][1] - logits["cpu"][1]).abs().max())}
    return out


def prompts() -> list[str]:
    """User turns for 64..1024-token prompts (byte tokenizer, chat template
    included); the fourth repeats itself so prompt-lookup can draft."""
    words = ("checkout latency alarm fired at 09:14 for the payments api; "
             "p99 rose from 180ms to 2.4s after deploy 4411. ")
    return ["why is checkout slow?",
            words * 3,
            words * 6,
            "restart the checkout service. " * 24,
            words * 8]


def phase_forward_int8(torch) -> dict:
    """hf-tiny fixtures loaded with int8 weights, prefill then decode over an
    int8 pool in f32: the card (qmm, int8 chunk and decode kernels) against
    the same forward on the CPU (plain versions)."""
    import numpy as np

    from runbookai_tpu_torch.engine.kv_cache import PagePool
    from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
    from runbookai_tpu_torch.models.llama import forward_impl

    out: dict = {"phase": "forward_int8"}
    for name in ("hf-tiny-untied", "hf-tiny-qwen2"):
        d = ROOT / "tests" / "fixtures" / name
        ids = torch.from_numpy(np.load(d / "expected_logits.npz")["input_ids"]).long()
        b, t = ids.shape
        ps, max_pages = 4, 16
        tables = torch.zeros((b, max_pages + 1), dtype=torch.int32)
        for i in range(b):
            tables[i, : max_pages] = torch.arange(1 + i * max_pages, 1 + (i + 1) * max_pages)
        logits, pools = {}, {}
        reset_counts()
        for dev in (DEVICE, "cpu"):
            cfg, params = load_params(d, config_from_hf(d, name=name), dtype=torch.float32,
                                      device=dev, quantize_int8=True)
            pool = PagePool.create(cfg.n_layers, 1 + b * max_pages, ps, cfg.n_kv_heads,
                                   cfg.head_dim, dtype=torch.int8, device=dev)
            tab = tables.to(dev)
            pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t).contiguous()
            pre = forward_impl(params, cfg, ids.to(dev), pos, pool.kv_k, pool.kv_v, tab,
                               torch.full((b,), t, dtype=torch.int32, device=dev), ps)
            nxt = pre[:, -1].argmax(-1)[:, None]
            dec = forward_impl(params, cfg, nxt, torch.full((b, 1), t, dtype=torch.int32,
                                                          device=dev),
                               pool.kv_k, pool.kv_v, tab,
                               torch.full((b,), t + 1, dtype=torch.int32, device=dev), ps)
            logits[dev] = (pre.cpu(), dec.cpu())
            pools[dev] = pool.kv_k[0].cpu()
        launched = counts()
        for kernel in ("paged_chunk_attention_int8", "paged_decode_attention_int8",
                       "qmm_int8"):
            if not launched[kernel]:
                raise AssertionError(f"{name}: the int8 forward skipped {kernel}")
        flips = int((pools[DEVICE] != pools["cpu"]).sum())
        err = float((logits[DEVICE][1] - logits["cpu"][1]).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{name}: int8 decode logits card vs cpu {err:.3e} > "
                                 f"1e-4 ({flips} int8 K values rounded apart)")
        out[name] = {"decode_vs_cpu_max_abs_err": err,
                     "prefill_vs_cpu_max_abs_err":
                         float((logits[DEVICE][0] - logits["cpu"][0]).abs().max()),
                     "k_values_rounded_apart": flips, "launches": launched}
    return out


async def serve(client, texts):
    t0 = time.perf_counter()
    resps = await asyncio.gather(*(client.chat("", u) for u in texts))
    return resps, time.perf_counter() - t0


# The kernels each serving configuration (weights; KV pool of the same
# type) must launch, and those it must not.
PARTIALS = ("paged_decode_attention_partial", "paged_chunk_attention_partial")
FP8_PARTIALS = tuple(x + "_fp8" for x in PARTIALS)
BF16_POOL = ("paged_decode_attention", "paged_chunk_attention", "paged_ragged_attention",
             *PARTIALS)
FP8_ONE_SHARD = ("paged_decode_attention_fp8", "paged_chunk_attention_fp8",
                 "paged_ragged_attention_fp8")
SERVING = {
    "bfloat16": dict(must=("paged_decode_attention", "paged_chunk_attention"),
                     never=PARTIALS),
    "int8": dict(must=("paged_decode_attention_int8", "paged_chunk_attention_int8",
                       "qmm_int8"),
                 never=("paged_decode_attention", "paged_chunk_attention", *PARTIALS)),
    "kv_split": dict(must=PARTIALS,
                     never=("paged_decode_attention", "paged_chunk_attention")),
    # bf16 with mixed dispatch: the first prefill (nothing decodes yet) and
    # the verifies stay on K2, the mixed steps run W1's ragged kernel.
    "mixed": dict(must=("ragged_plan", "paged_ragged_attention", "paged_decode_attention",
                        "paged_chunk_attention"), never=PARTIALS),
    # bf16 weights over an fp8 pool: the fp8 instantiations, no bf16-pool one.
    "fp8": dict(must=("paged_decode_attention_fp8", "paged_chunk_attention_fp8"),
                never=(*BF16_POOL, *FP8_PARTIALS)),
    "mixed_fp8": dict(must=("ragged_plan", "paged_ragged_attention_fp8",
                            "paged_decode_attention_fp8", "paged_chunk_attention_fp8"),
                      never=(*BF16_POOL, *FP8_PARTIALS)),
    "kv_split_fp8": dict(must=FP8_PARTIALS, never=(*BF16_POOL, *FP8_ONE_SHARD)),
    # tp=8 (model=8 x seq=1) over fp8 pool shards: K1 and K2 per head shard.
    "tp8_fp8": dict(must=("paged_decode_attention_fp8", "paged_chunk_attention_fp8"),
                    never=(*BF16_POOL, *FP8_PARTIALS)),
}


def build_client(torch, weights: str, overlap: bool = True, graphs: bool = True,
                 layers: Optional[int] = None):
    """bf16 weights and pool, int8 weights (bf16 activations) and pool, bf16
    on the tp=16 page-split mesh (model=8 x seq=2, every shard on the one
    card, a TP_PAGES-page pool), or bf16 with mixed dispatch on; with
    ``_fp8`` appended (``fp8`` alone: bf16 serving), bf16 weights over an
    fp8 pool (``kv_cache_dtype="fp8"``); through the entry point a user
    calls. ``overlap`` False turns the overlapped decode pipeline off and
    ``graphs`` False the step graphs (the engine block of a serving plan);
    the client captures its step graphs while it is built. ``layers`` cuts
    the model's depth to that many layers (the widths stay)."""
    import dataclasses
    from unittest import mock

    from runbookai_tpu_torch.models import llama

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient, serving_engine_config
    from runbookai_tpu_torch.models.llama import get_config

    pool = "fp8" if weights.endswith("fp8") else "auto"
    if weights == "int8":
        kw = dict(dtype="int8", kv_cache_dtype="int8")
    elif weights.startswith("kv_split"):
        ecfg = serving_engine_config(get_config(ENGINE_MODEL), torch.bfloat16)
        kw = dict(dtype=torch.bfloat16, tp=16, devices=[f"{DEVICE}:0"] * 16,
                  engine_cfg=dataclasses.replace(ecfg, num_pages=TP_PAGES),
                  engine={"kv_dtype": pool})
    elif weights.startswith("tp8"):
        kw = dict(dtype=torch.bfloat16, tp=8, devices=[f"{DEVICE}:0"] * 8,
                  kv_cache_dtype=pool)
    else:
        kw = dict(dtype=torch.bfloat16, kv_cache_dtype=pool)
    engine = kw.pop("engine", {})
    if weights.startswith("mixed"):
        engine["mixed_dispatch"] = True
    if not overlap:
        engine["overlap_decode"] = False
    if not graphs:
        engine["step_graphs"] = False
    cfg = get_config(ENGINE_MODEL)
    depth = {ENGINE_MODEL: dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)}
    with mock.patch.dict(llama.CONFIGS, depth):
        return TorchCudaClient.build(ENGINE_MODEL, device=DEVICE, seed=0, max_new_tokens=32,
                                     engine=engine, **kw)


def reset_counts() -> None:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    pa.reset_launches()
    qm.launches["qmm_int8"] = 0


def counts() -> dict:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    return {**pa.launches, **pa.merge_launches, **pa.plan_launches, **qm.launches}


def free_device(torch) -> None:
    """Release the previous phase's client before the next one builds."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


ENGINE_PHASES = {"bfloat16": "engine", "int8": "engine_int8", "kv_split": "engine_kv_split",
                 "mixed": "engine_mixed", "fp8": "engine_fp8", "mixed_fp8": "engine_mixed_fp8",
                 "kv_split_fp8": "engine_kv_split_fp8", "tp8_fp8": "engine_tp8_fp8"}


def phase_name(weights: str, overlap: bool, graphs: bool = True) -> str:
    return (ENGINE_PHASES[weights] + ("" if overlap else "_overlap_off")
            + ("" if graphs else "_graphs_off"))


# The eager entry point that each kind of step graph replaces (one call a
# replay; a greedy loop of k replaces k calls).
GRAPH_ENTRIES = {"forward": "forward_impl", "loop": "forward_impl",
                 "prefill": "forward_hidden", "mixed": "forward_ragged_impl"}


def recording_forwards(log: list):
    """Wrap the engine's forward entry points, and the step graphs' replay,
    so that each dispatch appends (entry, token shape) to ``log`` (a replay
    as ``step_graph:<entry>`` with its bucket's token shape, a greedy loop of
    k once for each of its k forwards); returns the restore function."""
    from runbookai_tpu_torch.engine import engine as eng
    from runbookai_tpu_torch.engine.step_graphs import StepGraph

    names = ("forward_impl", "forward_hidden", "forward_ragged_impl")
    originals = {n: getattr(eng, n) for n in names}
    replay = StepGraph.replay

    def wrap(name, fn):
        def call(params, cfg, tokens, *args, **kwargs):
            log.append([name, list(tokens.shape)])
            return fn(params, cfg, tokens, *args, **kwargs)
        return call

    def recorded_replay(graph):
        kind, n = graph.key
        entry = ["step_graph:" + GRAPH_ENTRIES[kind], list(graph.inputs["tokens"].shape)]
        log.extend([entry] * (n if kind == "loop" else 1))
        return replay(graph)

    for n in names:
        setattr(eng, n, wrap(n, originals[n]))
    StepGraph.replay = recorded_replay

    def restore():
        for n, fn in originals.items():
            setattr(eng, n, fn)
        StepGraph.replay = replay
    return restore


def timing_dispatches(core) -> dict:
    """Time each prefill and mixed dispatch of ``core`` on the host clock
    (each ends in its first-token fetch, or, for a prefill that completes
    no prompt, in nothing): {method: [ms, ...]}, filled while it serves."""
    walls = {"_run_prefill": [], "_run_mixed": []}
    for name, log in walls.items():
        method = getattr(core, name)

        def timed(*args, _method=method, _log=log):
            t0 = time.perf_counter()
            out = _method(*args)
            if out is not False:  # a mixed step that ran
                _log.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(core, name, timed)
    return walls


def same_workspace(core, before: tuple) -> bool:
    """The split workspace that the step graphs took at capture (``before``:
    the tensors themselves) is still theirs after serving, and no stream's
    entry in ``_split_workspaces`` shares its memory, so no eager call
    merged in it or freed it."""
    from runbookai_tpu_torch.ops.build import _split_workspaces

    after = core._graphs.workspace
    ptrs = {t.data_ptr() for t in before if t is not None and t.numel()}
    return (all(a is b for a, b in zip(after, before))
            and not any(t.data_ptr() in ptrs for pair in _split_workspaces.values()
                        for t in pair))


def phase_engine(torch, weights: str = "bfloat16", overlap: bool = True,
                 graphs: bool = True, layers: Optional[int] = None) -> dict:
    """Serve the five requests on a fresh client of ``weights`` (``layers``:
    at that depth): the kernels of the configuration must launch
    (``SERVING``), with step graphs (the default) at least one replay and
    the split workspace they took at capture still theirs alone after
    serving."""
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = build_client(torch, weights, overlap, graphs, layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    core = client.core
    held = core._graphs.workspace if core._graphs is not None else (None, None)
    texts = prompts()
    prompt_ids = [client._prompt_ids("", u, None) for u in texts]
    prompt_tokens = [len(p) for p in prompt_ids]
    if min(prompt_tokens) < 64 or max(prompt_tokens) > 1024:
        raise AssertionError(f"prompt lengths {prompt_tokens} outside 64..1024")
    pages: set[int] = set()
    alloc = core.kv.allocator.alloc

    def recording_alloc(n):
        got = alloc(n)
        pages.update(got)
        return got

    core.kv.allocator.alloc = recording_alloc

    dispatches: list = []
    walls = timing_dispatches(core)
    restore = recording_forwards(dispatches)
    reset_counts()
    try:
        resps, wall = asyncio.run(_serve_and_stop(client, texts))
    finally:
        restore()
    launched = counts()

    done, finished = check_served(client, resps, len(texts))
    if (core.metrics["graph_replays"] > 0) != graphs:
        raise AssertionError(f"{weights}: step graphs {graphs}, but "
                             f"{core.metrics['graph_replays']} replays")
    if core._tok_counts is not None or core._mask_host is not None:
        raise AssertionError("unguided serving made a penalty-count or a guided-mask tensor")
    if graphs and not same_workspace(core, held):
        raise AssertionError(f"{weights}: the split workspace of the step graphs was "
                             f"replaced or shared while serving")
    spec = SERVING[weights]
    if (any(launched[k] == 0 for k in spec["must"])
            or any(launched[k] for k in spec["never"])):
        raise AssertionError(f"main path ({weights}) skipped a kernel or ran one of "
                             f"the other configuration: {launched}")
    # Every T=8 verify call of 8 slots has fewer blocks than two per SM, so
    # chunk_plan splits it and the merge kernel runs.
    if not weights.startswith("kv_split") and not launched["paged_chunk_merge"]:
        raise AssertionError(f"main path ({weights}) merged no split chunk call")
    if weights.startswith("mixed") and not core.metrics["mixed_steps"]:
        raise AssertionError("mixed dispatch on, but no mixed step ran")
    ttft = [r.usage["ttft_ms"] for r in resps]
    result = {"phase": phase_name(weights, overlap, graphs),
              "overlap_decode": core.ecfg.overlap_decode,
              "mixed_dispatch": core.ecfg.mixed_dispatch, "step_graphs": graphs,
              "graph_capture_s": core.metrics["graph_capture_s"],
              "graph_buckets": 0 if core._graphs is None else len(core._graphs.buckets),
              "graph_warmup_s": 0.0 if core._graphs is None else core._graphs.warmup_s,
              "graph_replays": core.metrics["graph_replays"],
              "prefill_dispatch_ms": walls["_run_prefill"],
              "mixed_dispatch_ms": walls["_run_mixed"],
              "graph_workspace_floats": 0 if held[1] is None else held[1].numel(),
              "graph_workspace_same_after_serving": True if graphs else None,
              "model": ENGINE_MODEL, "dtype": "int8" if weights == "int8" else "bfloat16",
              "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
              "requests": len(texts), "prompt_tokens": prompt_tokens,
              "completion_tokens": done,
              "finish_reasons": [r.finish_reason.value for r in finished],
              "wall_s": wall, "tokens_per_s": sum(done) / wall,
              "decode_s_per_step": core.metrics["decode_time_s"] / max(
                  1, core.metrics["decode_steps"]),
              "ttft_ms": ttft, "build_s": build_s, "launches": launched,
              "pool_bytes": core.kv.pool.nbytes(),
              "engine_metrics": core.metrics,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              # the graphs' private pool is reserved, not allocated, between replays
              "max_memory_reserved": torch.cuda.max_memory_reserved(),
              "layers": core.cfg.n_layers,
              "greedy_tokens": [streams_by_prompt(finished, p) for p in prompt_ids],
              "dispatches": dispatches}
    if core.mesh is not None:
        local = core.ecfg.num_pages // core.mesh.seq
        by_shard = [sum(1 for p in pages if p // local == s) for s in range(core.mesh.seq)]
        if not all(by_shard):
            raise AssertionError(f"pages allocated per page shard {by_shard}: the run "
                                 f"left a page shard unused")
        result.update(mesh=core.mesh.shape, num_pages=core.ecfg.num_pages,
                      pages_allocated_by_shard=by_shard,
                      # one attention call per shard and layer
                      calls_per_forward=core.cfg.n_layers * core.mesh.tp)
    return result


def eager_forwards(dispatches: list) -> list:
    """A dispatch log with each step graph's replay written as the eager
    forwards it replaces."""
    return [[name.split(":")[-1], shape] for name, shape in dispatches]


def phase_graphs_off(torch, weights: str, served: dict, overlap: bool = True) -> dict:
    """``weights``'s serving phase again with the step graphs off (the eager
    forward): its greedy streams must equal ``served``'s (graphs on) token
    for token, and it reports whether both issued the same forwards."""
    off = phase_engine(torch, weights, overlap, graphs=False, layers=served["layers"])
    off["same_forwards_as_graphs"] = (eager_forwards(off["dispatches"])
                                      == eager_forwards(served["dispatches"]))
    off["first_divergence_from_graphs"] = first_divergence(off["greedy_tokens"],
                                                           served["greedy_tokens"])
    if off["greedy_tokens"] != served["greedy_tokens"]:
        raise AssertionError(f"{weights}: graphs off gave other greedy tokens than graphs "
                             f"on, first at {off['first_divergence_from_graphs']}")
    return off


def streams_by_prompt(finished, prompt: list[int]) -> list[int]:
    """The tokens generated for the request whose prompt starts with
    ``prompt`` (preemption folds output into the prompt)."""
    for req in finished:
        if req.prompt_ids[:len(prompt)] == prompt:
            return list(req.all_out_ids)
    raise AssertionError("no finished request for a prompt")


def same_token_share(a: list[list[int]], b: list[list[int]]) -> float:
    """Share of greedy positions where two runs emitted the same token."""
    pairs = [(x, y) for s, t in zip(a, b) for x, y in zip(s, t)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def check_served(client, resps, n_requests: int):
    """Every request of a serving run finished without a crash or an abort,
    with 1..32 completion tokens inside the vocabulary. Returns (completion
    token counts, finished requests)."""
    core = client.core
    if client.engine.crash_count:
        raise AssertionError(f"the engine loop crashed {client.engine.crash_count} "
                             f"time(s); its requests were aborted")
    done = [r.usage["completion_tokens"] for r in resps]
    finished = list(core.finished)
    if len(finished) != n_requests or any(r.finish_reason is None for r in finished):
        raise AssertionError("not every request finished")
    if any(r.finish_reason.value == "aborted" for r in finished):
        raise AssertionError("a request was aborted")
    if any(not 1 <= n <= 32 for n in done):
        raise AssertionError(f"completion token counts {done}")
    vocab = core.cfg.vocab_size
    if any(not 0 <= t < vocab for r in finished for t in r.all_out_ids):
        raise AssertionError("a sampled id lies outside the vocabulary")
    return done, finished


INT8_ARGS = ("signed char", "int8_t")
FP8_ARGS = ("__nv_fp8_e4m3",)


def pool_class(arg: str) -> str:
    """The class suffix of a kernel's pool type template argument."""
    return "_int8" if arg in INT8_ARGS else "_fp8" if arg in FP8_ARGS else ""


def template_args(name: str, kernel: str):
    """The template arguments of a profiled ``kernel<...>``, or None."""
    if kernel + "<" not in name:
        return None
    return name.split(kernel + "<", 1)[1].split(">", 1)[0].split(", ")


# The CUDA-core kernel's instantiations for bf16 queries that the
# tensor-core kernels replaced, by (kCausal, kPartial): chunk calls over
# every pool type; decode calls (K1, and K3 over int8 pools), decode
# partials (K4) and chunk partials over bf16 and int8 pools. Only bf16
# queries over an f32 pool stay on the CUDA cores, outside chunk calls.
REMOVED_BF16 = {("true", "false"): "chunk", ("false", "false"): "decode",
                ("true", "true"): "chunk_partial", ("false", "true"): "decode_partial"}


def removed_bf16(name: str):
    """Which removed instantiation a profiled kernel is ("chunk", "decode",
    "decode_int8", "decode_partial", "chunk_partial", or "qmm": K5's
    CUDA-core bf16 kernel or its second-launch merge), or None."""
    if "qmm_kernel<__nv_bfloat16>" in name or "qmm_finish_kernel<" in name:
        return "qmm"
    args = template_args(name, "paged_attention_kernel")  # <TQ, TKV, kCausal, kPartial>
    if not args or args[0] != "__nv_bfloat16":
        return None
    kind = REMOVED_BF16.get(tuple(args[2:4]))
    if kind == "chunk":
        return kind
    if args[1] == "float":
        return None
    return kind + ("_int8" if args[1] in INT8_ARGS else "")


def kernel_class(name: str, int8_pools: bool = False, fp8_pools: bool = False) -> str:
    """A profiled kernel's class, ``_int8`` or ``_fp8`` appended for those
    pools; the merge of a split chunk call counts with the chunk class of
    the run's pool type (``int8_pools``, ``fp8_pools``)."""
    args = template_args(name, "paged_attention_kernel")  # <TQ, TKV, kCausal, kPartial>
    if args:
        cls = "chunk_attention" if args[2] == "true" else "decode_attention"
        cls += "_partial" if args[3] == "true" else ""
        return cls + pool_class(args[1])
    args = template_args(name, "chunk_attention_mma_kernel")  # <TKV, HD, WARPS>
    if args:
        return "chunk_attention" + pool_class(args[0])
    args = template_args(name, "chunk_partial_mma_kernel")  # <TKV, HD, WARPS>
    if args:
        return "chunk_attention_partial" + pool_class(args[0])
    args = template_args(name, "ragged_attention_kernel")  # <TKV, HD>
    if args:
        return "ragged_attention" + pool_class(args[0])
    if PLAN_KERNEL in name:
        return "ragged_plan"
    args = template_args(name, "decode_attention_mma_kernel")  # <TKV, HD, kPartial, Args>
    if args:
        return "decode_attention" + ("_partial" if args[2:3] == ["true"] else "") + (
            pool_class(args[0]))
    if "chunk_merge_kernel<" in name:
        return "chunk_attention" + ("_int8" if int8_pools else "_fp8" if fp8_pools else "")
    if "qmm" in name:  # before the matmul test: the int8 weight kernel
        return "qmm"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


OTHER_CLASSES = ("matmul", "other")  # kernel classes that are not the port's


def device_time_by_class(torch, prof, launched: dict, what: str, int8_pools: bool = False,
                         fp8_pools: bool = False):
    """A profile's device time: {class: [ms, kernels]} and {kernel name: ms}.
    ``launched`` holds the wrappers' launch counts over the window
    (``counts()``); a window that kept no device kernel, or fewer of the
    port's kernels than the wrappers launched in it, lost events, and
    fails. (Replays of step graphs launch kernels no wrapper counts, so
    there the check is a floor.)"""
    classes: dict[str, list] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        # GPU-side user annotations (the engine's ``annotate`` ranges) span
        # kernels; they are not kernels themselves.
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        name, ms = e.name, e.time_range.elapsed_us() / 1e3
        acc = classes.setdefault(kernel_class(name, int8_pools, fp8_pools), [0.0, 0])
        acc[0] += ms
        acc[1] += 1
        by_name[name] = by_name.get(name, 0.0) + ms
    kept = sum(n for cls, (_, n) in classes.items() if cls not in OTHER_CLASSES)
    if not classes or kept < sum(launched.values()):
        raise AssertionError(f"{what}: the profiler kept {kept} of the port's kernels "
                             f"({sum(n for _, n in classes.values())} in all), the "
                             f"wrappers launched {sum(launched.values())}: events lost")
    return classes, by_name


# The CUDA calls that put work on the device, as the profiler names them
# (the CPU-side events of the runtime and driver APIs).
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync")


def decode_ranges():
    """Wrap the T = 1 decode forward (the eager ``forward_impl`` and the
    replay of its step graph, as ``rb_forward_T<T>``), each step program
    with its input copies (``EngineCore._dispatch``: the prefill, the
    greedy loop, the verify and the mixed step, as ``rb_<kind>_<n>``) and
    the decode dispatch (``EngineCore._decode_multi``, as ``rb_decode_k<k>``:
    its loads, forwards and sampling) in profiler ranges; returns the
    restore function."""
    from torch.profiler import record_function

    from runbookai_tpu_torch.engine import engine as eng
    from runbookai_tpu_torch.engine.step_graphs import StepGraph

    forward, replay = eng.forward_impl, StepGraph.replay
    multi, dispatch = eng.EngineCore._decode_multi, eng.EngineCore._dispatch

    def ranged_forward(params, cfg, tokens, *args, **kwargs):
        with record_function(f"rb_forward_T{tokens.shape[1]}"):
            return forward(params, cfg, tokens, *args, **kwargs)

    def ranged_replay(graph):
        if graph.key[0] != "forward":
            return replay(graph)
        with record_function(f"rb_forward_T{graph.key[1]}"):
            return replay(graph)

    def ranged_multi(core, positions, ctx_lens, si, k, *args, **kwargs):
        with record_function(f"rb_decode_k{k}"):
            return multi(core, positions, ctx_lens, si, k, *args, **kwargs)

    def ranged_dispatch(core, key, *args, **kwargs):
        with record_function(f"rb_{key[0]}_{key[1]}"):
            return dispatch(core, key, *args, **kwargs)

    eng.forward_impl, StepGraph.replay = ranged_forward, ranged_replay
    eng.EngineCore._decode_multi, eng.EngineCore._dispatch = ranged_multi, ranged_dispatch

    def restore():
        eng.forward_impl, StepGraph.replay = forward, replay
        eng.EngineCore._decode_multi, eng.EngineCore._dispatch = multi, dispatch
    return restore


def calls_in_ranges(torch, prof, prefix: str) -> dict:
    """The runtime calls (``RUNTIME_CALLS``) inside the profiler ranges whose
    name starts with ``prefix``, from the CPU events: the ranges, the calls a
    range and by name a range (None without a range)."""
    import bisect

    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    calls = sorted((e.time_range.start, e.name) for e in cpu
                   if e.name.startswith(RUNTIME_CALLS))
    starts = [t for t, _ in calls]
    ranges = [e for e in cpu if e.name.startswith(prefix)]
    by_name: dict[str, int] = {}
    for e in ranges:
        lo = bisect.bisect_left(starts, e.time_range.start)
        hi = bisect.bisect_right(starts, e.time_range.end)
        for _, name in calls[lo:hi]:
            by_name[name] = by_name.get(name, 0) + 1
    n = len(ranges)
    return {"ranges": n, "calls": sum(by_name.values()) / n if n else None,
            "by_name": {k: v / n for k, v in sorted(by_name.items())} if n else None,
            "names": sorted({e.name for e in ranges})}


def launch_calls(torch, prof) -> dict:
    """Runtime calls a decode forward and a decode step, from the profiler's
    CPU events inside the ``decode_ranges``: per T = 1 forward (the forward
    alone; none where the greedy loop's graph ran the decode), per greedy
    loop dispatch (its input copies and replay) and per decode step (the
    whole dispatch over its k steps: input copies, forwards, sampling)."""
    fwd = calls_in_ranges(torch, prof, "rb_forward_T1")
    loop = calls_in_ranges(torch, prof, "rb_loop_")
    steps_in = calls_in_ranges(torch, prof, "rb_decode_k")
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    dispatches = [e for e in cpu if e.name.startswith("rb_decode_k")]
    steps = sum(int(e.name[len("rb_decode_k"):]) for e in dispatches)
    per_step = (steps_in["calls"] * steps_in["ranges"] / steps) if steps else None
    return {"decode_forwards": fwd["ranges"], "decode_steps": steps,
            "launch_calls_per_decode_forward": fwd["calls"],
            "launch_calls_per_decode_forward_by_name": fwd["by_name"],
            "loop_dispatches": loop["ranges"], "loop_buckets": loop["names"],
            "launch_calls_per_loop_dispatch": loop["calls"],
            "launch_calls_per_loop_dispatch_by_name": loop["by_name"],
            "launch_calls_per_decode_step": per_step}


# Engine steps of the in-thread decode window in which phase_profile counts
# the runtime calls a decode forward.
DECODE_WINDOW_STEPS = 4


def decode_window(torch, client) -> dict:
    """The serving requests once more on ``client``'s engine, stepped in
    this thread (the profiler records the CPU events of its own thread
    only, and the async engine steps in a worker thread): once every
    request decodes, ``DECODE_WINDOW_STEPS`` steps with speculation off
    under the profiler with :func:`decode_ranges`, then the rest
    unprofiled; the runtime calls of :func:`launch_calls`."""

    from runbookai_tpu_torch.engine.request import EngineRequest

    core = client.core
    reqs = [EngineRequest(prompt_ids=client._prompt_ids("", u, None),
                          sampling=client._sampling()) for u in prompts()]
    for r in reqs:
        core.submit(r)
    while core.waiting or core.prefilling:
        core.step()
    # The window counts k-step decode dispatches: a second serving of the
    # same prompts drafts, and a verify would take their place.
    speculative, core.ecfg.speculative = core.ecfg.speculative, False
    torch.cuda.synchronize()
    restore = decode_ranges()
    try:
        with profiled() as prof:
            for _ in range(DECODE_WINDOW_STEPS):
                core.step()
            torch.cuda.synchronize()
    finally:
        restore()
    core.run_until_idle()
    core.ecfg.speculative = speculative
    return launch_calls(torch, prof)


# At most this many engine steps in the in-thread prefill and mixed windows.
PREFILL_WINDOW_STEPS = 8


def prefill_window(torch, client, mixed: bool = False) -> dict:
    """The serving requests once more on ``client``'s engine, stepped in
    this thread under the profiler with :func:`decode_ranges` while prompts
    prefill (at most ``PREFILL_WINDOW_STEPS`` steps): the runtime calls a
    prefill dispatch (``rb_prefill_*``: its input copies and its forward)
    or, with ``mixed``, a mixed one (the first request decodes before the
    rest arrive, so that prompts and decodes share steps); then the rest
    unprofiled."""

    from runbookai_tpu_torch.engine.request import EngineRequest

    core = client.core
    reqs = [EngineRequest(prompt_ids=client._prompt_ids("", u, None),
                          sampling=client._sampling()) for u in prompts()]
    if mixed:
        core.submit(reqs.pop(0))
        while not core.decoding:
            core.step()
    for r in reqs:
        core.submit(r)
    torch.cuda.synchronize()
    restore = decode_ranges()
    try:
        with profiled() as prof:
            for _ in range(PREFILL_WINDOW_STEPS):
                if not (core.waiting or core.prefilling):
                    break
                core.step()
            torch.cuda.synchronize()
    finally:
        restore()
    core.run_until_idle()
    kind = "mixed" if mixed else "prefill"
    got = calls_in_ranges(torch, prof, f"rb_{kind}_")
    return {f"{kind}_dispatches": got["ranges"], f"{kind}_buckets": got["names"],
            f"launch_calls_per_{kind}_forward": got["calls"],
            f"launch_calls_per_{kind}_forward_by_name": got["by_name"]}


def check_graph_calls(res: dict, weights: str) -> None:
    """With step graphs on: a prefill or mixed dispatch is one graph launch
    and its input copies, no kernel launched apart, and a greedy decode step
    makes at most 2 runtime calls."""
    for kind in ("prefill", "mixed"):
        by_name = res.get(f"launch_calls_per_{kind}_forward_by_name")
        if f"{kind}_dispatches" in res and not res[f"{kind}_dispatches"]:
            raise AssertionError(f"{weights}: the {kind} window ran no {kind} dispatch")
        if by_name is not None and (by_name.get("cudaGraphLaunch") != 1 or any(
                name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for name in by_name)):
            raise AssertionError(f"{weights}: a {kind} dispatch with graphs on made {by_name}")
    if not res["launch_calls_per_decode_step"] or res["launch_calls_per_decode_step"] > 2:
        raise AssertionError(f"{weights}: {res['launch_calls_per_decode_step']} runtime calls "
                             f"a greedy decode step with graphs on")


def phase_profile(torch, weights: str = "bfloat16", overlap: bool = True,
                  graphs: bool = True, layers: Optional[int] = None) -> dict:
    """The engine phase's workload again, on a fresh client with the same
    seed, under torch.profiler: device time by kernel class, and the
    device's idle share of the serving wall time (profiler on); then the
    runtime calls a decode forward and a decode step, in a window of the
    same client (:func:`decode_window`). ``layers`` cuts the depth."""

    free_device(torch)
    client = build_client(torch, weights, overlap, graphs, layers)
    torch.cuda.synchronize()
    texts = prompts()
    reset_counts()
    with profiled() as prof:
        resps, wall = asyncio.run(_serve_and_stop(client, texts))
        torch.cuda.synchronize()
    launched = counts()
    check_served(client, resps, len(texts))
    fp8 = weights.endswith("fp8")
    classes, by_name = device_time_by_class(torch, prof, launched, f"{weights} profile",
                                            weights == "int8", fp8)
    # The routes: bf16 chunk and decode calls on the tensor-core kernels,
    # over bf16, int8 and fp8 pools, and K5 on its tensor-core kernels;
    # page-split chunk and decode partials too; no call on a removed
    # CUDA-core instantiation, and over an fp8 pool no bf16-pool kernel.
    old = [n for n in by_name if removed_bf16(n)]
    if fp8:
        old += [n for n in by_name if kernel_class(n, fp8_pools=True) in (
            "chunk_attention", "decode_attention", "ragged_attention",
            "chunk_attention_partial", "decode_attention_partial")]
    pool = "_int8" if weights == "int8" else "_fp8" if fp8 else ""
    if weights.startswith("kv_split"):
        want = [("chunk_partial_mma_kernel<", "chunk_attention_partial" + pool),
                ("decode_attention_mma_kernel<", "decode_attention_partial" + pool)]
    else:
        want = [("chunk_attention_mma_kernel<", "chunk_attention" + pool),
                ("decode_attention_mma_kernel<", "decode_attention" + pool)]
        if weights == "int8":  # K5: decode rows on mma.sync, verify and prefill rows on wgmma
            want += [("qmm_mma_kernel(", "qmm"), ("qmm_wgmma_kernel<", "qmm")]
        if weights == "mixed":  # W1 and its tile list on the mixed steps
            want += [(RAGGED_KERNEL, "ragged_attention"), (PLAN_KERNEL, "ragged_plan")]
    missed = [cls for pat, cls in want
              if not any(pat in n and kernel_class(n, weights == "int8", fp8) == cls
                         for n in by_name)]
    if old or missed:
        raise AssertionError(f"{weights} profile: no tensor-core kernel for {missed}, "
                             f"or a removed or other-pool instantiation ran: {old[:1]}")
    launches_by_kernel = {}
    if weights == "mixed":
        # Each W1 call is one ragged kernel, each mixed forward one tile list
        # kernel, and K2's tensor-core kernel runs once per K2 call: only the
        # split path's chunk calls (prefill before any decode, verify), none
        # for the mixed steps.
        launches_by_kernel = {
            pat: sum(1 for e in prof.events() if e.device_type ==
                     torch.autograd.DeviceType.CUDA and pat in e.name)
            for pat in (RAGGED_KERNEL, PLAN_KERNEL, "chunk_attention_mma_kernel<")}
        if (launches_by_kernel[RAGGED_KERNEL] != launched["paged_ragged_attention"]
                or launches_by_kernel[PLAN_KERNEL] != launched["ragged_plan"]
                or launches_by_kernel["chunk_attention_mma_kernel<"]
                != launched["paged_chunk_attention"]):
            raise AssertionError(f"mixed profile: kernels {launches_by_kernel} against the "
                                 f"wrappers' counts {launched}")
    busy = sum(v[0] for v in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    windows = {**decode_window(torch, client), **prefill_window(torch, client)}
    if client.core._mixed:
        windows.update(prefill_window(torch, client, mixed=True))
    if graphs:
        check_graph_calls(windows, weights)
    return {"phase": phase_name(weights, overlap, graphs) + "_profile", "step_graphs": graphs,
            "layers": client.core.cfg.n_layers,
            "graph_replays": client.core.metrics["graph_replays"],
            **windows,
            **({"launches_by_kernel": launches_by_kernel,
                "wrapper_launches": {x: launched[x] for x in (
                    "ragged_plan", "paged_ragged_attention", "paged_chunk_attention")}}
               if launches_by_kernel else {}),
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
            "by_class_ms": {k: v[0] for k, v in sorted(classes.items())},
            "kernels_by_class": {k: v[1] for k, v in sorted(classes.items())},
            "top_kernels_ms": {n[:120]: ms for n, ms in top}}


def first_divergence(a: list[list[int]], b: list[list[int]]):
    """(request, position) of the first greedy token where two runs differ,
    or None."""
    for i, (s, t) in enumerate(zip(a, b)):
        for j, (x, y) in enumerate(zip(s, t)):
            if x != y:
                return [i, j]
        if len(s) != len(t):
            return [i, min(len(s), len(t))]
    return None


def phase_witness(torch, pa, weights: str, served: dict, run=None, name: str = "",
                  modes=("kernel", "plain"), layers: Optional[int] = None) -> dict:
    """The serving phase's requests twice more, with every call of the
    forward to the kernels under test made twice: the kernel, and its plain
    version on the same inputs (f32 throughout, rounded once), each call's
    result held against the other at TOL (fails beyond it). The calls: chunk
    and decode attention (``models.llama``), with int8 weights also K5
    (``qmm_int8``), with mixed dispatch also W1's launch and its tile list
    (the list exactly, record for record); on the page-split mesh the
    chunk and decode partials (``parallel.kv_split``), their (acc, m, l)
    each. The first run serves the kernel's result, as the serving phase
    did; the second serves the plain version's, which shows how far the
    greedy streams of random weights move under the kernel's rounding
    alone. Each run records where its streams first differ from the
    serving phase's or, where it ran at another depth than the serving
    phase, the plain run where its streams first differ from the kernel
    run's. ``run`` (default: the serving phase of ``weights`` with
    the step graphs off, since a replay calls no module function) serves
    the requests; ``modes`` picks the runs. ``layers`` cuts the default
    run's depth."""
    from runbookai_tpu_torch.models import llama
    from runbookai_tpu_torch.ops import qmm
    from runbookai_tpu_torch.parallel import kv_split

    def plain_chunk(q, k, v, tables, ctx, pos, ps):
        return pa.plain_paged_attention(q, k, v, tables, ctx, pos[:, 0].contiguous(), ps)

    def plain_ragged(q, k, v, tables, ctx, pos, rows, plan, ps, rq):
        return pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, ps, rq)

    def plain_decode(q, k, v, tables, ctx, ps):
        return pa.plain_paged_attention(q[:, None], k, v, tables, ctx, None, ps)[:, 0]

    def plain_partial(q, k, v, tables, ctx, pos, shard, ps, pages_local):
        return pa.plain_paged_attention_partial(q, k, v, tables, ctx, pos[:, 0].contiguous(),
                                                ps, shard, pages_local)

    def plain_decode_partial(q, k, v, tables, ctx, shard, ps, pages_local):
        acc, m, l = pa.plain_paged_attention_partial(q[:, None], k, v, tables, ctx, None, ps,
                                                     shard, pages_local)
        return acc[:, 0], m[:, 0], l[:, 0]

    if weights.startswith("kv_split"):
        targets = [(kv_split, "paged_chunk_attention_partial", plain_partial),
                   (kv_split, "paged_decode_attention_partial", plain_decode_partial)]
    else:
        targets = [(llama, "paged_chunk_attention", plain_chunk),
                   (llama, "paged_decode_attention", plain_decode)]
        if weights == "mixed":  # W1's tile list and its launch on the rows' tables
            targets += [(llama, "ragged_plan", pa.plain_ragged_plan),
                        (llama, "ragged_tile_attention", plain_ragged)]
        if weights == "int8":  # K5: every int8 weight product of M <= 256
            targets.append((llama, "qmm_int8", qmm.plain_qmm_int8))
    seen = {attr: {"calls": 0, "calls_beyond_tol": 0, "max_abs_err": 0.0, "finite": True}
            for _, attr, _ in targets}
    serve_plain = [False]

    def checked(attr, kernel, plain):
        def call(*args):
            out, ref = kernel(*args), plain(*args)
            exact = isinstance(out, pa.RaggedPlan)  # a tile list: record for record
            if exact:
                outs, refs = (out.tiles, out.live, out.weight), (ref.tiles, ref.live, ref.weight)
            else:
                outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            rec = seen[attr]
            rec["calls"] += 1
            beyond = False
            for o, r in zip(outs, refs):
                over, diff = excess(o, r, "bfloat16")
                beyond |= float((diff if exact else over).max()) > 0
                rec["max_abs_err"] = max(rec["max_abs_err"], float(diff.max()))
                rec["finite"] &= bool(o.isfinite().all())
            rec["calls_beyond_tol"] += int(beyond)
            return ref if serve_plain[0] else out
        return call

    runs, streams = {}, {}
    kernels = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for (mod, attr, kernel), (_, _, plain) in zip(kernels, targets):
        setattr(mod, attr, checked(attr, kernel, plain))
    try:
        for mode in modes:
            serve_plain[0] = mode == "plain"
            res = run() if run is not None else phase_engine(torch, weights, graphs=False,
                                                             layers=layers)
            metrics = res["engine_metrics"]
            runs[mode] = {"spec_drafted": metrics.get("spec_drafted"),
                          "spec_accepted": metrics.get("spec_accepted"),
                          "completion_tokens": res["completion_tokens"],
                          "layers": res["layers"]}
            streams[mode] = res["greedy_tokens"]
            if res["layers"] == served["layers"]:
                base, against = served["greedy_tokens"], "serving"
            else:  # another model: the plain run against the kernel run
                base, against = streams.get("kernel") if mode != "kernel" else None, "kernel_run"
            if base is not None:
                runs[mode].update({f"same_greedy_tokens_as_{against}": same_token_share(
                    res["greedy_tokens"], base), "first_divergence": first_divergence(
                    res["greedy_tokens"], base)})
    finally:
        for mod, attr, kernel in kernels:
            setattr(mod, attr, kernel)
    for attr, rec in seen.items():
        if not rec["finite"] or rec["calls_beyond_tol"] or not rec["calls"]:
            raise AssertionError(f"{weights} serving: {rec['calls_beyond_tol']} of "
                                 f"{rec['calls']} {attr} calls beyond TOL of the plain "
                                 f"version (max |err| {rec['max_abs_err']:.3e}), or "
                                 f"non-finite")
    return {"phase": name or ENGINE_PHASES[weights] + "_witness", "tol": TOL["bfloat16"],
            "step_graphs": False, "layers": runs[modes[0]]["layers"],
            **seen, "served": {"spec_drafted": served["engine_metrics"].get("spec_drafted"),
                               "spec_accepted": served["engine_metrics"].get(
                                   "spec_accepted")},
            **runs}


# Phase 15: the orchestrator's guided completions at the JAX client's
# defaults (guided JSON on) on the 8B, beside chats and the sampling extras.
GUIDED_LIMITS = dict(max_str_len=16, max_array_items=2, max_any_bytes=64)
GUIDED_MAX_NEW = 512  # every guided completion's budget (the client's)
EXTRA_MAX_NEW = 32  # the chats' and the sampling extras' budget, as phase 7's
BIAS_BYTE = ord("a")
LOGPROB_TOL = 1e-3


def build_guided_client(torch, fast_forward: bool = False, graphs: bool = True,
                        layers: Optional[int] = None):
    """bf16 8B from seed 0, byte tokenizer, the serving engine (grammar
    fast-forward on request, step graphs unless ``graphs`` is False), the
    guided phase's schema limits; ``layers`` cuts the depth."""
    import dataclasses
    from unittest import mock

    from runbookai_tpu_torch.model.schema_guided import SchemaLimits
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama

    cfg = llama.get_config(ENGINE_MODEL)
    depth = {ENGINE_MODEL: dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)}
    with mock.patch.dict(llama.CONFIGS, depth):
        return TorchCudaClient.build(ENGINE_MODEL, device=DEVICE, dtype=torch.bfloat16, seed=0,
                                     max_new_tokens=GUIDED_MAX_NEW,
                                     schema_limits=SchemaLimits(**GUIDED_LIMITS),
                                     engine={"grammar_fast_forward": fast_forward,
                                             "step_graphs": graphs})


def guided_prompt() -> str:
    return "Investigate this incident and answer in JSON. " + prompts()[1]


def extra_requests(client) -> dict:
    """{name: (prompt ids, sampling)} of the chat turns of phase 7's first
    two prompts (each with an ``EXTRA_MAX_NEW`` budget) and of four requests
    through the engine: ``logit_bias`` +100 on one byte,
    ``frequency_penalty=2.0``, ``logprobs=5``, and a seeded row at
    temperature 0.8."""
    import dataclasses

    chat = [client._prompt_ids("", u, None) for u in prompts()[:2]]
    base = client._sampling(max_new=EXTRA_MAX_NEW)
    return {name: (ids, dataclasses.replace(base, **kw)) for name, ids, kw in (
        ("chat0", chat[0], {}), ("chat1", chat[1], {}),
        ("bias", chat[0], dict(logit_bias=((BIAS_BYTE, 100.0),))),
        ("penalty", chat[1], dict(frequency_penalty=2.0)),
        ("logprobs", chat[0], dict(logprobs=5)),
        ("seeded", chat[1], dict(temperature=0.8, seed=7)))}


async def serve_guided(client, extras: bool = True):
    """The guided phase's requests, concurrently: ``complete(prompt)`` (any
    JSON document) and ``complete(prompt, schema=name)`` for the six
    orchestrator schemas, and with ``extras`` :func:`extra_requests`.
    Returns ({name: text or EngineOutput}, wall seconds)."""
    from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS

    jobs = {"json": client.complete(guided_prompt())}
    jobs.update({n: client.complete(guided_prompt(), schema=n) for n in SCHEMA_MODELS})
    if extras:
        for name, (ids, sampling) in extra_requests(client).items():
            jobs[name] = client.engine.generate(ids, sampling)
    t0 = time.perf_counter()
    outs = await asyncio.gather(*jobs.values())
    return dict(zip(jobs, outs)), time.perf_counter() - t0


def check_logprobs(out) -> dict:
    """Each entry's top list sorted and <= 0, and (greedy) the chosen token
    the top-1 within ``LOGPROB_TOL`` (a bf16 tie may list its twin first)."""
    worst = 0.0
    for e in out.logprobs:
        top = [p for _, p in e["top"]]
        if len(top) != 5 or top != sorted(top, reverse=True) or max(top) > 0 or e["logprob"] > 0:
            raise AssertionError(f"logprob entry not sorted or positive: {e}")
        gap = abs(e["logprob"] - top[0])
        if gap > LOGPROB_TOL or e["token_id"] not in [
                t for t, p in e["top"] if abs(p - top[0]) <= LOGPROB_TOL]:
            raise AssertionError(f"greedy token is not the top-1 logprob: {e}")
        worst = max(worst, gap)
    if len(out.logprobs) != len(out.token_ids) - (out.finish_reason.value == "stop_token"):
        raise AssertionError("logprob entries do not align with the text's tokens")
    return {"entries": len(out.logprobs), "max_chosen_vs_top1": worst}


def phase_guided(torch, fast_forward: bool = False, extras: bool = True,
                 graphs: bool = True, layers: Optional[int] = None) -> dict:
    """Serve the guided phase's requests on a fresh client: fails unless
    every guided output parses, validates against its schema and finished
    on a stop token (or completed and then padded whitespace to its
    budget), K1 and K2 launched, no guided token lies past the
    tokenizer's vocab (the mask rows are the model's 128,256 wide), the
    biased stream is the forced byte, the logprobs hold
    (:func:`check_logprobs`), and the seeded row served again alone gives
    the same tokens; with ``fast_forward``, unless forced tokens were folded;
    with ``graphs``, unless the step graphs replayed. ``layers`` cuts the
    depth."""
    import json as _json

    from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS

    free_device(torch)
    client = build_guided_client(torch, fast_forward, graphs, layers)
    torch.cuda.synchronize()
    core = client.core
    picks: list[int] = []
    pick_k = core._pick_k

    def recording_pick_k():
        k = pick_k()
        picks.append(k)
        return k

    core._pick_k = recording_pick_k
    served: dict = {}  # the concurrent run's dispatch picks and metrics
    reset_counts()

    async def run():
        try:
            outs, wall = await serve_guided(client, extras)
            served.update(picks=list(picks), metrics=dict(core.metrics))
            # The seeded row once more, alone.
            again = (await client.engine.generate(*extra_requests(client)["seeded"])
                     if extras else None)
            return outs, wall, again
        finally:
            await client.shutdown()

    outs, wall, again = asyncio.run(run())
    launched = counts()
    if client.engine.crash_count:
        raise AssertionError("the engine loop crashed in the guided phase")
    vocab_tok = client.tokenizer.vocab_size
    guided = {r.sampling.guided: r for r in core.finished if r.sampling.guided}
    if sorted(guided) != sorted(["json", *SCHEMA_MODELS]):
        raise AssertionError(f"guided requests finished: {sorted(guided)}")
    docs = {}
    for name, req in guided.items():
        text = outs[name]
        doc = _json.loads(text)
        if name in SCHEMA_MODELS:
            SCHEMA_MODELS[name].model_validate(doc)
        # The grammar admits whitespace beside the stop tokens once the
        # document is complete (the JAX package's provider does the same), so
        # random weights may pad to the budget: then the document must have
        # completed before it, with only whitespace after.
        stopped = req.finish_reason.value == "stop_token"
        end = _json.JSONDecoder().raw_decode(text.lstrip())[1]
        if not stopped and (req.finish_reason.value != "max_tokens"
                            or text.lstrip()[end:].strip(" \t\n\r")):
            raise AssertionError(f"guided {name} finished by {req.finish_reason.value}: "
                                 f"{text[-80:]!r}")
        if max(req.all_out_ids) >= vocab_tok:
            raise AssertionError(f"guided {name} sampled id {max(req.all_out_ids)} past "
                                 f"the tokenizer's {vocab_tok}")
        docs[name] = {"bytes": len(text.encode()), "tokens": req.num_generated,
                      "finish_reason": req.finish_reason.value,
                      "trailing_whitespace": len(text.lstrip()) - end}
    if not (launched["paged_decode_attention"] and launched["paged_chunk_attention"]):
        raise AssertionError(f"guided phase: K1 or K2 not launched: {launched}")
    if (served["metrics"]["graph_replays"] > 0) != graphs:
        raise AssertionError(f"guided phase: step graphs {graphs}, but "
                             f"{served['metrics']['graph_replays']} replays")
    guided_tokens = sum(r.num_generated for r in guided.values())
    result = {"phase": ("engine_guided" + ("_fast_forward" if fast_forward else "")
                        + ("" if graphs else "_graphs_off")), "step_graphs": graphs,
              "graph_capture_s": core.metrics["graph_capture_s"],
              "model": ENGINE_MODEL, "layers": core.cfg.n_layers,
              "schema_limits": GUIDED_LIMITS,
              "max_new_tokens": GUIDED_MAX_NEW, "requests": len(outs),
              "guided": docs, "guided_tokens": guided_tokens,
              "wall_s": wall, "guided_tokens_per_s": guided_tokens / wall,
              "k1_dispatches": sum(k == 1 for k in served["picks"]),
              "decode_dispatches": len(served["picks"]),
              "grammar_forced_tokens": served["metrics"]["grammar_forced_tokens"],
              "tokenizer_vocab": vocab_tok, "model_vocab": core.cfg.vocab_size,
              "launches": launched, "engine_metrics": served["metrics"],
              "greedy_tokens": [guided[n].all_out_ids for n in sorted(guided)]}
    if fast_forward and not served["metrics"]["grammar_forced_tokens"]:
        raise AssertionError("grammar fast-forward on, but no forced token was folded")
    if extras:
        bias = outs["bias"].token_ids
        if bias != [BIAS_BYTE] * len(bias) or not bias:
            raise AssertionError(f"logit_bias +100 on {BIAS_BYTE}: stream {bias[:8]}")
        if again.token_ids != outs["seeded"].token_ids:
            raise AssertionError("the seeded row served alone gave other tokens")
        extra_names = list(extra_requests(client))
        result.update(
            logprobs=check_logprobs(outs["logprobs"]),
            extras={n: {"tokens": len(outs[n].token_ids),
                        "finish_reason": outs[n].finish_reason.value,
                        "distinct_tokens": len(set(outs[n].token_ids))} for n in extra_names},
            seeded_alone_same=True,
            completion_tokens=guided_tokens + sum(len(outs[n].token_ids) for n in extra_names))
        result["greedy_tokens"] += [outs[n].token_ids for n in extra_names]
    else:
        result["completion_tokens"] = guided_tokens
    return result


def guided_line(res: dict) -> dict:
    """A guided phase's line: its token streams counted, not listed."""
    return {**{k: v for k, v in res.items() if k != "greedy_tokens"},
            "streams": len(res["greedy_tokens"])}


# The guided profile's window: engine steps before it, steps in it.
GUIDED_PROFILE_STEPS = (16, 32)


def phase_guided_profile(torch, layers: Optional[int] = None) -> dict:
    """The guided phase's requests again on a fresh client, the engine
    stepped in this thread, with a window of ``GUIDED_PROFILE_STEPS[1]``
    steps (after the first ``GUIDED_PROFILE_STEPS[0]``, all requests
    admitted and every guided one decoding at k = 1) under torch.profiler:
    device time by kernel class and the device's idle share of the window's
    wall (profiler on). A whole run would trace over a million kernels. The
    requests are those ``complete()`` and ``engine.generate`` submit. Fails
    unless decode calls ran the tensor-core kernel, and if a removed
    instantiation ran. ``layers`` cuts the depth."""

    from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS
    from runbookai_tpu_torch.engine.request import EngineRequest

    free_device(torch)
    client = build_guided_client(torch, layers=layers)
    core = client.core
    jobs = [client._completion_request(guided_prompt(), None, schema)
            for schema in (None, *SCHEMA_MODELS)] + list(extra_requests(client).values())
    reqs = [EngineRequest(prompt_ids=ids, sampling=sampling) for ids, sampling in jobs]
    for r in reqs:
        core.submit(r)
    first, n = GUIDED_PROFILE_STEPS
    for _ in range(first):
        core.step()
    torch.cuda.synchronize()
    before = dict(core.metrics)
    reset_counts()
    with profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            core.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    window = {k: core.metrics[k] - before[k] for k in (
        "decode_dispatches", "decode_tokens", "prefill_steps", "prefill_tokens")}
    core.run_until_idle()
    asyncio.run(client.shutdown())
    if any(r.finish_reason is None or r.finish_reason.value == "aborted" for r in reqs):
        raise AssertionError("guided profile: a request did not finish")
    classes, by_name = device_time_by_class(torch, prof, launched, "guided profile")
    old = [name for name in by_name if removed_bf16(name)]
    if old or not any("decode_attention_mma_kernel<" in name
                      and kernel_class(name) == "decode_attention" for name in by_name):
        raise AssertionError(f"guided profile: no tensor-core decode kernel, or a removed "
                             f"instantiation ran: {old[:1]}")
    busy = sum(v[0] for v in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "engine_guided_profile", "window_steps": GUIDED_PROFILE_STEPS,
            "layers": core.cfg.n_layers,
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
            "window": window,
            "by_class_ms": {k: v[0] for k, v in sorted(classes.items())},
            "kernels_by_class": {k: v[1] for k, v in sorted(classes.items())},
            "top_kernels_ms": {name[:120]: ms for name, ms in top}}


async def _serve_and_stop(client, texts):
    try:
        return await serve(client, texts)
    finally:
        await client.shutdown()


# The serving phases of the configurations in argv (phase_engine's
# weights) of the tree in the working directory, by its own chip_smoke.py,
# one JSON line each (--serve-ab); a first serving run of each
# configuration, not recorded, builds the kernels and warms the process.
_SERVE_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
for w in sys.argv[1:]:
    cs.phase_engine(torch, weights=w)
    e = cs.phase_engine(torch, weights=w)
    e.pop("greedy_tokens")
    e.pop("dispatches")
    print(json.dumps(e), flush=True)
    print(json.dumps(cs.phase_profile(torch, weights=w)), flush=True)
"""


def serve_ab(other: Path, weights: list[str]) -> int:
    """The serving phases of ``weights`` (``phase_engine``'s configurations)
    of ``other`` and of this tree, in the order other, this, this, other,
    each round in a fresh process; a summary line per phase on stdout, every
    line in ``OUT_DIR/serve_ab.jsonl``."""
    log = OUT_DIR / "serve_ab.jsonl"
    log.write_text("")
    for rnd, (tag, tree) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                       ("other", other))):
        proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, *weights], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"chip_smoke: serving in {tree} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            d = {"tree": tag, "round": rnd, **json.loads(line)}
            with log.open("a") as f:
                f.write(json.dumps(d) + "\n")
            keys = ("tokens_per_s", "ttft_ms", "wall_s", "wall_ms", "device_busy_ms",
                    "idle_share", "by_class_ms", "max_memory_allocated")
            print(json.dumps({k: d[k] for k in ("tree", "round", "phase", *keys) if k in d}),
                  flush=True)
    return 0


# One serving run of each configuration in argv ("weights" or
# "weights:overlap_off") of the tree in the working directory, by its own
# chip_smoke.py, one JSON line each with its greedy streams (--streams-ab).
_STREAMS_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
for arg in sys.argv[1:]:
    weights, _, off = arg.partition(":")
    e = cs.phase_engine(torch, weights=weights, overlap=not off)
    print(json.dumps({"config": arg, **e}), flush=True)
"""


def streams_ab(other: Path, configs: list[str]) -> int:
    """The unguided serving phases of ``configs`` once in ``other`` and once
    in this tree, each tree in a fresh process: one line per configuration
    with whether both issued the same forwards, emitted the same greedy
    streams (and where they first part) and counted the same kernel
    launches. Every line in ``OUT_DIR/streams_ab.jsonl``. Fails if a
    configuration's streams or launch counts differ."""
    log = OUT_DIR / "streams_ab.jsonl"
    log.write_text("")
    runs = {}
    for tag, tree in (("other", other), ("this", ROOT)):
        proc = subprocess.run([sys.executable, "-c", _STREAMS_CHILD, *configs], cwd=tree,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(f"chip_smoke: serving in {tree} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        runs[tag] = {d["config"]: d for d in map(json.loads, (
            line for line in proc.stdout.splitlines() if line.startswith("{")))}
    same = True
    for config in configs:
        a, b = runs["other"][config], runs["this"][config]
        line = {"config": config, "phase": b["phase"],
                "same_dispatches": a["dispatches"] == b["dispatches"],
                "same_greedy_tokens": a["greedy_tokens"] == b["greedy_tokens"],
                "first_divergence": first_divergence(a["greedy_tokens"], b["greedy_tokens"]),
                "same_launches": a["launches"] == b["launches"], "launches": b["launches"],
                "completion_tokens": [a["completion_tokens"], b["completion_tokens"]],
                "wall_s": [a["wall_s"], b["wall_s"]]}
        same &= line["same_greedy_tokens"] and line["same_launches"]
        with log.open("a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0 if same else 1


# The attention kernel phases of the tree in the working directory, by its
# own chip_smoke.py (--kernel-ab): device ms of K1 (decode input), K2 (4 x 512
# prefill, T=8 verify, one-row prefill at 4096) and W1's five ragged cases
# (each tree's "device_ms" of its ragged case: K2's kernel at [N / 8, 8] with
# the two block gathers before this tree, the ragged kernel's per-layer
# launch here).
_KERNEL_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from runbookai_tpu_torch.ops import paged_attention as pa
cs.phase_build()
dec = cs.phase_decode(pa, torch)["bfloat16"]
chk = cs.phase_chunk(pa, torch)["bfloat16"]
rag = cs.phase_ragged(pa, torch)
row = {"K1_decode": dec["device_ms"], "K2_prefill": chk["device_ms"],
       "K2_verify": chk["verify"]["device_ms"],
       "K2_one_row_prefill": chk["prefill_one_row"]["device_ms"]}
row.update({"W1_" + k: rag[k]["device_ms"] for k in ("served", "long", "int8", "group7", "hd64")})
print(json.dumps(row), flush=True)
"""


def kernel_ab(other: Path) -> int:
    """The attention kernel phases of ``other`` and of this tree, in the
    order other, this, this, other, each in a fresh process; each run's
    device times and, per key, this tree's mean over the other's, in
    ``OUT_DIR/kernel_ab.jsonl``."""
    out = OUT_DIR / "kernel_ab.jsonl"
    out.write_text("")
    runs: dict[str, list] = {"other": [], "this": []}
    for tree, which in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, "-c", _KERNEL_CHILD], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        line = json.dumps({"tree": which, **row})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    ratio = {key: sum(r[key] for r in runs["this"]) / sum(r[key] for r in runs["other"])
             for key in runs["this"][0]}
    line = json.dumps({"this_over_other": ratio})
    print(line, flush=True)
    with out.open("a") as f:
        f.write(line + "\n")
    return 0


def mixed_forward_times(torch) -> dict:
    """One mixed forward (``forward_ragged_impl``) of ENGINE_MODEL at full
    width and depth, random bf16 weights from seed 0, on the ragged phase's
    "served" batch (8 decode rows at the served contexts and a 512-token
    prefill at offset 4096: N = 576, 13 rows) over a 32-layer pool: CUDA
    events over back-to-back forwards, the profiler's device time, and the
    host's time to issue one forward (no sync). Uses the package of the
    working directory, so that two trees are timed by one measurement."""
    from runbookai_tpu_torch.models import llama

    cfg = llama.get_config(ENGINE_MODEL)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, torch.bfloat16, dev, gen)
    _, k, v, tables, ctx, pos, rows, _ = ragged_inputs(torch, dev, gen, torch.bfloat16, "served",
                                                       cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    kv_k = k[None].expand(cfg.n_layers, *k.shape).contiguous()
    kv_v = v[None].expand(cfg.n_layers, *v.shape).contiguous()
    del k, v
    tokens = torch.randint(0, cfg.vocab_size, (pos.numel(),), generator=gen, device=dev)
    sel = torch.cat([torch.arange(B, device=dev) * RQ,
                     torch.tensor([B * RQ + MIX_PF_TOKENS - 1], device=dev)])

    def forward():
        return llama.forward_ragged_impl(params, cfg, tokens, pos, rows, kv_k, kv_v, tables,
                                         ctx, sel, PS, ragged_block=RQ)

    logits = forward()
    torch.cuda.synchronize()
    if not bool(logits.isfinite().all()):
        raise AssertionError("mixed forward: non-finite logits")
    return {"ms": time_ms(forward, iters=10, warmup=2), "device_ms": device_ms(forward, iters=3),
            "host_ms": host_ms(forward, iters=10), "layers": cfg.n_layers,
            "tokens": pos.numel()}


# One mixed forward of the tree in the working directory (--forward-ab),
# measured by this tree's mixed_forward_times (its path in argv[1]).
_FORWARD_CHILD = """
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_measure", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(json.dumps(cs.mixed_forward_times(torch)), flush=True)
"""


def forward_ab(other: Path) -> int:
    """One mixed forward of ``other`` and of this tree (the same inputs and
    weights, measured by this file's :func:`mixed_forward_times`), in the
    order other, this, this, other, each in a fresh process; each run's
    times and this tree's mean over the other's in
    ``OUT_DIR/forward_ab.jsonl``."""
    out = OUT_DIR / "forward_ab.jsonl"
    out.write_text("")
    runs: dict[str, list] = {"other": [], "this": []}
    for tree, which in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, "-c", _FORWARD_CHILD, str(Path(__file__))],
                              cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        line = json.dumps({"tree": which, **row})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    ratio = {key: sum(r[key] for r in runs["this"]) / sum(r[key] for r in runs["other"])
             for key in ("ms", "device_ms", "host_ms")}
    line = json.dumps({"this_over_other": ratio})
    print(line, flush=True)
    with out.open("a") as f:
        f.write(line + "\n")
    return 0


def served_line(res: dict) -> dict:
    """A serving phase's line: the forwards it issued counted, not listed."""
    return {**{k: v for k, v in res.items() if k != "dispatches"},
            "forwards": len(res["dispatches"])}


def overlap_ab() -> int:
    """Each serving configuration profiled with the overlapped pipeline on
    and off, in the order on, off, off, on, after one serving run that is
    not recorded (the first run of a configuration in a process pays its
    warm-up): the device's idle share and the serving wall of each run.
    Every line also in ``OUT_DIR/overlap_ab.jsonl``."""
    import torch

    log = OUT_DIR / "overlap_ab.jsonl"
    log.write_text("")
    for weights in ("bfloat16", "int8", "kv_split"):
        phase_engine(torch, weights)
        for rnd, overlap in enumerate((True, False, False, True)):
            res = phase_profile(torch, weights, overlap)
            line = {"round": rnd, "weights": weights, "overlap_decode": overlap,
                    **{k: res[k] for k in ("phase", "wall_ms", "device_busy_ms",
                                           "idle_share")}}
            with log.open("a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


# Phase 18: `investigate` and `ask` through the port's CLI at full width.
AGENT_NOW = 1_790_000_000.0  # time.time() in the agent phases (fixture stamps)
# Depth of the agent phases' 8B. At the schemas' default limits random
# weights run each string to its 512-byte cap, and the agent decodes one
# request at a time, so a document takes hundreds to thousands of tokens;
# the phases serve under phase 15's limits (GUIDED_LIMITS) at CUT_LAYERS,
# graphs on and off. At 8 layers, with phase 24 added, the whole script
# took 955.4 s of phases on an H100 at 700 W, past the 950 s it aims for;
# phases 18 and 19's agent runs took 147 s of it.
AGENT_LAYERS = CUT_LAYERS
AGENT_MAX_NEW = 512  # every guided call's budget (llm.max_new_tokens), as phase 15's
# The e2e test's budgets (tests/test_investigate_e2e_engine.py).
AGENT_BUDGETS = {"max_hypotheses": 2, "max_hypothesis_depth": 1,
                 "max_investigation_iterations": 2}
_SIM = {"enabled": True, "simulated": True}
# investigate: the five simulated providers (20 tools; its prompts stay under
# 2k byte tokens). ask: aws alone (14 tools), whose first prompt is 7,816
# byte tokens with its tool schemas, under the 8,192 context with room for
# AGENT_ASK_MAX_NEW; with kubernetes too it is 8,258 and the engine aborts it.
AGENT_PROVIDERS = {
    "investigate": {"providers": {"aws": _SIM, "kubernetes": _SIM, "github": _SIM},
                    "observability": {"datadog": _SIM}, "incident": {"pagerduty": _SIM}},
    "ask": {"providers": {"aws": _SIM}},
}
AGENT_ASK_MAX_NEW = 256
AGENT_ARGV = {
    "investigate": ["investigate", "PD-424242", "--description",
                    "checkout latency p99 elevated after deploy"],
    "ask": ["ask", "why is checkout latency high?"],
}


def agent_config(tmp: Path, cmd: str, kb: Optional[dict] = None,
                 providers: Optional[dict] = None, provider: str = "jax-tpu",
                 model: str = ENGINE_MODEL, max_seq_len: Optional[int] = None) -> Path:
    """The phase's ``config.yaml``: ``model`` (the 8B) from seed 0 in bf16
    on the serving engine (``llm.provider: jax-tpu``; ``llm.max_seq_len``
    where given), byte tokenizer, simulated providers (``providers``, else
    ``AGENT_PROVIDERS[cmd]``), the e2e test's budgets, everything under
    ``tmp``. With ``kb`` (phase 19), its ``knowledge`` block and its service
    graph as ``<runbook_dir>/service-graph.json``."""
    import yaml

    max_new = AGENT_ASK_MAX_NEW if cmd == "ask" else AGENT_MAX_NEW
    llm = {"provider": provider, "model": model, "max_new_tokens": max_new}
    if max_seq_len:
        llm["max_seq_len"] = max_seq_len
    doc = {**(AGENT_PROVIDERS[cmd] if providers is None else providers),
           "runbook_dir": str(tmp / "rb"), "agent": AGENT_BUDGETS, "llm": llm}
    if kb is not None:
        doc["knowledge"] = kb["knowledge"]
        (tmp / "rb").mkdir(parents=True, exist_ok=True)
        (tmp / "rb" / "service-graph.json").write_text(kb["graph"])
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def agent_document(text: str, name: str, req) -> dict:
    """A guided call's document: it must parse and validate against its
    schema and end on a stop token, or, complete, pad its budget with the
    whitespace the grammar admits beside the stop."""
    from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS

    doc = json.loads(text)
    SCHEMA_MODELS[name].model_validate(doc)
    end = json.JSONDecoder().raw_decode(text.lstrip())[1]
    reason = req.finish_reason.value
    if reason != "stop_token" and (reason != "max_tokens"
                                   or text.lstrip()[end:].strip(" \t\n\r")):
        raise AssertionError(f"agent {name} finished by {reason}: {text[-80:]!r}")
    return {"bytes": len(text.encode()), "trailing_whitespace": len(text.lstrip()) - end}


def phase_agent(torch, cmd: str, graphs: bool = True, kb: Optional[dict] = None,
                model: str = ENGINE_MODEL, max_seq_len: Optional[int] = None,
                tag: str = "") -> dict:
    """``python -m runbookai_tpu_torch <cmd> ... --yes`` in this process
    (``__main__.main(argv)``) on the phase's config: the client is
    ``TorchCudaClient.from_config``'s at ``AGENT_LAYERS`` of the 8B's
    layers, built with phase 15's schema limits and ``engine={"step_graphs":
    graphs}`` laid over its engine. Launch counts are
    zeroed once the client is built (its capture included) and read when
    the command returns; ``time.time`` is pinned (``AGENT_NOW``), as the
    simulated fixtures stamp their records with it. Fails unless the
    command exits 0, K1 and K2 launched, the step graphs replayed (graphs
    on) or not (off), every guided call's document parses under its schema
    (:func:`agent_document`) and ``investigate`` reaches its root cause with
    the machine complete in its checkpoint. With ``kb`` (phase 19: the
    knowledge block of a synced ``knowledge.db``, a service graph and the
    providers), the command runs over that knowledge base, and it also
    fails unless ``investigate``'s remediation prompt carries ids of
    retrieved documents, or ``ask`` printed its ``knowledge_retrieved``
    event. ``model`` and ``max_seq_len`` set the config's ``llm.model`` and
    ``llm.max_seq_len`` (the model cut to ``AGENT_LAYERS``); ``tag`` ends the
    phase's name."""
    import dataclasses
    import io
    import tempfile
    from unittest import mock

    from runbookai_tpu_torch import __main__ as cli
    from runbookai_tpu_torch.model.schema_guided import SchemaLimits
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama

    free_device(torch)
    built: list = []
    build = TorchCudaClient.build.__func__
    from_config = TorchCudaClient.from_config.__func__

    def counted_from_config(cls, *args, **kw):
        t0 = time.perf_counter()
        client = from_config(cls, *args, **kw)
        torch.cuda.synchronize()
        built.append((client, time.perf_counter() - t0))
        reset_counts()
        return client

    def build_graphs(cls, *args, **kw):
        return build(cls, *args, **kw, schema_limits=SchemaLimits(**GUIDED_LIMITS),
                     engine={"step_graphs": graphs})

    cfg = llama.get_config(model)
    depth = {model: dataclasses.replace(cfg, n_layers=AGENT_LAYERS)}

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        config = agent_config(Path(tmp), cmd, kb, kb and kb["providers"], model=model,
                              max_seq_len=max_seq_len)
        argv = [*(kb["argv"] if kb else AGENT_ARGV[cmd]), "--yes", "--device", DEVICE,
                "--config", str(config)]
        with mock.patch.object(TorchCudaClient, "from_config",
                               classmethod(counted_from_config)), \
                mock.patch.object(TorchCudaClient, "build", classmethod(build_graphs)), \
                mock.patch.dict(llama.CONFIGS, depth), \
                mock.patch("time.time", return_value=AGENT_NOW), \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
        snapshot = None
        if cmd == "investigate":
            (saved,) = (Path(tmp) / "rb" / "checkpoints" / "PD-424242").glob("cp-*.json")
            snapshot = json.loads(saved.read_text())["snapshot"]
            snapshot.pop("elapsed_s")
    launched = counts()
    (client, build_s), = built
    core = client.core
    printed = out.getvalue()
    if rc != 0 or client.engine.crash_count:
        raise AssertionError(f"agent {cmd}: exit {rc}, {client.engine.crash_count} crashes")
    calls, docs = [], {}
    for i, req in enumerate(core.finished):
        name = req.sampling.guided
        text = core.output_for(req).text
        call = {"call": name or "chat",
                "prompt_tokens": len(req.prompt_ids) - len(req.folded_out_ids),
                "completion_tokens": req.num_generated, "ttft_ms": req.ttft_ms,
                "wall_s": req.finish_time - req.arrival_time,
                "finish_reason": req.finish_reason.value}
        if name:
            call.update(agent_document(text, name, req))
        calls.append(call)
        docs[f"{i}:{name or 'chat'}"] = req.all_out_ids
    guided = [c for c in calls if c["call"] != "chat"]
    phase_wall: dict = {}
    for c in guided:
        phase_wall[c["call"]] = phase_wall.get(c["call"], 0.0) + c["wall_s"]
    metrics = dict(core.metrics)
    if not (launched["paged_decode_attention"] and launched["paged_chunk_attention"]):
        raise AssertionError(f"agent {cmd}: K1 or K2 not launched: {launched}")
    if (metrics["graph_replays"] > 0) != graphs:
        raise AssertionError(f"agent {cmd}: step graphs {graphs}, but "
                             f"{metrics['graph_replays']} replays")
    if cmd == "investigate" and ("\nroot cause:" not in printed
                                 or snapshot["phase"] != "complete"):
        raise AssertionError(f"investigate ended in phase {snapshot['phase']}")
    if cmd == "ask" and not (calls and calls[0]["call"] == "chat"
                             and calls[0]["finish_reason"] != "aborted"):
        raise AssertionError(f"ask: its first call was not served: {calls[:1]}")
    guided_tokens = sum(c["completion_tokens"] for c in guided)
    guided_wall = sum(c["wall_s"] for c in guided)
    name = (f"agent_{cmd}" + ("_knowledge" if kb else "") + tag
            + ("" if graphs else "_graphs_off"))
    extra = {}
    if kb is not None:
        extra = knowledge_in_run(cmd, client, printed, kb, snapshot)
    (OUT_DIR / f"{name}.txt").write_text(printed)
    return {"phase": name, **extra,
            "step_graphs": graphs, "model": model, "layers": AGENT_LAYERS,
            "max_seq_len": core.ecfg.max_seq_len,
            "schema_limits": GUIDED_LIMITS, "argv": argv[:-1],
            "providers": AGENT_PROVIDERS[cmd] if kb is None else kb["providers"],
            "budgets": AGENT_BUDGETS,
            "build_s": build_s, "graph_capture_s": metrics["graph_capture_s"],
            "wall_s": wall, "llm_calls": len(calls),
            "prompt_tokens": sum(c["prompt_tokens"] for c in calls),
            "completion_tokens": sum(c["completion_tokens"] for c in calls),
            "grammar_forced_tokens": metrics["grammar_forced_tokens"],
            "guided_tokens": guided_tokens,
            "guided_tokens_per_s": guided_tokens / guided_wall if guided_wall else None,
            "phase_wall_s": phase_wall, "calls": calls,
            "graph_replays": metrics["graph_replays"], "launches": launched,
            "engine_metrics": metrics, "printed_lines": printed.count("\n"),
            "printed": printed, "documents": docs, "checkpoint": snapshot}


def agent_phases(torch) -> None:
    """``investigate``, then ``ask``: :func:`phase_agent` with the step
    graphs on, then off; what was printed (events, tree, root cause,
    answer), every call's tokens and the final checkpoint must be the
    same, byte for byte."""
    for cmd in ("investigate", "ask"):
        on = phase_agent(torch, cmd)
        emit(agent_line(on))
        off = phase_agent(torch, cmd, graphs=False)
        for key in ("printed", "documents", "checkpoint"):
            if on[key] != off[key]:
                raise AssertionError(f"agent {cmd}: graphs off gave another {key}")
        emit(agent_line({**off, "same_as_graphs": True}))


def agent_line(res: dict) -> dict:
    """An agent phase's line: what it printed and its token streams counted,
    not listed."""
    return {**{k: v for k, v in res.items() if k not in ("printed", "documents")},
            "printed_bytes": len(res["printed"].encode()),
            "documents": len(res["documents"])}


# Phase 19: the knowledge path. The bge-base encoder at full width beside the
# 8B, `knowledge sync` and `knowledge search` over a generated tree, and
# phase 18's commands over the synced knowledge base.
KNOWLEDGE_MODEL = "bge-base-en-v1.5"  # dim 768, 12 layers, 12 heads, ffn 3072, f32
KNOWLEDGE_SEED = 0
KNOWLEDGE_DOCS = 512  # generated documents, beside the three example runbooks
KNOWLEDGE_BATCH = 64  # the embedder's batch (EmbedderConfig.batch_size)
KNOWLEDGE_BUCKETS = (16, 64, 256, 512)  # the embedder's length buckets timed
KNOWLEDGE_CPU_ROWS = 4  # rows a bucket held against the CPU
KNOWLEDGE_TOL = 1e-4  # max |err| of an f32 embedding, card vs CPU
KNOWLEDGE_SCORE_TOL = 1e-5  # max |err| of a search cosine, card vs CPU
KNOWLEDGE_GOLDEN_TOL = (2e-4, 2e-3)  # hf-tiny-bert (atol, rtol), the JAX test's
KNOWLEDGE_QUERIES = 32
KNOWLEDGE_CONTEXT = 8192  # the 8B's context: ask's first prompt + its budget must fit
# A how-to question: the agent answers it from the retrieved knowledge alone
# (agent.py's knowledge-only path), a prompt without the tools' schemas.
KNOWLEDGE_HOWTO = "how to mitigate connection exhaustion on payment-api"
KNOWLEDGE_SERVICES = ("payment-api", "payments-db", "checkout-web", "inventory-service",
                      "auth-service", "order-service", "search-api", "notification-worker",
                      "redis-cache", "kafka-broker", "cdn-edge", "user-profile")
KNOWLEDGE_DEPENDS = (("checkout-web", "payment-api"), ("checkout-web", "inventory-service"),
                     ("checkout-web", "cdn-edge"), ("payment-api", "payments-db"),
                     ("payment-api", "redis-cache"), ("payment-api", "auth-service"),
                     ("order-service", "payment-api"), ("order-service", "kafka-broker"),
                     ("notification-worker", "kafka-broker"), ("search-api", "redis-cache"),
                     ("user-profile", "auth-service"), ("inventory-service", "payments-db"))
_KNOWLEDGE_TYPES = ("runbook", "postmortem", "known-issue", "troubleshooting", "procedure",
                    "architecture")
_SYMPTOMS = ("latency", "5xx errors", "timeouts", "OOMKilled restarts", "CrashLoopBackOff",
             "connection exhaustion", "disk pressure", "certificate expiry", "consumer lag",
             "cache misses", "throttling", "lock contention")
_WORDS = ("the pool connection deploy rollback replica primary failover latency p99 error "
          "rate queue consumer lag partition broker cache eviction memory heap limit request "
          "timeout retry backoff circuit breaker upstream downstream dependency alarm "
          "dashboard metric threshold saturation cpu node pod container restart probe "
          "readiness liveness ingress balancer dns certificate ttl shard index query plan "
          "lock contention transaction write read throughput capacity autoscaling on-call "
          "page incident mitigation customer impact region zone config flag canary").split()
_STEPS = ("Check the {m} dashboard for `{svc}` over the last hour.",
          "Compare {m} before and after the most recent deploy of `{svc}`.",
          "List the pods: `kubectl get pods -n prod -l app={svc}`.",
          "Read the last 15 minutes of logs: `kubectl logs deploy/{svc} --since=15m`.",
          "Confirm whether the {m} alarm fired for `{svc}` or a dependency.",
          "Scale `{svc}` out by two replicas if saturation is above 80%.",
          "Roll back `{svc}` to the previous image if the deploy is the trigger.",
          "Page the owning team of `{svc}` if the {m} does not recover in 10 minutes.")
_COMMANDS = ("kubectl get pods -n prod -l app={svc}", "kubectl describe deploy/{svc} -n prod",
             "kubectl rollout undo deploy/{svc} -n prod", "redis-cli -h {svc} INFO clients",
             "aws cloudwatch describe-alarms --alarm-name-prefix {svc}",
             "psql -c 'select count(*) from pg_stat_activity'")


def knowledge_tree(root: Path, n_docs: int = KNOWLEDGE_DOCS, seed: int = KNOWLEDGE_SEED) -> dict:
    """A markdown tree shaped like ``examples/runbooks/*.md`` under ``root``:
    ``n_docs`` documents drawn from ``seed`` (frontmatter with type,
    services, symptoms and severity; a title, symptom bullets, numbered
    triage and mitigation steps, commands and background prose, 2-8 KB each)
    and the three example runbooks. Returns the counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pick = lambda seq, n=None: (seq[int(rng.integers(len(seq)))] if n is None  # noqa: E731
                                else [seq[i] for i in rng.choice(len(seq), n, replace=False)])

    def sentence() -> str:
        words = pick(_WORDS, int(rng.integers(8, 21)))
        return " ".join(words).capitalize() + "."

    def paragraph() -> str:
        return " ".join(sentence() for _ in range(int(rng.integers(3, 7))))

    (root / "generated").mkdir(parents=True, exist_ok=True)
    total = 0
    for i in range(n_docs):
        kind, svcs = pick(_KNOWLEDGE_TYPES), pick(KNOWLEDGE_SERVICES, int(rng.integers(1, 4)))
        symptoms = pick(_SYMPTOMS, int(rng.integers(1, 3)))
        target = int(rng.integers(2048, 8193))
        svc, m = svcs[0], symptoms[0]
        steps = lambda n: "\n".join(f"{j + 1}. " + pick(_STEPS).format(svc=pick(svcs), m=m)  # noqa: E731
                                    for j in range(n))
        parts = [
            "---", f"type: {kind}", f"services: [{', '.join(svcs)}]",
            f"symptoms: [{', '.join(symptoms)}]",
            f"severity: {pick(('critical', 'high', 'medium', 'low'))}", "---",
            f"# {svc} {m} {kind} {i:03d}", "",
            f"**Service:** {', '.join(svcs)}", f"**Severity when seen:** P{int(rng.integers(1, 4))}",
            "", "## Symptoms", "",
            *(f"- {s} on `{pick(svcs)}`: {sentence()}" for s in symptoms),
            "", "## Triage", "", steps(int(rng.integers(3, 7))),
            "", "## Common root causes", "", paragraph(),
            "", "## Mitigation", "", steps(int(rng.integers(2, 6))),
            "", "## Commands", "", "```",
            *(pick(_COMMANDS).format(svc=pick(svcs)) for _ in range(int(rng.integers(1, 4)))),
            "```", "", "## Background", ""]
        text = "\n".join(parts)
        while len(text) < target:
            text += "\n" + paragraph() + "\n"
        (root / "generated" / f"doc-{i:03d}.md").write_text(text)
        total += len(text.encode())
    examples = sorted((ROOT / "examples" / "runbooks").glob("*.md"))
    (root / "examples").mkdir(exist_ok=True)
    for path in examples:
        (root / "examples" / path.name).write_text(path.read_text())
        total += path.stat().st_size
    return {"documents": n_docs + len(examples), "bytes": total}


def knowledge_queries(n: int = KNOWLEDGE_QUERIES, seed: int = KNOWLEDGE_SEED) -> list[str]:
    """``n`` search queries an on-call engineer would type, drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    forms = ("why is {svc} showing {m}", "{m} on {svc} after deploy", "how to mitigate {m}",
             "{svc} {m} runbook", "postmortem {svc} {m}", "what depends on {svc}")
    queries: list[str] = []
    while len(queries) < n:  # distinct: a repeated query would hit the embedder's cache
        q = forms[len(queries) % len(forms)].format(
            svc=KNOWLEDGE_SERVICES[int(rng.integers(len(KNOWLEDGE_SERVICES)))],
            m=_SYMPTOMS[int(rng.integers(len(_SYMPTOMS)))])
        if q not in queries:
            queries.append(q)
    return queries


def knowledge_graph_json() -> str:
    """The services of the tree and their dependencies, as the port's
    ``ServiceGraph`` saves them (``<runbook_dir>/service-graph.json``)."""
    from runbookai_tpu_torch.knowledge.store.graph import ServiceGraph

    graph = ServiceGraph()
    for i, svc in enumerate(KNOWLEDGE_SERVICES):
        graph.add_service(svc, team=("payments", "storefront", "platform")[i % 3], tier=1 + i % 3)
    for src, dst in KNOWLEDGE_DEPENDS:
        graph.add_dependency(src, dst)
    return json.dumps({"nodes": [vars(n) for n in graph.nodes.values()],
                       "edges": [vars(e) for e in graph.edges]}, indent=2)


def encoder_work(cfg, mask) -> tuple[float, float]:
    """(bytes, operations) one encode must move and do for these inputs:
    every layer weight read once, the gathered embedding rows, the token ids
    and mask, the [B, dim] output; 2 flops a multiply-add of the
    projections (2 * (4 * dim^2 + 2 * dim * ffn) a real token a layer) and of
    attention over each row's real keys (4 * len^2 * dim a row a layer).
    Padding is not counted."""
    lens = mask.sum(1).double()
    tokens = float(lens.sum())
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    layer_params = L * (4 * d * d + 4 * d + 2 * d * f + f + d + 4 * d)
    n_bytes = 4 * (layer_params + tokens * d + mask.shape[1] * d + 3 * d
                   + mask.shape[0] * d) + 2 * mask.numel() * 8
    flops = L * (2 * tokens * (4 * d * d + 2 * d * f) + float((4 * lens * lens * d).sum()))
    return n_bytes, flops


def phase_knowledge_encode(torch) -> dict:
    """The bge-base encoder at full width in f32, random weights from
    ``KNOWLEDGE_SEED`` (drawn on the CPU, so the CPU copy is the same), at
    B = 64 and each length bucket with ragged masks: events, device and
    cold ms beside the bound at the f32 peak; the first 4 rows against the
    same encoder on the CPU (max |err| <= KNOWLEDGE_TOL); the hf-tiny-bert
    golden on the card at the JAX test's tolerance."""
    import numpy as np

    from runbookai_tpu_torch.models import bge

    free_device(torch)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the encoder must run in full f32")
    t0 = time.perf_counter()
    cfg, params = bge.load_or_init(KNOWLEDGE_MODEL, None, seed=KNOWLEDGE_SEED, device=DEVICE)
    enc = bge.BertEncoder(cfg, params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu = bge.BertEncoder(cfg, bge.load_or_init(KNOWLEDGE_MODEL, None, seed=KNOWLEDGE_SEED,
                                                device="cpu")[1])
    gen = torch.Generator().manual_seed(KNOWLEDGE_SEED + 1)
    out: dict = {"phase": "knowledge_encode", "model": KNOWLEDGE_MODEL,
                 "config": {k: getattr(cfg, k) for k in ("dim", "n_layers", "n_heads",
                                                         "ffn_dim", "max_positions")},
                 "dtype": "float32", "batch": KNOWLEDGE_BATCH, "load_s": load_s,
                 "peak_flops_f32": PEAK_FLOPS["float32"], "buckets": {}}
    worst = 0.0
    for t in KNOWLEDGE_BUCKETS:
        tokens = torch.randint(0, cfg.vocab_size, (KNOWLEDGE_BATCH, t), generator=gen)
        lens = torch.randint(1, t + 1, (KNOWLEDGE_BATCH,), generator=gen)
        lens[0] = t  # one full row a bucket
        mask = (torch.arange(t)[None, :] < lens[:, None]).long()
        tok_d, mask_d = tokens.to(DEVICE), mask.to(DEVICE)
        got = enc.encode(tok_d, mask_d)
        want = cpu.encode(tokens[:KNOWLEDGE_CPU_ROWS], mask[:KNOWLEDGE_CPU_ROWS])
        if tuple(got.shape) != (KNOWLEDGE_BATCH, cfg.dim) or not bool(got.isfinite().all()):
            raise AssertionError(f"encoder at T={t}: shape {tuple(got.shape)} or non-finite")
        err = float((got[:KNOWLEDGE_CPU_ROWS].cpu() - want).abs().max())
        norms = got.norm(dim=-1)
        if err > KNOWLEDGE_TOL or float((norms - 1).abs().max()) > 1e-5:
            raise AssertionError(f"encoder at T={t}: max |err| {err:.3e} vs the CPU "
                                 f"(tol {KNOWLEDGE_TOL}), norms {norms.min():.6f}..")
        worst = max(worst, err)
        call = lambda: enc.encode(tok_d, mask_d)  # noqa: E731
        n_bytes, flops = encoder_work(cfg, mask)
        bound_ms, bound_by = bound(n_bytes, flops, "float32")
        ms = time_ms(call, iters=10, warmup=2)
        out["buckets"][str(t)] = {
            "real_tokens": int(mask.sum()), "max_abs_err": err, "ms": ms,
            "device_ms": device_ms(call, iters=5), "cold_ms": cold_ms(call, iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "bytes": n_bytes, "share_of_bound": bound_ms / ms}
    out["max_abs_err"] = worst
    # The checked-in HF golden (transformers' BertModel CLS, normalised).
    fixture = ROOT / "tests" / "fixtures" / "hf-tiny-bert"
    gcfg, gparams = bge.load_params(fixture, device=DEVICE)
    blob = np.load(fixture / "expected_embeddings.npz")
    golden = bge.BertEncoder(gcfg, gparams).encode(
        torch.from_numpy(blob["input_ids"]).to(DEVICE),
        torch.from_numpy(blob["attention_mask"]).to(DEVICE)).cpu().numpy()
    atol, rtol = KNOWLEDGE_GOLDEN_TOL
    np.testing.assert_allclose(golden, blob["cls_norm"], atol=atol, rtol=rtol)
    out["hf_golden_max_abs_err"] = float(np.abs(golden - blob["cls_norm"]).max())
    del enc, cpu, params
    return out


def knowledge_block(tree: Path, db: Path) -> dict:
    """The ``knowledge`` block of the phase's configs: the tree as one
    filesystem source, the db, bge-base at its defaults."""
    return {"sources": [{"type": "filesystem", "name": "runbooks", "path": str(tree)}],
            "db_path": str(db), "embedder": {"model": KNOWLEDGE_MODEL}}


def run_cli(argv: list[str]) -> tuple[int, str, float]:
    """``python -m runbookai_tpu_torch <argv> --device DEVICE`` in this
    process: (exit code, what it printed, wall seconds)."""
    import contextlib
    import io

    from runbookai_tpu_torch import __main__ as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cli.main([*argv, "--device", DEVICE])
        wall = time.perf_counter() - t0
    return rc, out.getvalue(), wall


def percentiles(xs: list[float]) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "mean": float(np.mean(xs))}


def phase_knowledge_sync(torch, tmp: Path) -> tuple[dict, dict]:
    """``knowledge sync`` through the port's CLI over :func:`knowledge_tree`
    (encoder seconds and the length buckets read around each encode), then
    ``KNOWLEDGE_QUERIES`` hybrid searches (``knowledge search``'s call) on a
    retriever on the card, each split into query encode, vector top-k and
    FTS, and the same searches on a retriever on the CPU over the same db and
    weights: every cosine within ``KNOWLEDGE_SCORE_TOL`` of the CPU's, and the
    hit ids equal, up to ranks that a tie within that error swaps
    (:func:`compare_rankings`). Then ``knowledge search``,
    ``add``, ``stats`` and ``validate`` once each through the CLI. Returns the
    line and the knowledge base for the agent runs."""
    import contextlib
    import sqlite3
    from unittest import mock

    import yaml

    from runbookai_tpu_torch.knowledge.retriever import create_retriever
    from runbookai_tpu_torch.models import bge
    from runbookai_tpu_torch.utils.config import load_config

    free_device(torch)
    tree, db = tmp / "kb", tmp / "knowledge.db"
    t0 = time.perf_counter()
    made = knowledge_tree(tree, KNOWLEDGE_DOCS)
    tree_s = time.perf_counter() - t0
    kblock = knowledge_block(tree, db)
    cfg_path = tmp / "knowledge.yaml"
    cfg_path.write_text(yaml.safe_dump({"knowledge": kblock, "runbook_dir": str(tmp / "rb")}))
    encode = bge.BertEncoder.encode
    enc_s, enc_buckets = [0.0], {}

    def timed_encode(self, tokens, mask):
        t1 = time.perf_counter()
        emb = encode(self, tokens, mask)
        torch.cuda.synchronize()
        enc_s[0] += time.perf_counter() - t1
        key = str(tokens.shape[1])
        enc_buckets[key] = enc_buckets.get(key, 0) + 1
        return emb

    with mock.patch.object(bge.BertEncoder, "encode", timed_encode):
        rc, printed, sync_s = run_cli(["knowledge", "sync", "--config", str(cfg_path)])
    if rc != 0:
        raise AssertionError(f"knowledge sync: exit {rc}")
    stats = json.loads(printed[printed.index("{"):])
    if stats["documents"] != made["documents"] or stats["embeddings"] != stats["chunks"]:
        raise AssertionError(f"knowledge sync: {stats} for {made['documents']} documents")
    emb_tokens = stats["embedder"]["tokens"]
    config = load_config(path=str(cfg_path))
    queries = knowledge_queries(KNOWLEDGE_QUERIES)
    card = create_retriever(config, device=DEVICE)
    split: dict = {"encode": [], "vector": [], "fts": []}

    def timed(fn, key):
        def call(*args, **kw):
            t1 = time.perf_counter()
            res = fn(*args, **kw)
            split[key].append((time.perf_counter() - t1) * 1e3)
            return res
        return call

    h = card.hybrid
    t0 = time.perf_counter()
    h.search("warm-up", limit=8)  # loads the matrix onto the card
    first_ms = (time.perf_counter() - t0) * 1e3
    h.embedder.embed_text = timed(h.embedder.embed_text, "encode")
    h.vectors.search = timed(h.vectors.search, "vector")
    card.store.search = timed(card.store.search, "fts")
    total, ids_card = [], []
    for q in queries:
        t0 = time.perf_counter()
        hits = h.search(q, limit=8)
        total.append((time.perf_counter() - t0) * 1e3)
        ids_card.append([hit.chunk.chunk_id for hit in hits])
    latency = {"search_ms": percentiles(total),
               **{f"{k}_ms": percentiles(v) for k, v in split.items()}}
    cpu = create_retriever(config, device="cpu")
    ids_cpu = [[hit.chunk.chunk_id for hit in cpu.hybrid.search(q, limit=8)] for q in queries]
    n = h.vectors.count()
    rankings = [compare_rankings(
        h.vectors.search(h.embedder.embed_text(q, is_query=True), n),
        cpu.hybrid.vectors.search(cpu.hybrid.embedder.embed_text(q, is_query=True), n), 24)
        for q in queries]
    for q, a, b, rank in zip(queries, ids_card, ids_cpu, rankings):
        if a != b and not rank["swaps"]:
            raise AssertionError(f"knowledge search {q!r}: the card's hits {a} differ from "
                                 f"the CPU's {b} with the same vector ranking")
    if not all(ids_card):
        raise AssertionError("knowledge search: a query found nothing")
    del card, cpu
    # The other sub-commands once each, through the CLI.
    rc_s, searched, search_s = run_cli(["knowledge", "search", queries[0], "--config",
                                        str(cfg_path)])
    extra = tree / "added.md"
    knowledge_tree(tmp / "extra", n_docs=1, seed=KNOWLEDGE_SEED + 7)
    extra.write_text((tmp / "extra" / "generated" / "doc-000.md").read_text())
    rc_a, added, add_s = run_cli(["knowledge", "add", str(extra), "--config", str(cfg_path)])
    rc_t, stats_out, _ = run_cli(["knowledge", "stats", "--config", str(cfg_path)])
    rc_v, valid, _ = run_cli(["knowledge", "validate", "--config", str(cfg_path)])
    after = json.loads(stats_out)
    if (rc_s, rc_a, rc_t, rc_v) != (0, 0, 0, 0) or not searched.startswith("[") \
            or not added.startswith("added ") or valid.strip() != "ok" \
            or after["documents"] != stats["documents"] + 1:
        raise AssertionError(f"knowledge search/add/stats/validate: exits "
                             f"{(rc_s, rc_a, rc_t, rc_v)}, {added!r}, {valid!r}, {after}")
    line = {"phase": "knowledge_sync", "model": KNOWLEDGE_MODEL, "documents": stats["documents"],
            "tree_bytes": made["bytes"], "tree_s": tree_s, "chunks": stats["chunks"],
            "embedded_tokens": emb_tokens, "batches": stats["embedder"]["batches"],
            "batches_by_length": enc_buckets, "sync_wall_s": sync_s, "encoder_s": enc_s[0],
            "chunks_per_s": stats["chunks"] / sync_s, "tokens_per_s": emb_tokens / enc_s[0],
            "encoder_share_of_sync": enc_s[0] / sync_s,
            "queries": len(queries), "first_search_ms": first_ms, **latency,
            "same_ids_as_cpu": sum(a == b for a, b in zip(ids_card, ids_cpu)),
            "max_score_err_vs_cpu": max(r["max_score_err"] for r in rankings),
            "tie_swaps_vs_cpu": {q: r["swaps"] for q, r in zip(queries, rankings) if r["swaps"]},
            "hits_per_query": sum(map(len, ids_card)) / len(queries),
            "cli_search_s": search_s, "cli_add_s": add_s, "db_bytes": db.stat().st_size}
    with contextlib.closing(sqlite3.connect(str(db))) as con:
        doc_ids = {r[0] for r in con.execute("SELECT doc_id FROM documents")}
    kb = {"knowledge": kblock, "graph": knowledge_graph_json(), "doc_ids": doc_ids}
    return line, kb


def compare_rankings(card: list, cpu: list, k: int) -> dict:
    """One query's cosine over every chunk, (id, score) best first, on the
    card and on the CPU: each score within ``KNOWLEDGE_SCORE_TOL``, and at
    each of the top ``k`` ranks the same chunk, or two whose card scores
    differ by at most twice the largest score error (a tie that error can
    reorder: the one way the rankings may part). Returns the error and the
    swapped ranks with their gaps."""
    card_s, cpu_s = dict(card), dict(cpu)
    err = max(abs(card_s[i] - cpu_s[i]) for i in card_s)
    if err > KNOWLEDGE_SCORE_TOL:
        raise AssertionError(f"knowledge search: a cosine {err:.3e} off the CPU's")
    swaps = []
    for rank, ((a, _), (b, _)) in enumerate(zip(card[:k], cpu[:k])):
        if a != b:
            gap = abs(card_s[a] - card_s[b])
            if gap > 2 * err:
                raise AssertionError(f"knowledge search: rank {rank} holds {a} on the card, "
                                     f"{b} on the CPU, {gap:.3e} apart (error {err:.3e})")
            swaps.append({"rank": rank, "gap": gap})
    return {"max_score_err": err, "swaps": swaps}


def first_prompt_tokens(query: str, kb: dict, providers: dict) -> int:
    """The byte tokens of ``ask <query>``'s first chat prompt over the
    knowledge base with ``providers``, counted before it is served: the
    runtime built with the mock provider records the prompt (its retrieval
    runs on the card), rendered by the chat template the client serves it
    with."""
    import tempfile
    from unittest import mock

    from runbookai_tpu_torch.cli.runtime import build_agent, build_runtime
    from runbookai_tpu_torch.model.chat_template import build_chat_prompt
    from runbookai_tpu_torch.utils.config import load_config
    from runbookai_tpu_torch.utils.tokens import ByteTokenizer

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch("time.time", return_value=AGENT_NOW):
        path = agent_config(Path(tmp), "ask", kb, providers, provider="mock")
        runtime = build_runtime(load_config(path=str(path)), interactive=False, device=DEVICE)

        async def run():
            async for _ in build_agent(runtime).run(query):
                pass
        asyncio.run(run())
    call = runtime.llm.calls[0]
    return len(ByteTokenizer().encode(build_chat_prompt(call["system"], call["user"],
                                                        call["tools"])))


def knowledge_in_run(cmd: str, client, printed: str, kb: dict, snapshot) -> dict:
    """What a run over the knowledge base must show. ``ask``: it printed
    ``knowledge_retrieved``. ``investigate``: its triage prompt carries the
    ``search_knowledge`` step's hits (ids of documents in the db), and its
    remediation prompt the runbooks block that the orchestrator's
    ``fetch_relevant_runbooks`` makes from a retriever on the CPU over the
    same db and weights, for the machine's root cause and first service:
    its retrieved runbook ids, or "(none found)" where the search under the
    model's first service finds no runbook."""
    import re

    from runbookai_tpu_torch.agent.orchestrator import InvestigationOrchestrator, ToolExecutor
    from runbookai_tpu_torch.agent.state_machine import InvestigationStateMachine
    from runbookai_tpu_torch.knowledge.retriever import create_retriever
    from runbookai_tpu_torch.utils.config import Config

    if cmd == "ask":
        if "⚲ knowledge retrieved" not in printed:
            raise AssertionError("ask over the knowledge base: no knowledge_retrieved event")
        return {"knowledge_retrieved": True}

    def prompt_of(schema: str) -> str:
        (req,) = [r for r in client.core.finished if r.sampling.guided == schema]
        return client.tokenizer.decode(req.prompt_ids[:len(req.prompt_ids)
                                                       - len(req.folded_out_ids)])

    def doc_ids(text: str) -> list[str]:
        return [i for i in re.findall(r"[0-9a-f]{16}", text) if i in kb["doc_ids"]]

    triage = prompt_of("triage")
    step = triage[triage.find("search_knowledge:"):][:1600]
    triage_ids = doc_ids(step)
    if not triage_ids:
        raise AssertionError(f"investigate: no search_knowledge hit in the triage prompt: "
                             f"{step[:300]!r}")
    machine = InvestigationStateMachine(incident_id="PD-424242")
    machine.root_cause = snapshot["root_cause"]
    machine.affected_services = list(snapshot["affected_services"])
    cpu = create_retriever(Config.model_validate({"knowledge": kb["knowledge"]}), device="cpu")
    orch = InvestigationOrchestrator(None, ToolExecutor({}), machine=machine, knowledge=cpu)
    want = asyncio.run(orch.fetch_relevant_runbooks())
    remediation = prompt_of("remediation")
    if want not in remediation or want == "(runbook fetch failed)":
        raise AssertionError(f"investigate: the remediation prompt lacks the CPU "
                             f"retriever's runbooks {want[:200]!r}")
    return {"triage_knowledge_ids": triage_ids,
            "remediation_runbook_ids": re.findall(r"^\[([0-9a-f]{16})\]", want, re.M),
            "remediation_runbooks": want if want == "(none found)" else "ids",
            "remediation_query": {"root_cause": machine.root_cause,
                                  "service": (machine.affected_services or [None])[0]}}


def knowledge_phases(torch) -> None:
    """Phase 19: the encoder, then sync and search, then ``investigate``
    and ``ask`` over the synced base with a service graph (phase 18's runs,
    graphs on and off, equal). ``ask`` asks phase 18's question with aws's
    tools, then with none; where neither first prompt leaves its budget
    inside the 8B's context (the retrieved knowledge block alone is up to
    6,000 byte tokens), it asks ``KNOWLEDGE_HOWTO``, which the agent answers
    on its knowledge-only path (no tool schemas). Every count is kept. Then
    ``ask`` asks phase 18's question with aws's tools (the tool loop) on
    llama3.1-8b-instruct at ``llm.max_seq_len`` LONG_SEQ, whose context
    holds it, graphs on and off."""
    import tempfile

    emit(phase_knowledge_encode(torch))
    with tempfile.TemporaryDirectory() as tmp:
        line, kb = phase_knowledge_sync(torch, Path(tmp))
        emit(line)
        for cmd in ("investigate", "ask"):
            tried = {}
            kb.update(argv=AGENT_ARGV[cmd], providers=AGENT_PROVIDERS[cmd])
            if cmd == "ask":
                for argv, providers in ((AGENT_ARGV["ask"], AGENT_PROVIDERS["ask"]),
                                        (AGENT_ARGV["ask"], {}),
                                        (["ask", KNOWLEDGE_HOWTO], AGENT_PROVIDERS["ask"])):
                    n = first_prompt_tokens(argv[1], kb, providers)
                    tried[f"{argv[1]} | {json.dumps(providers)}"] = n
                    kb.update(argv=argv, providers=providers)
                    if n + AGENT_ASK_MAX_NEW <= KNOWLEDGE_CONTEXT:
                        break
                else:
                    raise AssertionError(f"ask: no first prompt fits the context: {tried}")
            agent_pair(torch, cmd, kb, first_prompt_tokens_tried=tried)
        # The tool-loop question on the long deployment's model and context
        # (phase 25): llm.model llama3.1-8b-instruct, llm.max_seq_len 32,768.
        kb.update(argv=AGENT_ARGV["ask"], providers=AGENT_PROVIDERS["ask"])
        n = first_prompt_tokens(AGENT_ARGV["ask"][1], kb, AGENT_PROVIDERS["ask"])
        if n + AGENT_ASK_MAX_NEW > LONG_SEQ:
            raise AssertionError(f"ask: its first prompt of {n} tokens does not fit {LONG_SEQ}")
        agent_pair(torch, "ask", kb, model=LONG_MODEL, max_seq_len=LONG_SEQ, tag="_32k",
                   first_prompt_tokens=n)


def agent_pair(torch, cmd: str, kb: dict, model: str = ENGINE_MODEL,
               max_seq_len: Optional[int] = None, tag: str = "", **line) -> None:
    """:func:`phase_agent` over the knowledge base with the step graphs on,
    then off: the same output, documents and checkpoint; ``line`` joins the
    first run's line."""
    kw = dict(kb=kb, model=model, max_seq_len=max_seq_len, tag=tag)
    on = phase_agent(torch, cmd, **kw)
    emit(agent_line({**on, **line}))
    off = phase_agent(torch, cmd, graphs=False, **kw)
    for key in ("printed", "documents", "checkpoint"):
        if on[key] != off[key]:
            raise AssertionError(f"agent {cmd}{tag} over knowledge: graphs off gave "
                                 f"another {key}")
    emit(agent_line({**off, "same_as_graphs": True}))


# Phase 20: `simulate eval` and `eval` through the port's CLI: live
# investigations side by side on the continuous-batching engine. Sized by
# measurement (H100 at 700 W): 8 scenarios at 32 layers took 162.5 s (3.67
# rows a decode forward), 4 took 141.6 s (1.54: one case runs its 20
# iterations alone), and the one-case pair took 49.8 s and 130.0 s at 8
# layers, 3.6 s and 6.5 s at 2. So 8 scenarios and the pair at 2 layers.
# The 8 scenarios at 32 layers later took up to 208.0 s, a fifth of the
# whole run, so they run at CUT_LAYERS.
EVAL_N = 8  # generated scenarios, drawn from EVAL_SEED
EVAL_SEED = 0
EVAL_CONCURRENCY = 4
EVAL_LAYERS = CUT_LAYERS  # the simulated run's depth
EVAL_FIXTURE_CASE = "payment-db-pool"  # the deterministic pair's one case
EVAL_FIXTURE_LAYERS = 2  # the pair's depth
EVAL_FIXTURES = ROOT / "examples" / "evals" / "investigation-fixtures.sample.json"


def eval_config(tmp: Path) -> Path:
    """The phase's ``config.yaml``: the 8B from seed 0 in bf16 on the
    serving engine, byte tokenizer, 512 new tokens a call. ``run_live``
    builds each case's simulated tools from the case itself."""
    import yaml

    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump({
        "runbook_dir": str(tmp / "rb"),
        "llm": {"provider": "jax-tpu", "model": ENGINE_MODEL, "max_new_tokens": AGENT_MAX_NEW}}))
    return path


def eval_argv(kind: str, tmp: Path) -> list[str]:
    """``simulate eval`` over EVAL_N generated scenarios, EVAL_CONCURRENCY at
    a time, or ``eval`` over one case of the sample fixtures, alone."""
    if kind == "simulated":
        return ["simulate", "eval", "--n", str(EVAL_N), "--seed", str(EVAL_SEED),
                "--concurrency", str(EVAL_CONCURRENCY), "--out", str(tmp / "out")]
    raw = json.loads(EVAL_FIXTURES.read_text())
    raw["cases"] = [c for c in raw["cases"] if c["case_id"] == EVAL_FIXTURE_CASE]
    fixtures = tmp / "fixtures.json"
    fixtures.write_text(json.dumps(raw))
    return ["eval", "--fixtures", str(fixtures), "--concurrency", "1", "--name", "fixtures",
            "--out", str(tmp / "out")]


def phase_eval(torch, kind: str, layers: Optional[int], graphs: bool = True) -> dict:
    """``python -m runbookai_tpu_torch <eval_argv(kind)> --device DEVICE``
    in this process on :func:`eval_config`, as :func:`phase_agent` runs its
    commands: the client is ``TorchCudaClient.from_config``'s at ``layers``
    of the 8B's layers (None: all 32), built with phase 15's schema limits
    and ``engine={"step_graphs": graphs}``; launch counts are zeroed once it
    is built and read when the command returns; ``time.time`` is pinned.
    Each engine request is tagged with its case (a context variable set
    where ``run_live`` builds the case's tools), and each decode dispatch
    records its rows (the decoding requests: every one of its k forwards
    carries them). Fails unless the command exits 0 with no engine crash,
    every case row is ``completed``, every guided call's document parses
    under its schema (:func:`agent_document`), K1 and K2 launched, the step
    graphs replayed (graphs on) or not (off), and ``summary.json`` and the
    report (``simulated``: with its fault-family and adversarial breakdown)
    were written; ``simulated`` also fails unless decode forwards averaged
    more than one row and one carried two or more."""
    import contextlib
    import contextvars
    import dataclasses
    import io
    import tempfile
    from unittest import mock

    from runbookai_tpu_torch import __main__ as cli
    from runbookai_tpu_torch.engine.async_engine import AsyncEngine
    from runbookai_tpu_torch.evalsuite import runner
    from runbookai_tpu_torch.model.schema_guided import SchemaLimits
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama

    free_device(torch)
    built: list = []
    rows: list = []  # (decoding rows, forwards) a decode dispatch
    build = TorchCudaClient.build.__func__
    from_config = TorchCudaClient.from_config.__func__

    def counted_from_config(cls, *args, **kw):
        t0 = time.perf_counter()
        client = from_config(cls, *args, **kw)
        torch.cuda.synchronize()
        built.append((client, time.perf_counter() - t0))
        core = client.core
        decode_multi, run_spec = core._decode_multi, core._run_decode_spec

        def counted_decode(positions, ctx_lens, si, k, mask=None):
            rows.append((len(core.decoding), k))
            return decode_multi(positions, ctx_lens, si, k, mask)

        def counted_spec(drafts, k):
            rows.append((len(core.decoding), 1))  # one verify forward
            return run_spec(drafts, k)

        core._decode_multi, core._run_decode_spec = counted_decode, counted_spec
        reset_counts()
        return client

    def build_graphs(cls, *args, **kw):
        return build(cls, *args, **kw, schema_limits=SchemaLimits(**GUIDED_LIMITS),
                     engine={"step_graphs": graphs})

    case_of: dict = {}
    current = contextvars.ContextVar("eval_case", default=None)
    executor_for_case, submit = runner._executor_for_case, AsyncEngine._submit

    def tagged_executor(case):
        current.set(case.case_id)  # in the case's task: its engine calls inherit it
        return executor_for_case(case)

    def tagged_submit(self, req):
        case_of[req.request_id] = current.get()
        return submit(self, req)

    cfg = llama.get_config(ENGINE_MODEL)
    depth = {ENGINE_MODEL: dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)}
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*eval_argv(kind, Path(tmp)), "--device", DEVICE,
                "--config", str(eval_config(Path(tmp)))]
        with mock.patch.object(TorchCudaClient, "from_config",
                               classmethod(counted_from_config)), \
                mock.patch.object(TorchCudaClient, "build", classmethod(build_graphs)), \
                mock.patch.object(runner, "_executor_for_case", tagged_executor), \
                mock.patch.object(AsyncEngine, "_submit", tagged_submit), \
                mock.patch.dict(llama.CONFIGS, depth), \
                mock.patch("time.time", return_value=AGENT_NOW), \
                contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
        report_name = "simulated-incidents" if kind == "simulated" else "fixtures"
        written = {p.name: json.loads(p.read_text())
                   for p in (Path(tmp) / "out").glob("*.json")}
    launched = counts()
    (client, build_s), = built
    core = client.core
    report = json.loads(out.getvalue())
    name = f"eval_{kind}" + ("" if graphs else "_graphs_off")
    if rc != 0 or client.engine.crash_count:
        raise AssertionError(f"{name}: exit {rc}, {client.engine.crash_count} crashes")
    failed = [c for c in report["cases"] if c["status"] != "completed"]
    if failed:
        raise AssertionError(f"{name}: cases not completed: {failed}")
    if "summary.json" not in written or f"{report_name}.json" not in written:
        raise AssertionError(f"{name}: reports written: {sorted(written)}")
    if kind == "simulated" and set(written[f"{report_name}.json"].get("breakdown", {})) != {
            "fault_family", "adversarial"}:
        raise AssertionError(f"{name}: no fault-family and adversarial breakdown")
    per_case: dict = {}
    docs = []
    for i, req in enumerate(core.finished):
        guided = req.sampling.guided
        text = core.output_for(req).text
        if guided:
            agent_document(text, guided, req)
        case = per_case.setdefault(case_of.get(req.request_id), {
            "llm_calls": 0, "prompt_tokens": 0, "completion_tokens": 0, "ttft_ms": []})
        case["llm_calls"] += 1
        case["prompt_tokens"] += len(req.prompt_ids) - len(req.folded_out_ids)
        case["completion_tokens"] += req.num_generated
        case["ttft_ms"].append(req.ttft_ms)
        docs.append([case_of.get(req.request_id), guided, req.all_out_ids])
    for case in per_case.values():
        case["ttft_ms"] = percentiles(case["ttft_ms"])
    metrics = dict(core.metrics)
    if not (launched["paged_decode_attention"] and launched["paged_chunk_attention"]):
        raise AssertionError(f"{name}: K1 or K2 not launched: {launched}")
    if (metrics["graph_replays"] > 0) != graphs:
        raise AssertionError(f"{name}: step graphs {graphs}, but "
                             f"{metrics['graph_replays']} replays")
    forwards = sum(k for _, k in rows)
    mean_rows = sum(n * k for n, k in rows) / forwards if forwards else 0.0
    max_rows = max((n for n, _ in rows), default=0)
    if kind == "simulated" and not (mean_rows > 1 and max_rows >= 2):
        raise AssertionError(f"{name}: the cases did not share decode steps: "
                             f"{mean_rows} rows a forward on average, {max_rows} at most")
    guided_tokens = sum(r.num_generated for r in core.finished if r.sampling.guided)
    n_cases = len(report["cases"])
    triage = [json.loads(line) for line in err.getvalue().splitlines()
              if line.startswith("{")]
    return {"phase": name, "step_graphs": graphs, "model": ENGINE_MODEL,
            "layers": layers or cfg.n_layers, "schema_limits": GUIDED_LIMITS,
            "argv": argv[:-1], "build_s": build_s,
            "graph_capture_s": metrics["graph_capture_s"], "wall_s": wall,
            "cases": n_cases, "cases_per_min": 60 * n_cases / wall,
            "pass_rate": report["pass_rate"],
            "pass_rate_note": "random weights: pass@1 measures nothing about the model",
            "breakdown": report.get("breakdown"), "triage_baseline": triage,
            "llm_calls": len(core.finished),
            "prompt_tokens": sum(c["prompt_tokens"] for c in per_case.values()),
            "completion_tokens": sum(c["completion_tokens"] for c in per_case.values()),
            "guided_tokens": guided_tokens, "guided_tokens_per_s": guided_tokens / wall,
            "grammar_forced_tokens": metrics["grammar_forced_tokens"],
            "decode_forwards": forwards, "rows_per_decode_forward": mean_rows,
            "max_rows_per_decode_forward": max_rows, "per_case": per_case,
            "graph_replays": metrics["graph_replays"], "launches": launched,
            "engine_metrics": metrics, "report_cases": report["cases"], "documents": docs}


def eval_phases(torch) -> None:
    """``eval_simulated`` at EVAL_LAYERS, then ``eval_fixtures`` at
    EVAL_FIXTURE_LAYERS with the step graphs on and off. Only the one-case pair is
    compared: alone on the engine, its calls and their batches are
    deterministic, and the report's case rows (result, score, dimensions,
    event counts, iterations) and every call's tokens must be equal. The
    concurrent run is not compared between graphs on and off: which rows
    share a step, and so the batch each forward sees, follows the host's
    timing."""
    emit(eval_line(phase_eval(torch, "simulated", EVAL_LAYERS)))
    on = phase_eval(torch, "fixtures", EVAL_FIXTURE_LAYERS)
    emit(eval_line(on))
    off = phase_eval(torch, "fixtures", EVAL_FIXTURE_LAYERS, graphs=False)
    for key in ("report_cases", "documents"):
        if on[key] != off[key]:
            raise AssertionError(f"eval_fixtures: graphs off gave other {key}")
    emit(eval_line({**off, "same_as_graphs": True}))


def eval_line(res: dict) -> dict:
    """An eval phase's line: its token streams counted, not listed."""
    return {**{k: v for k, v in res.items() if k != "documents"},
            "documents": len(res["documents"])}


SERVE_MAX_NEW = 64  # every chat's budget (max_tokens), and the client's
SERVE_SEED = 7  # the seeded requests' seed
SERVE_EMBED_TEXTS = 32  # the concurrent /v1/embeddings request's inputs
SERVE_EMBED_TOL = 1e-6  # max |err| of a served embedding against embed_texts alone
SERVE_DROP_CHUNKS = 4  # content chunks read before the dropped stream closes
SERVE_DROP_MAX_NEW = 2048  # the dropped stream's budget: it must end by the abort
SERVE_TIMEOUT = 60  # every HTTP request's, in seconds
SERVE_ROUTES = ("/v1/chat/completions", "/v1/completions", "/v1/embeddings", "/v1/models",
                "/healthz", "/metrics", "/debug/steps")


def serve_config(tmp: Path, llm: Optional[dict] = None) -> Path:
    """The phase's ``config.yaml``: the 8B from seed 0 in bf16 on the serving
    engine's defaults (``llm``'s), byte tokenizer, 64 new tokens a call;
    ``llm`` adds or overrides keys of the ``llm`` block."""
    import yaml

    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump({"llm": {"provider": "jax-tpu", "model": ENGINE_MODEL,
                                            "max_new_tokens": SERVE_MAX_NEW, **(llm or {})}}))
    return path


def http(port: int, path: str, payload: Optional[dict] = None, rid: Optional[str] = None):
    """One request to the server on ``port``: (status, headers, body text,
    seconds to an SSE body's first chunk after the role chunk, the first
    token's piece or the finish, else None, wall)."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if rid:
        headers["x-request-id"] = rid
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers,
                                 data=None if payload is None else json.dumps(payload).encode(),
                                 method="GET" if payload is None else "POST")
    t0 = time.perf_counter()
    first = None
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as r:
            if (payload or {}).get("stream"):
                lines, chunks = [], 0
                for line in r:
                    chunks += line.startswith(b"data: ")
                    if first is None and chunks == 2:
                        first = time.perf_counter() - t0
                    lines.append(line)
                text = b"".join(lines).decode()
            else:
                text = r.read().decode()
            return r.status, dict(r.headers), text, first, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode(), None, time.perf_counter() - t0


def sse_events(text: str) -> list[dict]:
    """The JSON chunks of an SSE body, which must end with ``[DONE]``."""
    data = [line[len("data: "):] for line in text.splitlines() if line.startswith("data: ")]
    if not data or data[-1] != "[DONE]":
        raise AssertionError(f"SSE body does not end with [DONE]: {text[-200:]!r}")
    return [json.loads(d) for d in data[:-1]]


def sse_text(events: list[dict]) -> str:
    return "".join(e["choices"][0]["delta"].get("content", "") for e in events if e["choices"])


def drop_stream(port: int, payload: dict, chunks: int) -> tuple[int, Optional[float]]:
    """Open an SSE chat stream on a raw socket, read ``chunks`` content
    chunks, then close the socket mid-stream; returns the chunks read and
    the seconds to the first."""
    import socket

    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    first = None
    with socket.create_connection(("127.0.0.1", port), timeout=SERVE_TIMEOUT) as sock:
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        reader = sock.makefile("rb")
        seen = 0
        while seen < chunks:
            line = reader.readline()
            if not line or line.startswith(b"data: [DONE]"):
                break
            if line.startswith(b"data: ") and b'"content"' in line:
                seen += 1
                first = first if first is not None else time.perf_counter() - t0
        reader.close()
    return seen, first


def route_counts(port: int) -> dict:
    """``runbook_requests_total`` summed by route, from ``/metrics``."""
    import re

    _, _, text, _, _ = http(port, "/metrics")
    out: dict = {}
    for m in re.finditer(r'^runbook_requests_total\{route="([^"]*)"[^}]*\} (\S+)$', text,
                         re.M):
        out[m.group(1)] = out.get(m.group(1), 0) + float(m.group(2))
    return out


def build_serving(torch, graphs: bool = True, layers: Optional[int] = None, embedder=None,
                  llm: Optional[dict] = None, engine: Optional[dict] = None,
                  allow_adapter_loading: bool = False):
    """``serve``'s server (``__main__.build_server``, the CLI's construction)
    on :func:`serve_config` (with ``llm``'s keys) at ``layers`` of the 8B's
    layers (None: all 32), with ``engine={"step_graphs": graphs, **engine}``
    laid over its engine and ``POST /v1/adapters`` open where
    ``allow_adapter_loading`` (``serve --allow-adapter-loading``), started on
    port 0. Returns (server, plan, what the build printed, the bytes
    allocated before the build, after the weights and after the pool, the
    build's seconds)."""
    import contextlib
    import dataclasses
    import io
    import tempfile
    from unittest import mock

    from runbookai_tpu_torch import __main__ as cli
    from runbookai_tpu_torch.engine import engine as eng
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama
    from runbookai_tpu_torch.utils.config import load_config

    build = TorchCudaClient.build.__func__
    kv_manager = eng.KVCacheManager
    allocated: dict = {"before": torch.cuda.memory_allocated()}

    def build_graphs(cls, *args, **kw):
        return build(cls, *args, **kw, engine={"step_graphs": graphs, **(engine or {})})

    def measured_pool(*args, **kw):
        torch.cuda.synchronize()
        allocated["weights"] = torch.cuda.memory_allocated()
        kv = kv_manager(*args, **kw)
        torch.cuda.synchronize()
        allocated["pool"] = torch.cuda.memory_allocated()
        return kv

    cfg = llama.get_config(ENGINE_MODEL)
    depth = {ENGINE_MODEL: dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)}
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        config = load_config(path=str(serve_config(Path(tmp), llm)))
        with mock.patch.object(TorchCudaClient, "build", classmethod(build_graphs)), \
                mock.patch.object(eng, "KVCacheManager", measured_pool), \
                mock.patch.dict(llama.CONFIGS, depth), contextlib.redirect_stderr(log):
            t0 = time.perf_counter()
            server, plan = cli.build_server(config, port=0, device=DEVICE, embedder=embedder,
                                            allow_adapter_loading=allow_adapter_loading)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
    allocated["built"] = torch.cuda.memory_allocated()
    server.start_background()
    return server, plan, log.getvalue(), allocated, build_s


def seeded_draws(torch) -> dict:
    """``sample_tokens``' seeded rows on the card over a flat distribution
    (4,096 equal logits, temperature 1): seeds 7 and 8 at one position must
    draw different tokens, one seed at one position the same token twice,
    and no row may follow the engine's generator."""
    from runbookai_tpu_torch.ops.sampling import sample_tokens

    def draw(seeds, gen_seed):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(gen_seed)
        n = len(seeds)
        return sample_tokens(torch.zeros((n, 4096), device=DEVICE), gen,
                             torch.ones((n,), device=DEVICE), torch.ones((n,), device=DEVICE),
                             seeds=torch.tensor(seeds, device=DEVICE),
                             positions=torch.full((n,), 5, device=DEVICE)).tolist()

    a, b = draw([SERVE_SEED, SERVE_SEED + 1, SERVE_SEED], 0), draw([SERVE_SEED] * 3, 1)
    if a[0] == a[1] or a[0] != a[2] or b != [a[0]] * 3:
        raise AssertionError(f"serve: seeded draws {a} and {b}")
    return {"seeds": [SERVE_SEED, SERVE_SEED + 1], "tokens": a[:2]}


def fresh_backoff(client) -> None:
    """Wait until the engine is idle, then clear speculation's backoff, the
    one piece of engine state that one request leaves to the next and that
    picks a dispatch (a verify or a greedy loop): a request then takes the
    dispatches it would take first on a fresh engine."""
    settle(client)
    with client.engine._lock:
        client.core._spec_backoff = client.core._spec_miss_streak = 0


def settle(client) -> None:
    """Wait until the engine has no work left (every request finished, no
    window in flight)."""
    deadline = time.perf_counter() + SERVE_TIMEOUT
    while True:
        with client.engine._lock:
            if not client.core.has_work:
                return
        if time.perf_counter() > deadline:
            raise AssertionError("serve: the engine did not settle")
        time.sleep(0.01)


def chat_payload(prompt: str, **kw) -> dict:
    return {"messages": [{"role": "user", "content": prompt}], "max_tokens": SERVE_MAX_NEW,
            **kw}


def served_requests(core, rid: str) -> list:
    """The engine requests that carried x-request-id ``rid``."""
    return [r for r in core.finished if r.trace_id == rid]


def check_usage(core, rid: str, usage: dict, n_prompts: int = 1) -> None:
    """``usage`` must count the tokens the engine served for ``rid``: the
    prompt once a prompt (a chat's n choices share one) and every generated
    token."""
    reqs = served_requests(core, rid)
    prompts = {tuple(r.prompt_ids[:len(r.prompt_ids) - len(r.folded_out_ids)]) for r in reqs}
    want = {"prompt_tokens": sum(len(p) for p in prompts),
            "completion_tokens": sum(r.num_generated for r in reqs)}
    want["total_tokens"] = want["prompt_tokens"] + want["completion_tokens"]
    if not reqs or len(prompts) != n_prompts or any(usage[k] != v for k, v in want.items()):
        raise AssertionError(f"serve {rid}: usage {usage}, served {want}")


def phase_serve(torch) -> dict:
    """``serve`` at full depth (:func:`build_serving`) with phase 19's random
    bge-base as the embedder. First the solo greedy chat: non-streaming,
    streaming and ``client.chat`` in this process must give the same text.
    Then the concurrent load: eight client threads (four greedy chats, two
    streams with ``include_usage``, an ``n = 2`` seeded sample, a
    ``json_object`` chat; prompts()'s prompts, 64 new tokens each) beside
    one ``/v1/embeddings`` request of 32 texts. Then a legacy completion
    with ``logprobs: 5`` and a stream the client drops after four chunks.
    Fails unless every response is a 200 with a valid ``finish_reason`` and
    ``usage`` equal to the tokens the engine served for its x-request-id
    (which must be echoed), the JSON parses, the n choices drew from
    distinct seeds and tokens, the
    embeddings are within SERVE_EMBED_TOL of ``embed_texts`` alone, the
    dropped stream's request is aborted and the pages return, ``/metrics``
    counts each route's requests, ``/debug/steps`` holds one record a step,
    K1 and K2 launched under the load, the graphs replayed, and the load's
    decode forwards averaged more than one row."""
    import math
    import threading

    import numpy as np

    from runbookai_tpu_torch.model.chat_template import parse_assistant_output

    from runbookai_tpu_torch.knowledge.embedder import Embedder

    free_device(torch)
    emb = Embedder(model_name=KNOWLEDGE_MODEL, device=DEVICE)  # random, from seed 0
    texts = knowledge_queries(SERVE_EMBED_TEXTS)
    server, plan, printed, allocated, build_s = build_serving(torch, embedder=emb)
    client, core, port = server.client, server.client.core, server.port
    try:
        if core._use_graphs and core._graphs is None:
            raise AssertionError("serve: step graphs not captured before the server started")
        rows: list = []  # (decoding rows, forwards) a decode dispatch
        steps = [0]
        decode_multi, run_spec, step = core._decode_multi, core._run_decode_spec, core.step

        def counted_decode(positions, ctx_lens, si, k, mask=None):
            rows.append((len(core.decoding), k))
            return decode_multi(positions, ctx_lens, si, k, mask)

        def counted_spec(drafts, k):
            rows.append((len(core.decoding), 1))
            return run_spec(drafts, k)

        def counted_step():
            steps[0] += 1
            return step()

        core._decode_multi, core._run_decode_spec, core.step = (counted_decode, counted_spec,
                                                                counted_step)
        routes_before = route_counts(port)
        sent: dict = {}

        def send(path, payload=None, rid=None):
            sent[path] = sent.get(path, 0) + 1
            res = http(port, path, payload, rid)
            if rid and res[1].get("x-request-id") != rid:
                raise AssertionError(f"serve {rid}: x-request-id not echoed: {res[1]}")
            return res

        user = prompts()
        pressure0 = json.loads(send("/healthz")[2])["kv"]
        # The solo greedy chat: non-streaming, streaming and client.chat in
        # this process give the same text and tokens. A first request of the
        # same prompt publishes its full pages, so that all three reuse the
        # same cached prefix and prefill the same tail: a cold prefill in one
        # chunk rounds bf16 otherwise than a cached prefix and a short tail,
        # and the random weights' near-tied logits then pick other tokens.
        # Each of the three starts from a fresh speculation backoff.
        solo = chat_payload(user[2])
        send("/v1/chat/completions", {**solo, "max_tokens": 1}, rid="solo-warm")
        fresh_backoff(client)
        st, _, body, _, solo_http_s = send("/v1/chat/completions", solo, rid="solo")
        solo_text = json.loads(body)["choices"][0]["message"]["content"]
        fresh_backoff(client)
        st2, _, body2, solo_ttft, solo_stream_s = send(
            "/v1/chat/completions", {**solo, "stream": True}, rid="solo-stream")
        fresh_backoff(client)
        t0 = time.perf_counter()
        inproc = server.bridge.run(client.chat("", user[2]), timeout=SERVE_TIMEOUT)
        solo_inproc_s = time.perf_counter() - t0
        # Token for token too: most of the 8B's random-weight ids lie past the
        # byte tokenizer's, which decodes them to nothing.
        solo_reqs = [served_requests(core, rid)[0] for rid in ("solo", "solo-stream")]
        solo_reqs.append(core.finished[-1])
        solo_ids = [r.all_out_ids for r in solo_reqs]
        if len({r.cached_tokens for r in solo_reqs}) != 1:
            raise AssertionError(f"serve: the solo requests reused "
                                 f"{[r.cached_tokens for r in solo_reqs]} cached tokens")
        if (st, st2) != (200, 200) or sse_text(sse_events(body2)) != solo_text \
                or inproc.content != parse_assistant_output(solo_text)[0] \
                or solo_ids[1:] != solo_ids[:-1]:
            raise AssertionError(f"serve: the solo greedy chat differs between JSON, SSE "
                                 f"and client.chat: tokens part at "
                                 f"{first_divergence([solo_ids[0]], [solo_ids[1]])} and "
                                 f"{first_divergence([solo_ids[0]], [solo_ids[2]])}")
        settle(client)
        with client.engine._lock:  # no step is half done under the step lock
            reset_counts()
            steps[0], rows[:] = 0, []
            steps_before = core.flight.total_steps
        # The concurrent load: eight client threads and one embeddings request.
        jobs = [(f"greedy-{i}", "/v1/chat/completions", chat_payload(user[i]))
                for i in range(4)]
        jobs += [(f"stream-{i}", "/v1/chat/completions", chat_payload(
            user[4 - i], stream=True, stream_options={"include_usage": True}))
            for i in range(2)]
        jobs += [("sample-n2", "/v1/chat/completions", chat_payload(
            user[3], n=2, temperature=0.8, top_p=0.95, seed=SERVE_SEED)),
                 ("json", "/v1/chat/completions", chat_payload(
                     user[1], response_format={"type": "json_object"})),
                 ("embed", "/v1/embeddings", {"input": texts})]
        results: dict = {}
        barrier = threading.Barrier(len(jobs))

        def run(rid, path, payload):
            barrier.wait()
            try:
                results[rid] = send(path, payload, rid=rid)
            except Exception as e:  # noqa: BLE001 — raised in the main thread below
                results[rid] = e

        threads = [threading.Thread(target=run, args=job) for job in jobs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT)
            if t.is_alive():
                raise AssertionError("serve: a client thread did not finish")
        load_s = time.perf_counter() - t0
        load_launches = counts()
        load_steps = steps[0]
        load_rows = list(rows)
        completion_tokens = 0
        http_ttft = []
        finishes = {}
        failed = {rid: repr(r) for rid, r in results.items() if isinstance(r, Exception)}
        if failed:
            raise AssertionError(f"serve: client requests failed: {failed}")
        for rid, path, payload in jobs:
            status, _, text, first, _ = results[rid]
            if status != 200:
                raise AssertionError(f"serve {rid}: status {status}: {text[:300]}")
            if rid == "embed":
                continue
            if payload.get("stream"):
                events = sse_events(text)
                usage = events[-1]["usage"]
                finish = [e["choices"][0]["finish_reason"] for e in events if e["choices"]][-1]
                reasons = [finish]
                http_ttft.append(first)
            else:
                out = json.loads(text)
                usage = out["usage"]
                reasons = [c["finish_reason"] for c in out["choices"]]
                if rid == "json":
                    json.loads(out["choices"][0]["message"]["content"])
                if rid == "sample-n2":
                    seeds = sorted(r.sampling.seed for r in served_requests(core, rid))
                    if seeds != [SERVE_SEED, SERVE_SEED + 1]:
                        raise AssertionError(f"serve: the n = 2 choices drew from seeds "
                                             f"{seeds}")
                    if len({tuple(r.all_out_ids) for r in served_requests(core, rid)}) != 2:
                        raise AssertionError("serve: the n = 2 seeded choices drew the same "
                                             "tokens")
            if not set(reasons) <= {"stop", "length"}:
                raise AssertionError(f"serve {rid}: finish_reason {reasons}")
            check_usage(core, rid, usage)
            completion_tokens += usage["completion_tokens"]
            finishes[rid] = reasons
        served = json.loads(results["embed"][2])
        emb._cache.clear()  # embed_texts alone, not from the served call's cache
        alone = emb.embed_texts(texts)
        got = np.array([d["embedding"] for d in served["data"]], dtype=np.float32)
        embed_err = float(np.abs(got - alone).max())
        if got.shape != alone.shape or embed_err > SERVE_EMBED_TOL:
            raise AssertionError(f"serve: embeddings {got.shape} differ from embed_texts "
                                 f"alone by {embed_err:.3e} (tol {SERVE_EMBED_TOL})")
        # The legacy completion with logprobs 5.
        st, _, body, _, _ = send("/v1/completions", {"prompt": user[0], "logprobs": 5,
                                                      "max_tokens": SERVE_MAX_NEW},
                                 rid="legacy")
        legacy = json.loads(body)
        lp = legacy["choices"][0]["logprobs"]
        if st != 200 or not lp["tokens"] or any(
                not (math.isfinite(x) and x <= 0) for x in lp["token_logprobs"]) or any(
                len(t) > 5 for t in lp["top_logprobs"]):
            raise AssertionError(f"serve: legacy logprobs {str(lp)[:300]}")
        check_usage(core, "legacy", legacy["usage"])
        # The stream the client drops after four chunks: the engine aborts
        # it and its pages return.
        # A forced token keeps the stream from stopping before the drop.
        drop = chat_payload(user[4], stream=True, max_tokens=SERVE_DROP_MAX_NEW,
                            logit_bias={str(BIAS_BYTE): 100})
        seen, drop_ttft = drop_stream(port, drop, SERVE_DROP_CHUNKS)
        if seen != SERVE_DROP_CHUNKS:
            raise AssertionError("serve: the dropped stream sent fewer chunks")
        sent["/v1/chat/completions"] += 1
        settle(client)
        dropped = core.finished[-1]
        pressure = json.loads(send("/healthz")[2])["kv"]
        if dropped.finish_reason.value != "aborted" or core.has_work or core.kv.seqs \
                or dropped.num_generated >= SERVE_DROP_MAX_NEW \
                or pressure["pages_in_use"] != pressure0["pages_in_use"]:
            raise AssertionError(f"serve: after the drop: {dropped.finish_reason}, "
                                 f"{pressure} against {pressure0}")
        # /debug/steps holds one record a step; /metrics counts each route.
        send("/v1/models")
        debug = json.loads(send("/debug/steps", None)[2])
        with client.engine._lock:
            recorded = core.flight.total_steps - steps_before
            if recorded != steps[0] or debug["steps_total"] != core.flight.total_steps:
                raise AssertionError(f"serve: {steps[0]} steps, {recorded} records, "
                                     f"{debug['steps_total']} on /debug/steps")
        send("/metrics")
        routes = route_counts(port)
        missing = {r: (routes.get(r, 0) - routes_before.get(r, 0), n)
                   for r, n in sent.items() if routes.get(r, 0) - routes_before.get(r, 0) < n
                   and r != "/metrics"}
        if missing or not set(SERVE_ROUTES) <= set(routes):
            raise AssertionError(f"serve: /metrics counts {missing}, routes {sorted(routes)}")
        metrics = dict(core.metrics)
    finally:
        server.shutdown()
    if not (load_launches["paged_decode_attention"] and load_launches["paged_chunk_attention"]):
        raise AssertionError(f"serve: K1 or K2 not launched under load: {load_launches}")
    if core._use_graphs and metrics["graph_replays"] == 0:
        raise AssertionError("serve: no step graph replayed")
    forwards = sum(k for _, k in load_rows)
    mean_rows = sum(n * k for n, k in load_rows) / forwards if forwards else 0.0
    if not mean_rows > 1:
        raise AssertionError(f"serve: {mean_rows} rows a decode forward under load")
    engine_ttft = [r.ttft_ms for r in core.finished if r.trace_id in dict.fromkeys(
        rid for rid, _, _ in jobs) and r.ttft_ms is not None]
    return {"phase": "serve", "model": ENGINE_MODEL, "device": str(core.device),
            "argv": ["serve", "--port", "0", "--device", DEVICE],
            "engine": {k: getattr(core.ecfg, k) for k in (
                "page_size", "num_pages", "max_batch_slots", "prefill_chunk",
                "decode_steps_per_dispatch", "prefill_batch", "flight_recorder_steps")},
            "step_graphs": core._use_graphs, "build_s": build_s,
            "graph_capture_s": metrics["graph_capture_s"], "build_printed": printed,
            "embedder": KNOWLEDGE_MODEL, "embed_texts": len(texts),
            "embed_max_abs_err": embed_err,
            "memory": {"plan_weight_bytes": plan.weight_bytes_per_chip if plan else None,
                       "plan_pool_budget_bytes": plan.pool_budget_bytes if plan else None,
                       "plan_kv_bytes_per_token": plan.kv_bytes_per_token_per_chip
                       if plan else None,
                       "hbm_bytes": plan.hbm_bytes if plan else None,
                       "pool_bytes": core.kv.pool.nbytes(),
                       "allocated_before": allocated["before"],
                       "allocated_weights": allocated["weights"] - allocated["before"],
                       "allocated_pool": allocated["pool"] - allocated["weights"],
                       "allocated_built": allocated["built"] - allocated["before"]},
            "load_requests": len(jobs), "load_wall_s": load_s,
            "load_completion_tokens": completion_tokens,
            "load_completion_tokens_per_s": completion_tokens / load_s,
            "http_ttft_s": percentiles(http_ttft) if http_ttft else None,
            "engine_ttft_ms": percentiles(engine_ttft) if engine_ttft else None,
            "load_steps": load_steps, "decode_forwards": forwards,
            "rows_per_decode_forward": mean_rows,
            "max_rows_per_decode_forward": max(n for n, _ in load_rows),
            "finish_reasons": finishes, "load_launches": load_launches,
            "seeded_draws": seeded_draws(torch),
            "legacy_logprob_mean": sum(lp["token_logprobs"]) / len(lp["token_logprobs"]),
            "solo": {"http_s": solo_http_s, "stream_s": solo_stream_s,
                     "stream_ttft_s": solo_ttft, "in_process_s": solo_inproc_s,
                     "completion_tokens": inproc.usage["completion_tokens"],
                     "text_chars": len(solo_text),
                     "cached_tokens": solo_reqs[0].cached_tokens,
                     "ids_in_tokenizer": sum(t < client.tokenizer.vocab_size
                                             for t in solo_ids[0]),
                     "in_process_ttft_ms": inproc.usage["ttft_ms"]},
            "dropped_stream": {"generated": dropped.num_generated,
                               "http_ttft_s": drop_ttft,
                               "pressure_before": pressure0, "pressure_after": pressure},
            "routes": {r: routes.get(r, 0) - routes_before.get(r, 0) for r in SERVE_ROUTES},
            "debug_steps_total": debug["steps_total"], "graph_replays": metrics["graph_replays"],
            "engine_metrics": metrics, "layers": core.cfg.n_layers}


def solo_requests() -> dict:
    """The solo requests held equal with the step graphs on and off: greedy
    (JSON and SSE), a seeded temperature sample, penalties with
    ``logit_bias``, and logprobs."""
    user = prompts()
    return {"greedy": chat_payload(user[1]),
            "greedy_stream": chat_payload(user[1], stream=True),
            "seeded": chat_payload(user[2], temperature=0.8, top_p=0.95, seed=SERVE_SEED),
            "penalties_bias": chat_payload(user[3], presence_penalty=0.5,
                                           frequency_penalty=0.8,
                                           logit_bias={str(BIAS_BYTE): 4.0, "32": -100}),
            "logprobs": chat_payload(user[0], logprobs=True, top_logprobs=3)}


def without_ids(body):
    """(``body`` without ``id``/``created`` and with every logprob number
    set aside, those numbers in order)."""
    nums: list = []

    def walk(x, inside=False):
        if isinstance(x, dict):
            return {k: walk(v, inside or k in ("logprob", "top_logprobs"))
                    for k, v in x.items() if k not in ("id", "created")}
        if isinstance(x, list):
            return [walk(v, inside) for v in x]
        if isinstance(x, float) and inside:
            nums.append(x)
            return None
        return x

    return walk(body), nums


def phase_serve_graphs(torch) -> dict:
    """:func:`solo_requests` through ``serve`` at CUT_LAYERS of the 8B's
    layers, once with the step graphs on and once off: the bodies (SSE: the
    chunk sequences) must be equal apart from ``id`` and ``created``, the
    engine's tokens for each request equal (most random-weight ids decode to
    no text), and the logprobs within LOGPROB_TOL. The temperature, penalty and bias batches
    replay the T = 1 graph k times; the seeded rows draw on the host."""
    bodies: dict = {}
    numbers: dict = {}
    replays: dict = {}
    for graphs in (True, False):
        free_device(torch)
        server, _, _, _, _ = build_serving(torch, graphs=graphs, layers=CUT_LAYERS)
        try:
            reset_counts()
            for name, payload in solo_requests().items():
                status, _, text, _, _ = http(server.port, "/v1/chat/completions", payload,
                                             rid=name)
                if status != 200:
                    raise AssertionError(f"serve_graphs {name}: status {status}: {text[:200]}")
                body = sse_events(text) if payload.get("stream") else json.loads(text)
                bodies[graphs, name], numbers[graphs, name] = without_ids(body)
            launched = counts()
            core = server.client.core
            replays[graphs] = core.metrics["graph_replays"]
            for name in solo_requests():
                bodies[graphs, name + ":ids"] = [r.all_out_ids for r in core.finished
                                                 if r.trace_id == name]
        finally:
            server.shutdown()
        if not (launched["paged_decode_attention"] and launched["paged_chunk_attention"]):
            raise AssertionError(f"serve_graphs: K1 or K2 not launched: {launched}")
    if (replays[True] > 0, replays[False]) != (True, 0):
        raise AssertionError(f"serve_graphs: replays {replays}")
    worst = 0.0
    for name in solo_requests():
        if bodies[True, name] != bodies[False, name] \
                or bodies[True, name + ":ids"] != bodies[False, name + ":ids"]:
            raise AssertionError(f"serve_graphs {name}: graphs off gave another body or "
                                 f"other tokens")
        for a, b in zip(numbers[True, name], numbers[False, name], strict=True):
            worst = max(worst, abs(a - b))
    if worst > LOGPROB_TOL:
        raise AssertionError(f"serve_graphs: logprobs differ by {worst:.3e}")
    # Each entry's numbers: the sampled token's logprob, then its top 3.
    chosen = numbers[True, "logprobs"][::4]
    return {"phase": "serve_graphs", "model": ENGINE_MODEL, "layers": CUT_LAYERS,
            "greedy_logprob_mean": sum(chosen) / len(chosen),
            "requests": sorted(solo_requests()), "same_bodies": True,
            "logprob_max_abs_diff": worst, "graph_replays": replays[True],
            "completion_tokens": {name: body["usage"]["completion_tokens"]
                                  for (on, name), body in bodies.items()
                                  if on and isinstance(body, dict)},
            "same_tokens": True}


def serve_phases(torch) -> None:
    """``serve`` at full depth under concurrent load, then its solo requests
    with the step graphs on and off at CUT_LAYERS."""
    emit(phase_serve(torch))
    emit(phase_serve_graphs(torch))


LORA_LAYERS = 8  # phase 18's depth
LORA_RANK = 8
LORA_ALPHA = 16.0  # alpha / r = 2, folded into B
LORA_MODULES = ("q_proj", "v_proj")  # the registry's targets wq and wv
LORA_NAMES = ("sre-a", "sre-b", "sre-c")  # loaded at build through llm.lora_adapters
LORA_HOT = "sre-hot"  # loaded over HTTP while serving
# 15 bytes: under one 16-token page, so no request reuses another's cached
# prefix (a cached prefix and a short tail round bf16 otherwise than one
# cold chunk).
LORA_PROMPT = "why 5xx on api?"
LORA_MAX_NEW = 48
# Speculation off (its verify and the greedy loop round bf16 differently, and
# the batch decides which one runs) and one prefill row a dispatch (a 4-row
# chunk's products round otherwise than one row's): each row's stream is
# then a function of its own prompt and adapter, as the check needs.
LORA_ENGINE = {"speculative": False, "prefill_batch": 1}
LORA_FORWARD_REPLAYS = 20
DRAFT_MODEL = "llama3.2-1b-instruct"  # vocab 128,256, dim 2048, 32/8 heads, head_dim 64
DRAFT_LAYERS = 8  # the target's depth; the draft runs all 16 of its layers
DRAFT_MAX_NEW = 64
SELF_DRAFT_LAYERS = 2
SELF_DRAFT_PROMPTS = ("restart the api", "checkout slow?")  # each under one page


def write_peft(path: Path, seed: int, layers: int) -> Path:
    """An HF PEFT adapter directory for the 8B (rank LORA_RANK over q_proj
    and v_proj, ``lora_alpha`` LORA_ALPHA), random from ``seed``, written in
    the safetensors layout (an 8-byte little-endian header length, the JSON
    header, then the raw float32 tensors). A scales as a Kaiming init over
    the 4,096 inputs, B so that the delta is about half a projection's."""
    import struct

    import numpy as np

    from runbookai_tpu_torch.models.llama import get_config

    cfg = get_config(ENGINE_MODEL)
    outs = {"q_proj": cfg.n_heads * cfg.head_dim, "v_proj": cfg.n_kv_heads * cfg.head_dim}
    rng = np.random.default_rng(seed)
    header, blobs, off = {}, [], 0
    for i in range(layers):
        for proj in LORA_MODULES:
            base = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            for name, shape, std in (("lora_A", (LORA_RANK, cfg.dim), cfg.dim ** -0.5),
                                     ("lora_B", (outs[proj], LORA_RANK), 0.125)):
                blob = (rng.standard_normal(shape) * std).astype("<f4").tobytes()
                header[f"{base}.{name}.weight"] = {"dtype": "F32", "shape": list(shape),
                                                   "data_offsets": [off, off + len(blob)]}
                blobs.append(blob)
                off += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.mkdir(parents=True, exist_ok=True)
    (path / "adapter_model.safetensors").write_bytes(
        struct.pack("<Q", len(head)) + head + b"".join(blobs))
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": LORA_RANK, "lora_alpha": LORA_ALPHA, "target_modules": list(LORA_MODULES)}))
    return path


def greedy_in_thread(client, adapters, prompt_ids: list, max_new: int) -> list:
    """One request per entry of ``adapters`` (None: the base model), all
    submitted together and stepped to the end in this thread under the step
    lock, from a fresh speculation backoff; returns the requests."""
    from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams

    core = client.core
    fresh_backoff(client)
    with client.engine._lock:
        reqs = [EngineRequest(prompt_ids=list(prompt_ids),
                              sampling=SamplingParams(max_new_tokens=max_new, stop_token_ids=()),
                              adapter=a) for a in adapters]
        for r in reqs:
            core.submit(r)
        core.run_until_idle()
    if any(r.finish_reason is None or r.finish_reason.value == "aborted" for r in reqs):
        raise AssertionError(f"requests aborted: "
                             f"{[(r.finish_reason, r.num_generated) for r in reqs]}")
    return reqs


def decode_rows(core) -> list:
    """Record the rows of every decode dispatch of ``core`` (a k-step loop or
    a verify) into the returned list, as (rows, kind)."""
    rows: list = []
    decode_multi, run_spec = core._decode_multi, core._run_decode_spec

    def counted_decode(positions, ctx_lens, si, k, mask=None):
        rows.append((len(core.decoding), "loop"))
        return decode_multi(positions, ctx_lens, si, k, mask)

    def counted_spec(drafts, k):
        rows.append((len(core.decoding), "verify"))
        return run_spec(drafts, k)

    core._decode_multi, core._run_decode_spec = counted_decode, counted_spec
    return rows


def forward_replay_ms(torch, core) -> float:
    """Device ms of one decode forward: the ("forward", 1) step graph
    replayed LORA_FORWARD_REPLAYS times back to back over the inputs it last
    read (the batch's last decode step; it rewrites the same K/V), timed with
    CUDA events. Launches of this timing are not counted."""
    graph = core._graphs[("forward", 1)].graph
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LORA_FORWARD_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LORA_FORWARD_REPLAYS


def phase_lora(torch, tmp: Path) -> dict:
    """Multi-LoRA serving (``models/lora.py``) on the 8B at full width and
    LORA_LAYERS of its 32 layers, bf16, built by ``serve``'s construction
    from ``llm.lora_adapters`` (three random PEFT directories written here,
    rank 8 over wq and wv) with ``--allow-adapter-loading``. One batch of the
    base model and the three adapters on one prompt: each row must equal its
    solo stream and every adapter change the stream; graphs on must equal
    graphs off, and the base row the engine without a registry. A fourth
    adapter loads over ``POST /v1/adapters``: the step graphs are captured
    again (their seconds reported), ``/v1/models`` lists it, the next
    request naming it serves with its row, and a batch of all five rows
    equals the solo streams of before the load. Reports one decode forward's
    device ms with adapters and without (the same batch, graph replays)."""
    from runbookai_tpu_torch.utils.tokens import ByteTokenizer

    dirs = {name: write_peft(tmp / name, seed, LORA_LAYERS)
            for seed, name in enumerate((*LORA_NAMES, LORA_HOT))}
    llm = {"lora_rank": LORA_RANK, "lora_targets": ["wq", "wv"],
           "lora_adapters": {name: str(dirs[name]) for name in LORA_NAMES}}
    ids = ByteTokenizer().encode(LORA_PROMPT)
    rows = (None, *LORA_NAMES)
    out: dict = {"phase": "lora_draft", "model": ENGINE_MODEL, "layers": LORA_LAYERS,
                 "rank": LORA_RANK, "targets": ["wq", "wv"], "prompt_tokens": len(ids),
                 "max_new_tokens": LORA_MAX_NEW, "engine": LORA_ENGINE}

    free_device(torch)
    server, _, _, _, build_s = build_serving(torch, layers=LORA_LAYERS, llm=llm,
                                             engine=LORA_ENGINE, allow_adapter_loading=True)
    core, port = server.client.core, server.port
    try:
        if core.lora is None or core.lora.names != sorted(LORA_NAMES) or core._graphs is None:
            raise AssertionError(f"lora: registry {core.lora and core.lora.names}, graphs "
                                 f"{core._graphs is not None}")
        dispatch_rows = decode_rows(core)
        batch = [r.all_out_ids for r in greedy_in_thread(server.client, rows, ids, LORA_MAX_NEW)]
        out["decode_ms_with_adapters"] = forward_replay_ms(torch, core)
        out["max_rows_per_decode_forward"] = max(n for n, _ in dispatch_rows)
        solo = [greedy_in_thread(server.client, [a], ids, LORA_MAX_NEW)[0].all_out_ids
                for a in rows]
        if batch != solo:
            raise AssertionError(f"lora: batch rows differ from their solo streams at "
                                 f"{first_divergence(batch, solo)}")
        if len({tuple(s) for s in batch}) != len(rows):
            raise AssertionError("lora: an adapter left the base stream unchanged")
        # The hot load over HTTP: a fifth row, every bucket captured again.
        captures, capture_s = core.metrics["graph_captures"], core.metrics["graph_capture_s"]
        status, _, body, _, load_s = http(port, "/v1/adapters",
                                          {"name": LORA_HOT, "path": str(dirs[LORA_HOT])})
        if status != 200 or json.loads(body)["adapters"] != sorted((*LORA_NAMES, LORA_HOT)):
            raise AssertionError(f"lora: hot load: {status} {body[:300]}")
        recaptured = core.metrics["graph_captures"] - captures
        if recaptured != len(core._graphs.buckets) or core._lora_rows() != len(rows) + 1:
            raise AssertionError(f"lora: {recaptured} buckets captured again, "
                                 f"{core._lora_rows()} adapter rows")
        listed = [m["id"] for m in json.loads(http(port, "/v1/models")[2])["data"]]
        if listed != [ENGINE_MODEL, *sorted((*LORA_NAMES, LORA_HOT))]:
            raise AssertionError(f"lora: /v1/models lists {listed}")
        status, _, body, _, hot_s = http(port, "/v1/chat/completions", chat_payload(
            LORA_PROMPT, model=LORA_HOT, max_tokens=LORA_MAX_NEW), rid="hot")
        hot_req = served_requests(core, "hot")
        if status != 200 or json.loads(body)["model"] != LORA_HOT or len(hot_req) != 1 \
                or hot_req[0].adapter_idx != len(rows):
            raise AssertionError(f"lora: the hot adapter's request: {status} {body[:300]}")
        hot_solo = greedy_in_thread(server.client, [LORA_HOT], ids, LORA_MAX_NEW)[0].all_out_ids
        after = [r.all_out_ids for r in greedy_in_thread(server.client, (*rows, LORA_HOT), ids,
                                                      LORA_MAX_NEW)]
        if after != solo + [hot_solo] or hot_solo in solo:
            raise AssertionError(f"lora: after the hot load the batch parts from the solo "
                                 f"streams at {first_divergence(after, solo + [hot_solo])}")
        out.update(build_s=build_s, graph_capture_s=capture_s,
                   buckets=len(core._graphs.buckets), recaptured_buckets=recaptured,
                   recapture_s=core.metrics["graph_capture_s"] - capture_s,
                   hot_load_http_s=load_s, hot_request_http_s=hot_s,
                   hot_request_tokens=hot_req[0].num_generated,
                   graph_replays=core.metrics["graph_replays"])
    finally:
        server.shutdown()
    # Graphs off: the same batch, the same streams.
    free_device(torch)
    server, _, _, _, _ = build_serving(torch, graphs=False, layers=LORA_LAYERS, llm=llm,
                                       engine=LORA_ENGINE)
    try:
        off = [r.all_out_ids for r in greedy_in_thread(server.client, rows, ids, LORA_MAX_NEW)]
        off_replays = server.client.core.metrics["graph_replays"]
    finally:
        server.shutdown()
    if off != batch or off_replays:
        raise AssertionError(f"lora: graphs off parts from graphs on at "
                             f"{first_divergence(off, batch)} ({off_replays} replays)")
    # No registry: the base stream, and the same batch's decode forward.
    free_device(torch)
    server, _, _, _, _ = build_serving(torch, layers=LORA_LAYERS, engine=LORA_ENGINE)
    try:
        plain = [r.all_out_ids for r in greedy_in_thread(server.client, [None] * len(rows), ids,
                                                      LORA_MAX_NEW)]
        out["decode_ms_without_registry"] = forward_replay_ms(torch, server.client.core)
    finally:
        server.shutdown()
    if plain != [batch[0]] * len(rows):
        raise AssertionError(f"lora: the base rows part from the engine without a registry "
                             f"at {first_divergence(plain, [batch[0]] * len(rows))}")
    out.update(same_as_solo=True, same_graphs_off=True, base_same_as_no_registry=True,
               tokens=[len(s) for s in batch],
               tokens_in_tokenizer=[sum(t < ByteTokenizer().vocab_size for t in s)
                                    for s in batch])
    return out


def spec_run(torch, server, prompt_ids: list[list[int]], max_new: int, mode: str,
             rows: list) -> dict:
    """``prompt_ids``' requests stepped together in this thread with
    speculation by the draft model (``draft``), by prompt lookup alone
    (``lookup``: the worker set aside) or off (``off``): their tokens, the
    wall, and the deltas of the engine's speculation and draft counters."""
    from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams

    client, core = server.client, server.client.core
    worker = core.draft
    keys = ("spec_drafted", "spec_accepted", "decode_tokens", "decode_steps",
            "decode_dispatches", "draft_tokens", "draft_sync_tokens", "draft_time_s",
            "draft_lookup_rows")
    fresh_backoff(client)
    with client.engine._lock:
        core.ecfg.speculative = mode != "off"
        core.draft = worker if mode == "draft" else None
        before = {k: core.metrics.get(k, 0) for k in keys}
        rows.clear()
        reqs = [EngineRequest(prompt_ids=list(p),
                              sampling=SamplingParams(max_new_tokens=max_new, stop_token_ids=()))
                for p in prompt_ids]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            core.submit(r)
        core.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        core.ecfg.speculative, core.draft = True, worker
    delta = {k: core.metrics.get(k, 0) - before[k] for k in keys}
    verifies = [n for n, kind in rows if kind == "verify"]
    return {"tokens": [r.all_out_ids for r in reqs], "wall_s": wall,
            "generated": sum(r.num_generated for r in reqs),
            "tokens_per_s": sum(r.num_generated for r in reqs) / wall, **delta,
            "acceptance": (delta["spec_accepted"] / delta["spec_drafted"]
                           if delta["spec_drafted"] else None),
            "verify_forwards": len(verifies),
            "rows_per_verify_forward": sum(verifies) / len(verifies) if verifies else None}


def phase_draft(torch) -> dict:
    """Draft-model speculation (``engine/draft.py``). DRAFT_MODEL (random
    weights from seed 0, bf16, all 16 layers) drafts for the 8B at full width
    and DRAFT_LAYERS of its 32 layers, built by ``serve``'s construction from
    ``llm.draft_model``, the serving engine's defaults with step graphs on
    (the worker's sync and draft programs captured beside the engine's):
    prompts()'s first four requests together, DRAFT_MAX_NEW new tokens each,
    with the draft model, with prompt lookup alone and with speculation
    off; the draft's own dispatches must launch K1 and K2 (head_dim 64,
    group 4). Random weights disagree, so acceptance is near 0 and the
    streams are not compared (bf16 verify and loop round apart on near-tied
    logits). Then a self-draft in float32 at SELF_DRAFT_LAYERS layers (the
    draft is the 8B itself, from the same seed): each solo request's stream
    with the draft must equal speculation off."""
    from runbookai_tpu_torch.model.chat_template import build_chat_prompt
    from runbookai_tpu_torch.utils.tokens import ByteTokenizer

    tok = ByteTokenizer()
    free_device(torch)
    server, _, _, _, build_s = build_serving(torch, layers=DRAFT_LAYERS,
                                             llm={"draft_model": DRAFT_MODEL})
    core = server.client.core
    worker = core.draft
    try:
        if worker is None or worker.cfg.name != DRAFT_MODEL or worker._graphs is None:
            raise AssertionError("draft: no captured draft worker")
        out: dict = {"phase": "lora_draft_speculation", "model": ENGINE_MODEL,
                     "layers": DRAFT_LAYERS, "draft_model": DRAFT_MODEL,
                     "draft_layers": worker.cfg.n_layers, "draft_head_dim": worker.cfg.head_dim,
                     "max_new_tokens": DRAFT_MAX_NEW, "build_s": build_s,
                     "draft_buckets": sorted(str(k) for k in worker._graphs.buckets)}
        dispatch = worker._dispatch
        draft_launches: dict = {}

        def counted_dispatch(key, body, inputs):
            before = counts()
            res = dispatch(key, body, inputs)
            for name, n in counts().items():
                if n - before.get(name, 0):
                    draft_launches[name] = draft_launches.get(name, 0) + n - before.get(name, 0)
            return res

        worker._dispatch = counted_dispatch
        rows = decode_rows(core)
        ids = [tok.encode(build_chat_prompt("", p)) for p in prompts()[:4]]
        runs = {mode: spec_run(torch, server, ids, DRAFT_MAX_NEW, mode, rows)
                for mode in ("draft", "lookup", "off")}
    finally:
        server.shutdown()
    if not (runs["draft"]["draft_tokens"] and runs["draft"]["verify_forwards"]):
        raise AssertionError(f"draft: the worker drafted nothing: {runs['draft']}")
    if not (draft_launches.get("paged_decode_attention")
            and draft_launches.get("paged_chunk_attention")):
        raise AssertionError(f"draft: the worker's dispatches launched {draft_launches}")
    out.update(draft_launches=draft_launches,
               runs={m: {k: v for k, v in r.items() if k != "tokens"} for m, r in runs.items()},
               prompt_tokens=[len(p) for p in ids])
    # The self-draft in float32: streams with the draft equal speculation off.
    free_device(torch)
    server, _, _, _, _ = build_serving(torch, layers=SELF_DRAFT_LAYERS, llm={
        "dtype": "float32", "draft_model": ENGINE_MODEL})
    try:
        rows = decode_rows(server.client.core)
        selfd = {}
        for prompt in SELF_DRAFT_PROMPTS:
            pid = [tok.encode(prompt)]
            selfd[prompt] = {mode: spec_run(torch, server, pid, DRAFT_MAX_NEW, mode, rows)
                             for mode in ("off", "draft")}
    finally:
        server.shutdown()
    for prompt, res in selfd.items():
        if res["draft"]["tokens"] != res["off"]["tokens"]:
            raise AssertionError(f"self-draft {prompt!r}: the draft's stream parts from "
                                 f"speculation off at "
                                 f"{first_divergence(res['draft']['tokens'], res['off']['tokens'])}")
        if not res["draft"]["spec_accepted"]:
            raise AssertionError(f"self-draft {prompt!r}: nothing accepted: {res['draft']}")
    out["self_draft"] = {"dtype": "float32", "layers": SELF_DRAFT_LAYERS,
                         "same_as_speculation_off": True,
                         **{p: {m: {k: v for k, v in r.items() if k != "tokens"}
                                for m, r in res.items()} for p, res in selfd.items()}}
    return out


def lora_draft_phases(torch) -> dict:
    """Phase 22: multi-LoRA serving, then draft-model speculation; returns
    the kernel launches counted across both (K1, K2 and its merge)."""
    import tempfile

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        emit(phase_lora(torch, Path(tmp)))
    emit(phase_draft(torch))
    return counts()

# ------------------------------------------------- phase 23: Mixtral MoE serving

MOE_MODEL = "mixtral-8x7b-instruct"  # D 4096, F 14336, E 8, top 2, 32/8 heads, head_dim 128
MOE_CHECK_TOKENS = (8, 512)  # moe_ffn held against the f32 per-token reference
MOE_TIMED_TOKENS = (8, 512, 2048)  # decode batch, one prefill chunk, a 4-row prefill
# A bf16 moe_ffn output against the f32 reference over the same bf16 inputs:
# each of its five roundings (gate and up products, SwiGLU, down product,
# gated sum) costs about 2^-9 relative, so a few 1e-3 of |out| ~ 0.5 per
# element, 1e-2 at the tail of 2M elements; int8 experts against their
# dequantized f32 weights likewise.
MOE_TOL = (2e-2, 2e-2)  # (atol, rtol)
# Tokens whose 2nd and 3rd f32 probabilities lie this close may route apart
# (the logits' float32 sums in another order); their outputs are not compared.
MOE_ROUTE_TOL = 1e-4
MOE_BF16_LAYERS = 8  # the bf16 tree at 8 of 32 layers: 23.5 GB
MOE_MAX_NEW = 64  # the int8 deployment's budget a request
MOE_SHORT_NEW = 16  # the graphs-off runs' budget
MOE_MUST = {"bfloat16": ("paged_decode_attention", "paged_chunk_attention"),
            "int8": ("paged_decode_attention", "paged_chunk_attention", "qmm_int8")}


def moe_prompts(short: bool = False) -> list[str]:
    """Eight user turns: phase 7's five and three more (the fourth repeats
    itself, so prompt lookup drafts); ``short`` gives eight others that share
    no first page with them (no cached prefix between the two sets)."""
    base = prompts() + ["the payments-db pool is exhausted; " * 5,
                        "rollback deploy 4411 now", "summarise the incident " * 9]
    if short:
        return [f"short {i}: " + p[::-1] for i, p in enumerate(base)]
    return base


def moe_layer(torch, int8: bool):
    """One Mixtral layer's router and experts on the card, random from a
    seed (std 1/sqrt(fan_in)), bf16 or int8 (``quantize_tensor``: per expert
    and output channel), with their float32 values for the reference."""
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.models.quant import quantize_tensor

    cfg = get_config(MOE_MODEL)
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(23)

    def draw(shape, fan_in):
        out = torch.empty(shape, dtype=torch.bfloat16, device=DEVICE)
        for part in out.reshape(-1, *shape[-2:]):
            part.copy_(torch.randn(part.shape, generator=gen, device=DEVICE) / fan_in ** 0.5)
        return out

    router = draw((d, e), d)
    experts = [draw((e, d, f), d), draw((e, d, f), d), draw((e, f, d), f)]
    if int8:
        experts = [quantize_tensor(w) for w in experts]
    return cfg, router, experts


def moe_reference(torch, x, router, experts, top_k: int):
    """Mixtral's MoE over ``x`` [N, D] in float32, token by token in the
    form of ``tests/test_moe.py::_ref_moe`` (each token runs its top-k
    experts, gates renormalised), batched by expert: every token's output
    under expert e is computed and kept where e is among its top k. Returns
    (output [N, D], probabilities sorted [N, E], their expert ids)."""
    from runbookai_tpu_torch.models.quant import dequantize_tensor, is_quantized

    xf = x.float()
    probs = torch.softmax(xf @ router.float(), dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = sorted_p[:, :top_k] / sorted_p[:, :top_k].sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(router.shape[-1]):
        w = [dequantize_tensor({k: v[e] for k, v in m.items()}) if is_quantized(m)
             else m[e].float() for m in experts]
        act = torch.nn.functional.silu(xf @ w[0]) * (xf @ w[1])
        weight = (gates * (order[:, :top_k] == e)).sum(-1, keepdim=True)
        out += weight * (act @ w[2])
    return out, sorted_p, order


def moe_bound(cfg, n: int, int8: bool) -> tuple[float, str]:
    """The least time of one layer's MoE FFN over ``n`` tokens: the router
    and every expert's weights read once (int8: a byte a weight and a float32
    scale an output channel), the tokens read and the output written in bf16,
    against the products the routed tokens need (top_k experts a token, not
    the dropless queues' E)."""
    d, f, e, k = cfg.dim, cfg.ffn_dim, cfg.n_experts, cfg.top_k_experts
    w_bytes = 3 * e * d * f * (1 if int8 else 2) + (e * (2 * f + d) * 4 if int8 else 0)
    n_bytes = w_bytes + d * e * 2 + 2 * n * d * 2
    flops = 2 * n * (k * 3 * d * f + d * e)
    return bound(n_bytes, flops, "bfloat16")


def phase_moe_ffn(torch) -> dict:
    """``ops/moe.py::moe_ffn`` at Mixtral's widths on the card, bf16 and
    int8 experts, dropless: at N = 8 and 512 against the float32 reference
    (routes tie-aware, outputs within MOE_TOL), then timed (CUDA events) at
    N = 8, 512 and 2,048 beside its bound, with the transient bytes one call
    allocates above its inputs (the dropless [E, N, F] activations; int8:
    each widened [E, in, out] matrix)."""
    from runbookai_tpu_torch.ops.moe import moe_ffn, route

    free_device(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    out: dict = {"phase": "moe_ffn", "model": MOE_MODEL, "tol": MOE_TOL,
                 "route_tol": MOE_ROUTE_TOL, "card": smi.stdout.strip().splitlines()[0]}
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    for kind in ("bfloat16", "int8"):
        cfg, router, experts = moe_layer(torch, kind == "int8")
        k = cfg.top_k_experts
        res: dict = {}
        for n in MOE_TIMED_TOKENS:
            x = torch.randn((1, n, cfg.dim), generator=gen, device=DEVICE).to(torch.bfloat16)

            def call(x=x):
                return moe_ffn(x, router, *experts, k, cfg.capacity_factor)

            case: dict = {}
            if n in MOE_CHECK_TOKENS:
                got = call()[0]
                ref, sorted_p, order = moe_reference(torch, x[0], router, experts, k)
                _, idx = route(x[0], router, k)
                same = (idx.sort(-1).values == order[:, :k].sort(-1).values).all(-1)
                near = (sorted_p[:, k - 1] - sorted_p[:, k]) <= MOE_ROUTE_TOL
                if bool((~same & ~near).any()):
                    raise AssertionError(f"moe_ffn {kind} N={n}: {int((~same).sum())} "
                                         f"tokens routed apart from the f32 reference")
                atol, rtol = MOE_TOL
                diff = (got.float() - ref).abs()[same]
                if not bool(got.isfinite().all()) or bool(
                        (diff > atol + rtol * ref[same].abs()).any()):
                    raise AssertionError(f"moe_ffn {kind} N={n}: max |err| "
                                         f"{float(diff.max()):.3e} beyond {MOE_TOL}")
                case.update(max_abs_err=float(diff.max()),
                            ref_max_abs=float(ref.abs().max()),
                            routed_apart=int((~same).sum()), near_ties=int(near.sum()))
                del got, ref
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            case["transient_bytes"] = torch.cuda.max_memory_allocated() - base
            case["ms"] = time_ms(call, iters=10 if n < 2048 else 5, warmup=2)
            case["bound_ms"], case["bound_by"] = moe_bound(cfg, n, kind == "int8")
            case["dropless_product_flops"] = 2 * cfg.n_experts * n * 3 * cfg.dim * cfg.ffn_dim
            res[f"n{n}"] = case
        out[kind] = res
        out[f"clocks_{kind}"] = gpu_clocks()
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0),
                                 *(c["max_abs_err"] for c in res.values() if "max_abs_err" in c))
        del router, experts
        free_device(torch)
    return out


def moe_client(torch, weights: str, layers: Optional[int] = None):
    """``mixtral-8x7b-instruct`` from seed 0 on the card through the entry
    points a user calls: bf16 weights and pool at ``layers`` of its 32
    layers (``TorchCudaClient.build``), or the one-card deployment, int8
    weights at all 32 layers over a bf16 pool (``TorchCudaClient.from_config``
    on an ``llm`` block: the int8 tree is drawn on the card, the 93 GB bf16
    tree never exists). Step graphs on; the serving engine's defaults."""
    import dataclasses
    from unittest import mock

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama
    from runbookai_tpu_torch.utils.config import LLMConfig

    if weights == "int8":
        llm = LLMConfig(provider="jax-tpu", model=MOE_MODEL, dtype="int8",
                        max_new_tokens=MOE_MAX_NEW)
        return TorchCudaClient.from_config(llm, device=DEVICE)
    cfg = llama.get_config(MOE_MODEL)
    with mock.patch.dict(llama.CONFIGS, {MOE_MODEL: dataclasses.replace(cfg, n_layers=layers)}):
        return TorchCudaClient.build(MOE_MODEL, device=DEVICE, dtype=torch.bfloat16, seed=0,
                                     max_new_tokens=MOE_MAX_NEW)


def serve_texts(client, texts: list[str], max_new: int, what: str = "moe") -> dict:
    """Serve ``texts`` at once (greedy, ``max_new`` tokens each) from a
    fresh speculation backoff and stop the engine: every request must end
    with 1..max_new in-vocabulary tokens. Returns the streams, walls and
    TTFTs, and the engine's decode seconds a step over this run."""
    client.max_new_tokens = max_new
    fresh_backoff(client)
    core = client.core
    steps, decode_s = core.metrics["decode_steps"], core.metrics["decode_time_s"]
    before = len(core.finished)
    resps, wall = asyncio.run(_serve_and_stop(client, texts))
    finished = list(core.finished)[before:]
    done = [r.usage["completion_tokens"] for r in resps]
    if client.engine.crash_count or len(finished) != len(texts) or any(
            not 1 <= n <= max_new for n in done) or any(
            r.finish_reason is None or r.finish_reason.value == "aborted" for r in finished):
        raise AssertionError(f"{what}: served {done} tokens, finishes "
                             f"{[r.finish_reason for r in finished]}")
    if any(not 0 <= t < core.cfg.vocab_size for r in finished for t in r.all_out_ids):
        raise AssertionError(f"{what}: a sampled id lies outside the vocabulary")
    ids = [client._prompt_ids("", u, None) for u in texts]
    n_steps = core.metrics["decode_steps"] - steps
    return {"greedy_tokens": [streams_by_prompt(finished, p) for p in ids],
            "prompt_tokens": [len(p) for p in ids], "completion_tokens": done,
            "wall_s": wall, "tokens_per_s": sum(done) / wall,
            "decode_s_per_step": (core.metrics["decode_time_s"] - decode_s) / max(1, n_steps),
            "ttft_ms": [r.usage["ttft_ms"] for r in resps]}


def check_moe_launches(weights: str, launched: dict) -> None:
    if any(launched[k] == 0 for k in MOE_MUST[weights]):
        raise AssertionError(f"moe {weights}: a kernel of the path never launched: {launched}")


def phase_moe_bf16(torch) -> dict:
    """bf16 Mixtral at MOE_BF16_LAYERS of its 32 layers (23.5 GB of
    weights): eight greedy requests with the step graphs on, then the same
    eight on a graphs-off twin over the same params: equal streams. K1 and
    K2 counted over the graphs-on run; a decode forward's device ms from
    the ("forward", 1) graph's replays."""
    from runbookai_tpu_torch.models.quant import weight_bytes

    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = moe_client(torch, "bfloat16", layers=MOE_BF16_LAYERS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    texts = moe_prompts()
    reset_counts()
    on = serve_texts(client, texts, MOE_SHORT_NEW * 2)
    launched = counts()
    check_moe_launches("bfloat16", launched)
    core = client.core
    res = {"phase": "moe_bf16", "model": MOE_MODEL, "layers": core.cfg.n_layers,
           "decode_forward_ms": forward_replay_ms(torch, core) if core._graphs else None,
           "weight_bytes": weight_bytes(core.params), "build_s": build_s,
           "graph_capture_s": core.metrics["graph_capture_s"],
           "graph_buckets": len(core._graphs.buckets) if core._graphs else 0,
           "graph_replays": core.metrics["graph_replays"], "launches": launched,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "max_memory_reserved": torch.cuda.max_memory_reserved(), **on}
    twin = engine_twin(client_parts(client), step_graphs=False)
    del client, core
    free_device(torch)
    off = serve_texts(twin, texts, MOE_SHORT_NEW * 2)
    if twin.core.metrics["graph_replays"] or off["greedy_tokens"] != on["greedy_tokens"]:
        raise AssertionError(f"moe bf16: graphs off gave other greedy tokens, first at "
                             f"{first_divergence(off['greedy_tokens'], on['greedy_tokens'])}")
    res["graphs_off"] = {k: off[k] for k in ("wall_s", "tokens_per_s", "decode_s_per_step",
                                             "ttft_ms")}
    res["same_tokens_graphs_off"] = True
    return res


def phase_moe_int8(torch) -> dict:
    """The one-card deployment: int8 Mixtral at all 32 layers through
    ``TorchCudaClient.from_config``. Its weight bytes must equal
    ``plan_serving``'s; eight requests of MOE_MAX_NEW tokens with the step
    graphs on (tokens a second, decode seconds a step on the host's clock,
    a decode forward's device ms, TTFT, peak memory);
    then eight other requests of MOE_SHORT_NEW tokens on the same engine and
    on a graphs-off twin over the same params: equal streams."""
    from runbookai_tpu_torch.engine.memory_plan import plan_serving
    from runbookai_tpu_torch.models.quant import weight_bytes

    free_device(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = moe_client(torch, "int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    core = client.core
    w_bytes = weight_bytes(core.params)
    plan = plan_serving(core.cfg, core.ecfg.max_seq_len, batch=core.ecfg.max_batch_slots,
                        weights="int8", kv_dtype_bytes=core.kv.pool.kv_k.element_size(),
                        hbm_bytes=torch.cuda.get_device_properties(0).total_memory)
    if plan.weight_bytes_per_chip != w_bytes:
        raise AssertionError(f"moe int8: plan_serving counts {plan.weight_bytes_per_chip} B "
                             f"of weights, the tree holds {w_bytes}")
    built = torch.cuda.memory_allocated()
    reset_counts()
    run = serve_texts(client, moe_prompts(), MOE_MAX_NEW)
    launched = counts()
    check_moe_launches("int8", launched)
    res = {"phase": "moe_int8", "model": MOE_MODEL, "layers": core.cfg.n_layers,
           "decode_forward_ms": forward_replay_ms(torch, core) if core._graphs else None,
           "dtype": "int8", "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
           "weight_bytes": w_bytes, "plan_weight_bytes": plan.weight_bytes_per_chip,
           "plan_pool_budget_bytes": plan.pool_budget_bytes, "fits": plan.fits,
           "pool_bytes": core.kv.pool.nbytes(), "allocated_before": before,
           "allocated_built": built - before, "build_s": build_s,
           "graph_capture_s": core.metrics["graph_capture_s"],
           "graph_buckets": len(core._graphs.buckets) if core._graphs else 0,
           "launches": launched, **run,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "max_memory_reserved": torch.cuda.max_memory_reserved()}
    res.pop("greedy_tokens")
    short = moe_prompts(short=True)
    on = serve_texts(client, short, MOE_SHORT_NEW)
    res["graph_replays"] = core.metrics["graph_replays"]
    twin = engine_twin(client_parts(client), step_graphs=False)
    del client, core
    free_device(torch)
    off = serve_texts(twin, short, MOE_SHORT_NEW)
    if twin.core.metrics["graph_replays"] or off["greedy_tokens"] != on["greedy_tokens"]:
        raise AssertionError(f"moe int8: graphs off gave other greedy tokens, first at "
                             f"{first_divergence(off['greedy_tokens'], on['greedy_tokens'])}")
    res["short"] = {"graphs_on": {k: on[k] for k in ("wall_s", "decode_s_per_step")},
                    "graphs_off": {k: off[k] for k in ("wall_s", "decode_s_per_step")},
                    "same_tokens": True}
    return res


def moe_phases(torch) -> dict:
    """Phase 23: moe_ffn at Mixtral's widths, bf16 Mixtral at 8 layers, the
    int8 deployment at 32; returns the kernel launches of the two serving
    runs with the graphs on (the counts set to 0 before each)."""
    emit(phase_moe_ffn(torch))
    bf16 = phase_moe_bf16(torch)
    emit(bf16)
    int8 = phase_moe_int8(torch)
    emit(int8)
    free_device(torch)
    return {k: bf16["launches"].get(k, 0) + int8["launches"].get(k, 0)
            for k in set(bf16["launches"]) | set(int8["launches"])}



# ------------------------------------ phase 24: fine-tuning and checkpoints
TRAIN_BATCH, TRAIN_SEQ = 4, 256  # one seeded batch of token ids in [1, vocab)
TRAIN_LORA_STEPS = 20
TRAIN_LORA_LR = 1e-3
TRAIN_ADAPTER = "sre-tuned"  # registered all zero, then tuned
TRAIN_FULL_MODEL = "llama3.2-1b-instruct"  # dim 2048, 16 layers, 32/8 heads, tied
TRAIN_FULL_STEPS = 10
TRAIN_FULL_LR = 1e-4
TRAIN_PROMPTS = ("why 5xx on api?", "restart the api")
TRAIN_MAX_NEW = 32
TRAIN_CHAT_TURNS = ("why is checkout slow?", "and the database?")
TRAIN_MUST = ("paged_decode_attention", "paged_chunk_attention")


def train_tokens(torch, vocab: int):
    gen = torch.Generator().manual_seed(0)
    return torch.randint(1, vocab, (TRAIN_BATCH, TRAIN_SEQ), generator=gen)


# Substrings of the kernel names a training step's matmuls run under.
MATMUL_KERNELS = ("gemm", "cutlass", "xmma", "nvjet")


def train_steps(torch, trainer, tokens, steps: int) -> dict:
    """``steps`` train steps of ``trainer`` on ``tokens``, each timed to its
    end (its loss is read on the host), the last under torch.profiler (its
    device time split into matmuls and the rest, against its wall, and the
    optimizer's share of it: the kernels under ``Adam.step``'s
    ``Optimizer.step#...`` range), with the peak memory over them and the
    kernel counts read around them: no wrapper may launch, and the loss
    must fall."""
    import math
    import statistics


    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(tokens))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profiled() as prof:
        t0 = time.perf_counter()
        losses.append(trainer.train_step(tokens))
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    launched = {k: n for k, n in counts().items() if n}
    if launched:
        raise AssertionError(f"train: kernel wrappers launched in the steps: {launched}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    busy = {"matmul": 0.0, "other": 0.0}
    optimizer_ms = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            kind = "matmul" if any(m in e.name.lower() for m in MATMUL_KERNELS) else "other"
            busy[kind] += e.time_range.elapsed_us() / 1e3
        elif e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(
                "Optimizer.step#"):
            optimizer_ms += e.device_time_total / 1e3
    if not sum(busy.values()) or not optimizer_ms:
        raise AssertionError(f"train: the profiled step kept no device kernel, or no "
                             f"optimizer kernel: {busy}, {optimizer_ms} ms")
    step_s = statistics.median(walls[1:])
    return {"steps": steps, "batch": [TRAIN_BATCH, TRAIN_SEQ], "losses": losses,
            "first_step_s": walls[0], "ms_per_step": step_s * 1e3,
            "trained_tokens_per_s": TRAIN_BATCH * (TRAIN_SEQ - 1) / step_s,
            "profiled_step": {"wall_ms": profiled_wall * 1e3,
                              "device_ms": busy, "optimizer_device_ms": optimizer_ms,
                              "idle_share": 1 - sum(busy.values()) / (profiled_wall * 1e3)},
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "kernel_launches_in_steps": 0}


def train_streams(client, adapter: Optional[str] = None) -> list:
    """TRAIN_PROMPTS' greedy streams on ``client``, each alone."""
    from runbookai_tpu_torch.utils.tokens import ByteTokenizer

    return [greedy_in_thread(client, [adapter], ByteTokenizer().encode(p),
                             TRAIN_MAX_NEW)[0].all_out_ids for p in TRAIN_PROMPTS]


def check_train_launches(what: str, launched: dict) -> dict:
    if any(launched.get(k, 0) == 0 for k in TRAIN_MUST):
        raise AssertionError(f"{what}: a kernel of the path never launched: {launched}")
    return launched


def phase_train_attention(torch) -> dict:
    """The training attention (plain torch ops) forward and forward +
    backward at the fine-tunes' shapes, CUDA events, beside the bounds
    (each input read once and each output written once: q, k, v and the
    output forward; q, k, v, the output's gradient and the three input
    gradients forward + backward; operations: the causal triangle of the
    two products, 2 B n_q T (T + 1) hd forward and twice that backward) and
    SDPA's times (``enable_gqa``, ``is_causal``) on the same inputs, with
    the largest difference from SDPA's output."""
    from runbookai_tpu_torch.models.llama import dense_causal_attention, get_config

    F = torch.nn.functional
    out: dict = {"phase": "train_attention"}
    for key, model, dtype in (("lora_8b", ENGINE_MODEL, torch.bfloat16),
                              ("full_1b", TRAIN_FULL_MODEL, torch.float32)):
        cfg = get_config(model)
        b, t, n_q, n_kv, hd = TRAIN_BATCH, TRAIN_SEQ - 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        q, k, v = (torch.randn((b, t, n, hd), generator=gen, device=DEVICE).to(dtype)
                   .requires_grad_(True) for n in (n_q, n_kv, n_kv))
        g = torch.randn((b, t, n_q, hd), generator=gen, device=DEVICE).to(dtype)

        def ours():
            return dense_causal_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True).transpose(1, 2)

        def backward(fn):
            return lambda: torch.autograd.grad(fn(), (q, k, v), g)

        elt = q.element_size()
        q_bytes, kv_bytes = b * t * n_q * hd * elt, b * t * n_kv * hd * elt
        flops = 2 * b * n_q * t * (t + 1) * hd
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        with torch.no_grad():
            diff = float((ours().float() - sdpa().float()).abs().max())
        fwd_bound, fwd_by = bound(2 * q_bytes + 2 * kv_bytes, flops, name)
        bwd_bound, bwd_by = bound(3 * q_bytes + 4 * kv_bytes, 3 * flops, name)
        out[key] = {"model": model, "dtype": name, "shape": [b, t, n_q, n_kv, hd],
                    "forward_ms": time_ms(ours), "forward_backward_ms": time_ms(backward(ours)),
                    "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by,
                    "forward_backward_bound_ms": bwd_bound, "forward_backward_bound_by": bwd_by,
                    "library_forward_ms": time_ms(sdpa),
                    "library_forward_backward_ms": time_ms(backward(sdpa)),
                    "max_abs_diff_from_library": diff}
    return out


def phase_train_lora(torch, tmp: Path) -> tuple[dict, dict]:
    """LoRA fine-tuning on the live 8B at all 32 layers (see the module's
    phase 24); returns the phase line and the kernel launches of serving
    the published adapter (graphs on)."""
    import dataclasses

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.models.lora import LoraRegistry
    from runbookai_tpu_torch.train.lora_trainer import LoraTrainer

    free_device(torch)
    cfg = get_config(ENGINE_MODEL)
    peft = write_peft(tmp / "sre-a", 0, cfg.n_layers)
    t0 = time.perf_counter()
    client = TorchCudaClient.build(ENGINE_MODEL, device=DEVICE, dtype=torch.bfloat16, seed=0,
                                   max_new_tokens=TRAIN_MAX_NEW, engine=LORA_ENGINE,
                                   lora_rank=LORA_RANK, lora_adapters={"sre-a": str(peft)})
    torch.cuda.synchronize()
    out: dict = {"phase": "train_lora", "model": ENGINE_MODEL, "layers": cfg.n_layers,
                 "dtype": "bfloat16", "rank": LORA_RANK, "targets": ["wq", "wv"],
                 "learning_rate": TRAIN_LORA_LR, "build_s": time.perf_counter() - t0}
    core, registry = client.core, client.core.lora
    registry.register(TRAIN_ADAPTER, {})
    core.refresh_lora()
    idx = registry.index_of(TRAIN_ADAPTER)
    base_streams = train_streams(client)
    before = {t: {ab: w[:, :idx].clone() for ab, w in ab_w.items()}
              for t, ab_w in registry.stacked().items()}
    trainer = LoraTrainer(cfg, core.params, registry, TRAIN_ADAPTER,
                          learning_rate=TRAIN_LORA_LR)
    if not trainer.lora_tree["wq"]["A"][:, idx].any() or trainer.lora_tree["wq"]["B"][:, idx].any():
        raise AssertionError("train_lora: the zero adapter was not initialised as A ~ N, B = 0")
    out.update(train_steps(torch, trainer, train_tokens(torch, cfg.vocab_size), TRAIN_LORA_STEPS))
    t0 = time.perf_counter()
    trainer.publish()
    core.refresh_lora()
    torch.cuda.synchronize()
    out["publish_refresh_s"] = time.perf_counter() - t0
    stacked = registry.stacked()
    for t, ab_w in stacked.items():
        for ab, w in ab_w.items():
            if not torch.equal(w[:, :idx], before[t][ab]) or not torch.equal(
                    w[:, idx], trainer.lora_tree[t][ab][:, idx].detach().to(w.dtype)):
                raise AssertionError(f"train_lora: publish wrote other rows of {t}.{ab}")
    reset_counts()
    live = train_streams(client, TRAIN_ADAPTER)
    launched = check_train_launches("train_lora", counts())
    if live == base_streams:
        raise AssertionError("train_lora: the published adapter serves the base streams")
    trainer.export_peft(tmp / "exported")
    del trainer
    fresh_reg = LoraRegistry(cfg, rank=LORA_RANK, targets=("wq", "wv"), dtype=torch.bfloat16,
                             device=DEVICE)
    fresh_reg.load_peft_dir(TRAIN_ADAPTER, tmp / "exported")
    base = {k: v for k, v in core.params.items() if k != "lora"}
    fresh = {}
    for graphs in (True, False):
        other = TorchCudaClient(TorchCudaClient._core(
            cfg, base, client.tokenizer, dataclasses.replace(core.ecfg, step_graphs=graphs),
            lora_registry=fresh_reg), client.tokenizer, max_new_tokens=TRAIN_MAX_NEW)
        fresh[graphs] = train_streams(other, TRAIN_ADAPTER)
        del other
        free_device(torch)
    if fresh[True] != live or fresh[False] != live:
        raise AssertionError(f"train_lora: the exported adapter reloaded serves other streams "
                             f"(graphs on: {first_divergence(fresh[True], live)}, off: "
                             f"{first_divergence(fresh[False], live)})")
    out.update(same_as_exported_graphs_on=True, same_as_exported_graphs_off=True,
               differs_from_base=True, tokens=[len(s) for s in live], launches=launched)
    del client, core, registry, base
    free_device(torch)
    return out, launched


def phase_train_full(torch, tmp: Path) -> tuple[dict, dict]:
    """Full fine-tuning of the 1B in float32 and its checkpoint (see the
    module's phase 24); returns the phase line and the kernel launches of
    serving the restored model (graphs on)."""
    import contextlib
    import io

    from runbookai_tpu_torch import __main__ as cli
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models.checkpoint import load_or_init, save_checkpoint
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.train.trainer import Trainer

    free_device(torch)
    cfg = get_config(TRAIN_FULL_MODEL)
    trainer = Trainer(cfg, learning_rate=TRAIN_FULL_LR, device=DEVICE)
    out: dict = {"phase": "train_full", "model": TRAIN_FULL_MODEL, "layers": cfg.n_layers,
                 "dtype": "float32", "optimizer": "adamw", "learning_rate": TRAIN_FULL_LR,
                 "params": cfg.total_params}
    out.update(train_steps(torch, trainer, train_tokens(torch, cfg.vocab_size),
                           TRAIN_FULL_STEPS))
    params = trainer.state.params
    del trainer
    free_device(torch)
    path = tmp / "ckpt-1b"
    t0 = time.perf_counter()
    save_checkpoint(path, cfg, params)
    out["write_s"] = time.perf_counter() - t0
    out["checkpoint_bytes"] = sum(f.stat().st_size for f in path.iterdir())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["weights", "info", str(path)])
    info = json.loads(printed.getvalue())
    if rc != 0 or info != json.loads(json.dumps(cfg.__dict__)):
        raise AssertionError(f"train_full: weights info gave {rc} {printed.getvalue()[:300]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rcfg, restored = load_or_init(TRAIN_FULL_MODEL, str(path), dtype=torch.float32,
                                  device=DEVICE)
    torch.cuda.synchronize()
    out["read_s"] = time.perf_counter() - t0
    unequal = [name for name in params["layers"] if not torch.equal(
        restored["layers"][name], params["layers"][name])] + [
        name for name in params if name != "layers" and not torch.equal(restored[name],
                                                                         params[name])]
    if rcfg != cfg or unequal or restored.keys() != params.keys():
        raise AssertionError(f"train_full: the checkpoint restored other tensors: {unequal}")
    del restored
    free_device(torch)
    params = {k: ({n: w.detach() for n, w in v.items()} if k == "layers" else v.detach())
              for k, v in params.items()}
    restored_client = TorchCudaClient.build(TRAIN_FULL_MODEL, device=DEVICE,
                                            dtype=torch.float32, model_path=str(path),
                                            max_new_tokens=TRAIN_MAX_NEW)
    reset_counts()
    served = train_streams(restored_client)
    launched = check_train_launches("train_full", counts())
    tok = restored_client.tokenizer
    in_memory = TorchCudaClient(TorchCudaClient._core(cfg, params, tok,
                                                      restored_client.core.ecfg),
                                tok, max_new_tokens=TRAIN_MAX_NEW)
    if train_streams(in_memory) != served:
        raise AssertionError("train_full: the restored model and the trained one in memory "
                             "serve other streams")
    out.update(restored_bit_equal=True, same_streams_restored_and_in_memory=True,
               tokens=[len(s) for s in served], launches=launched)
    del restored_client, in_memory, params
    free_device(torch)
    return out, launched


def phase_train_chat(torch, tmp: Path) -> tuple[dict, dict]:
    """``chat --raw`` through the CLI on the 8B at CUT_LAYERS layers, with
    TRAIN_CHAT_TURNS piped into standard input; returns the phase line and
    the kernel launches of the two turns."""
    import dataclasses
    import io
    from unittest import mock

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama

    free_device(torch)
    clients = []
    from_config = TorchCudaClient.from_config.__func__

    def kept(cls, *args, **kw):
        clients.append(from_config(cls, *args, **kw))
        return clients[-1]

    config = serve_config(tmp, {"max_new_tokens": TRAIN_MAX_NEW})
    cfg = llama.get_config(ENGINE_MODEL)
    depth = {ENGINE_MODEL: dataclasses.replace(cfg, n_layers=CUT_LAYERS)}
    typed = io.StringIO("".join(f"{turn}\n" for turn in TRAIN_CHAT_TURNS) + "\n")
    reset_counts()
    with mock.patch.dict(llama.CONFIGS, depth), mock.patch.object(sys, "stdin", typed), \
            mock.patch.object(TorchCudaClient, "from_config", classmethod(kept)):
        rc, printed, wall = run_cli(["chat", "--raw", "--config", str(config)])
    launched = check_train_launches("train_chat", counts())
    reqs = list(clients[0].core.finished) if len(clients) == 1 else []
    if rc != 0 or len(reqs) != 2 or printed.count("you> ") != 3 or not (
            "runbook chat --raw" in printed) or len(reqs[1].prompt_ids) <= len(
            reqs[0].prompt_ids) or any(not 1 <= r.num_generated <= TRAIN_MAX_NEW for r in reqs):
        raise AssertionError(f"train_chat: rc {rc}, {len(reqs)} requests, printed "
                             f"{printed[:300]!r}")
    del clients
    free_device(torch)
    return ({"phase": "train_chat", "model": ENGINE_MODEL, "layers": CUT_LAYERS,
             "wall_s": wall, "prompt_tokens": [len(r.prompt_ids) for r in reqs],
             "completion_tokens": [r.num_generated for r in reqs], "launches": launched},
            launched)


def train_phases(torch) -> dict:
    """Phase 24; returns the kernel launches of its serving runs (graphs on,
    the counts set to 0 before each)."""
    import tempfile

    emit(phase_train_attention(torch))
    total: dict = {}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for run in (phase_train_lora, phase_train_full, phase_train_chat):
            line, launched = run(torch, Path(tmp))
            emit(line)
            for k, n in launched.items():
                total[k] = total.get(k, 0) + n
    free_device(torch)
    return total


# --------------------- phase 25: long contexts and the 70B on one card
LONG_MODEL = "llama3.1-8b-instruct"  # the 8B's widths, Llama-3.1 rope scaling
LONG_SEQ = 32_768  # llm.max_seq_len of the long deployment
LONG_POOL_PAGES = 4_096  # llm.num_pages: 65,536 tokens, 4.29 GB of fp8 pool
LONG_PROMPT = 32_000  # byte tokens of the long request (chat template included), about
LONG_MAX_NEW = 32
LONG_TABLE = LONG_SEQ // PS  # 2,048 table columns (+ the trash column)
# The page split's pool: the allocator hands out the lowest free pages first,
# so the long request's 2,000-odd pages cross page shard 0's 1,280 into
# shard 1's (of LONG_POOL_PAGES they would all lie on shard 0).
LONG_SPLIT_PAGES = 2_560
# The kernel cases over the long table: B = 8 decode rows up to 32,767 keys,
# 3,925 pages of the deployment's 4,096.
LONG_DECODE_CTX = [32_767, 16_384, 8_191, 4_097, 1_000, 300, 17, 0]
LONG_CHUNK_START = LONG_SEQ - 512  # the long prompt's last 512-token chunk
# W1 with a decode row at a 32k context beside the served ones and a
# 512-token prefill at offset 4096 (``ctx32k``); and with the long prompt's
# last 512-token chunk (ctx 32,768: its prefill tiles walk up to 32,768 keys
# unsplit, as the served mixed run's do) beside a 16,384-key decode row and
# the served ones (``prefill32k``).
RAGGED_LONG_KINDS = {"ctx32k": ([32_767, *SERVED_CTX[1:]], 512),
                     "prefill32k": ([16_384, *SERVED_CTX[1:]], 512, LONG_CHUNK_START)}
G8 = (64, 8, 128)  # llama3-70b-instruct's heads: a GQA group of 8
BIG_MODEL = "llama3-70b-instruct"  # dim 8192, 80 layers, 64/8 heads, ffn 28672
BIG_QMM_SHAPES = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
                  "wo": (8192, 8192), "w_gate": (8192, 28672), "w_up": (8192, 28672),
                  "w_down": (28672, 8192)}
BIG_QMM_ROWS = (8, 64)
# Rotating slices of the 70B's K5 cases: eight of its smallest matrix (wk,
# 8.4 MB) already pass the 50 MB L2.
BIG_QMM_LAYERS = 8
# Of plan_serving's pool budget (the card's memory less the weights and the
# plan's 1.5 GiB headroom), the bytes left out of the pool for the prefill's
# widened int8 matrices (470 MB for w_gate), activations, the step graphs'
# pool, the CUDA context and the allocator's fragments: at 3 GiB one card
# kept 0.78 GB free after serving, another ran out in the capture with 1.98
# GiB reserved but unallocated. 4.75 GiB leaves 1,072 pages on an 85.02 GB
# H100.
BIG_POOL_MARGIN = int(4.75 * 2**30)
BIG_MIN_PAGES = 1_024
BIG_MAX_NEW = 32
BIG_PROFILE_STEPS = 4  # engine steps of the profiled decode window


def chunk_case(pa, torch, q, k, v, tables, ctx, pos, real, what: str,
               gate_drop: bool = True) -> dict:
    """One bf16 chunk call (K2 over a bf16, int8 or fp8 pool) against its
    plain version: one K2 launch (a split call's merge counts apart), its
    split count, the dropped-last-page check (gated with ``gate_drop``, as
    phase 3 gates it), and :func:`time_chunk`'s times and bound."""
    q_start = pos[:, 0].contiguous()
    reset_counts()
    out = pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)
    per_call = sum(pa.launches.values())
    if per_call != 1:
        raise AssertionError(f"chunk {what}: {counts()} launches for one call")
    ref = pa.plain_paged_attention(q, k, v, tables, ctx, q_start, PS)
    torch.cuda.synchronize()
    err = compare(out, ref, "bfloat16", f"chunk {what}")
    sel = torch.tensor([i for i, n in enumerate(real) if n], device=q.device)
    wrong = drop_last_page(pa, q[sel], k, v, tables[sel], ctx[sel], q_start[sel], ref[sel],
                           "bfloat16", gate=gate_drop)
    del out, ref
    return {"max_abs_err": err, "tol": TOL["bfloat16"], "q": list(q.shape),
            "splits": chunk_plan_of(pa, q, k, tables).splits, "launches_per_call": per_call,
            "drop_last_page": wrong,
            **time_chunk(pa, torch, q, k, v, tables, ctx, pos, "bfloat16")}


def phase_long_kernels(pa, torch) -> dict:
    """Phase 25 (a), the long table: the attention kernels over tables of
    LONG_TABLE + 1 columns (max_seq_len 32,768) and a pool of
    LONG_POOL_PAGES pages, 32/8 heads at head_dim 128, bf16 queries. K1 on
    B = 8 rows of LONG_DECODE_CTX keys, over a bf16 and an fp8 pool (the
    fp8 call equal to the bf16 one over the widened pool); K4 on the same
    input cut into PG page shards at the tp=16 call's heads; K2 on the long
    prompt's last 512-token chunk (ctx 32,768), bf16 and fp8; W1 with a
    decode row at 32,767 keys (``ragged``), and W1 with that last chunk as
    its prefill row beside decode rows (``ragged_prefill32k``), bf16 and
    fp8. Each against its plain version with TOL, timed, beside its bound
    and SDPA's time; the dropped-last-page checks are recorded, not gated
    (a 15-key last page of 32,767 keys moves the output by less than the
    tolerance)."""
    from runbookai_tpu_torch.ops.attention import to_fp8

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(25)
    wide = dict(columns=LONG_TABLE, pages=LONG_POOL_PAGES)
    res: dict = {"phase": "long_kernel", "table_columns": LONG_TABLE + 1,
                 "pool_pages": LONG_POOL_PAGES, "heads": [N_Q, N_KV], "head_dim": HD}
    ctx = torch.tensor(LONG_DECODE_CTX, dtype=torch.int32, device=dev)
    k, v, tables = make_pool(gen, torch.bfloat16, LONG_DECODE_CTX, dev, **wide)
    q = torch.randn((B, N_Q, HD), generator=gen, device=dev).to(torch.bfloat16)
    res["decode"] = decode_case(pa, torch, q, k, v, tables, ctx, "bfloat16", gate_drop=False)
    k8, v8 = to_fp8(k), to_fp8(v)
    res["decode_fp8"] = {
        **decode_case(pa, torch, q, k8, v8, tables, ctx, "bfloat16", gate_drop=False),
        **same_as_bf16(pa, torch, lambda kk, vv: pa.paged_decode_attention(
            q, kk, vv, tables, ctx, PS), k8, v8, "decode fp8 ctx32k")}
    del k8, v8
    nq, nkv = plan_heads(torch)
    res["decode_partial"] = shard_case(
        pa, torch, q[:, :nq].contiguous(), k[:, :nkv].contiguous(),
        v[:, :nkv].contiguous(), tables, ctx, None, "bfloat16", gate_drop=False)
    del q, k, v
    q, k, v, tables, ctx, pos, real = chunk_inputs(torch, dev, gen, torch.bfloat16,
                                                   "prefill_32k", **wide)
    res["chunk"] = chunk_case(pa, torch, q, k, v, tables, ctx, pos, real, "ctx32k",
                              gate_drop=False)
    k8, v8 = to_fp8(k), to_fp8(v)
    res["chunk_fp8"] = {
        **chunk_case(pa, torch, q, k8, v8, tables, ctx, pos, real, "ctx32k fp8",
                     gate_drop=False),
        **same_as_bf16(pa, torch, lambda kk, vv: pa.paged_chunk_attention(
            q, kk, vv, tables, ctx, pos, PS), k8, v8, "chunk fp8 ctx32k")}
    del q, k, v, k8, v8
    for kind, key in (("ctx32k", "ragged"), ("prefill32k", "ragged_prefill32k")):
        q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(
            torch, dev, gen, torch.bfloat16, kind, **wide)
        res[key] = ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, kind)
        if kind == "prefill32k":
            k8, v8 = to_fp8(k), to_fp8(v)
            res[key + "_fp8"] = {
                **ragged_case(pa, torch, q, k8, v8, tables, ctx, pos, rows, pads,
                              f"{kind} fp8"),
                **same_as_bf16(pa, torch, lambda kk, vv: pa.paged_ragged_attention(
                    q, kk, vv, tables, ctx, pos, rows, PS, ragged_block=RQ), k8, v8,
                    f"ragged fp8 {kind}")}
            del k8, v8
        del q, k, v
    res["max_abs_err"] = max(res[x]["max_abs_err"] for x in (
        "decode", "decode_fp8", "decode_partial", "chunk", "chunk_fp8", "ragged",
        "ragged_prefill32k", "ragged_prefill32k_fp8"))
    return res


def phase_group8_kernels(pa, torch) -> dict:
    """Phase 25 (a), a GQA group of 8: K1 and K3 (an int8 pool quantized
    from the bf16 one) on phase 2's decode input, K2 and K2-int8 on phase
    3's 4 x 512 prefill and T=8 verify, and W1 on phase 13's served mixed
    batch, at llama3-70b-instruct's 64 query / 8 kv heads (head_dim 128),
    bf16 queries: each against its plain version with TOL, timed beside its
    bound and SDPA's time."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(26)
    n_q, n_kv, hd = G8
    res: dict = {"phase": "group8_kernel", "heads": [n_q, n_kv], "head_dim": hd}
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    k, v, tables = make_pool(gen, torch.bfloat16, DECODE_CTX, dev, n_kv, hd)
    q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
    res["decode"] = decode_case(pa, torch, q, k, v, tables, ctx, "bfloat16")
    res["decode_int8"] = decode_case(pa, torch, q, quantize_kv(k), quantize_kv(v), tables,
                                     ctx, "bfloat16")
    del q, k, v
    for kind in ("prefill", "verify"):
        q, k, v, tables, ctx, pos, real = chunk_inputs(torch, dev, gen, torch.bfloat16, kind,
                                                       G8)
        res[f"chunk_{kind}"] = chunk_case(pa, torch, q, k, v, tables, ctx, pos, real,
                                          f"group 8 {kind}")  # the check gated, as phase 3
        res[f"chunk_int8_{kind}"] = chunk_case(pa, torch, q, quantize_kv(k), quantize_kv(v),
                                               tables, ctx, pos, real, f"group 8 int8 {kind}")
        del q, k, v
    q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(torch, dev, gen, torch.bfloat16,
                                                          "served", *G8)
    res["ragged"] = ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, "group 8")
    del q, k, v
    res["max_abs_err"] = max(c["max_abs_err"] for c in res.values() if isinstance(c, dict))
    return res


def phase_qmm_big(torch) -> dict:
    """Phase 25 (a), K5 at llama3-70b-instruct's four (K, N) shapes and
    M = 8 and 64 (a decode step of 8 slots, a T=8 verify), as phase 5 runs
    it (``qmm_case``), rotating over BIG_QMM_LAYERS slices; one layer's seven
    products summed at each M."""
    from runbookai_tpu_torch.ops import qmm as qm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(27)
    cases: dict = {}
    for k, n in sorted(set(BIG_QMM_SHAPES.values())):
        q = torch.empty((BIG_QMM_LAYERS, k, n), dtype=torch.int8, device=dev)
        for part in q:
            part.random_(-127, 128, generator=gen)
        s = (torch.rand((BIG_QMM_LAYERS, 1, n), generator=gen, device=dev) + 0.5) \
            * (3 ** 0.5 / (127 * k ** 0.5))
        deq = q.to(torch.bfloat16) * s.to(torch.bfloat16)
        for m in BIG_QMM_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases[f"{m}x{k}x{n}"] = qmm_case(qm, torch, x, q, s, deq, "bfloat16")
        del q, s, deq
    per_layer = {}
    for m, key in ((8, "decode"), (64, "verify")):
        rows = [cases[f"{m}x{k}x{n}"] for k, n in BIG_QMM_SHAPES.values()]
        per_layer[key] = {f: sum(r[f] for r in rows)
                          for f in ("ms", "events_ms", "graph_ms", "plain_ms", "library_ms",
                                    "bound_ms")}
        per_layer[key]["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                                      else "operations")
    return {"phase": "qmm_70b_kernel", "model": BIG_MODEL, "tol": TOL["bfloat16"],
            "layers_rotated": BIG_QMM_LAYERS,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "per_layer": per_layer, "cases": cases}


def long_prompt() -> str:
    """A user turn whose prompt, chat template included, is about
    LONG_PROMPT byte tokens: incident log lines drawn from a seed."""
    import random

    rng = random.Random(25)
    services = KNOWLEDGE_SERVICES
    lines = []
    size = 0
    while size < LONG_PROMPT - 200:
        line = (f"{rng.randrange(10**9):09d} {rng.choice(services)} "
                f"{rng.choice(_SYMPTOMS)} p99={rng.randrange(20, 4000)}ms "
                f"{' '.join(rng.choice(_WORDS) for _ in range(6))}\n")
        lines.append(line)
        size += len(line)
    return "summarise these incident log lines:\n" + "".join(lines)


def long_engine_cfg(torch):
    """The long deployment's engine: ``from_config``'s for an ``llm`` block
    with ``max_seq_len`` LONG_SEQ, ``num_pages`` LONG_POOL_PAGES and
    ``kv_cache_dtype: fp8`` (the serving engine's defaults otherwise)."""
    import dataclasses

    from runbookai_tpu_torch.model.torch_cuda import serving_engine_config
    from runbookai_tpu_torch.models.llama import get_config

    return dataclasses.replace(serving_engine_config(get_config(LONG_MODEL),
                                                     torch.float8_e4m3fn),
                               max_seq_len=LONG_SEQ, num_pages=LONG_POOL_PAGES)


def long_client(torch):
    """llama3.1-8b-instruct at all 32 layers from seed 0 through
    ``TorchCudaClient.from_config`` on an ``llm`` block: bf16 weights, an
    fp8 pool, ``max_seq_len`` LONG_SEQ, ``num_pages`` LONG_POOL_PAGES, byte
    tokenizer, step graphs on."""
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.utils.config import LLMConfig

    llm = LLMConfig(provider="jax-tpu", model=LONG_MODEL, dtype="bfloat16",
                    kv_cache_dtype="fp8", max_seq_len=LONG_SEQ, num_pages=LONG_POOL_PAGES,
                    max_new_tokens=LONG_MAX_NEW)
    client = TorchCudaClient.from_config(llm, device=DEVICE)
    want, got = long_engine_cfg(torch), client.core.ecfg
    if (got.max_seq_len, got.num_pages, got.kv_dtype) != (want.max_seq_len, want.num_pages,
                                                           want.kv_dtype):
        raise AssertionError(f"from_config built {got}")
    return client


def engine_twin(parts: tuple, **changes):
    """A client over the params of ``parts`` (:func:`client_parts` of a
    stopped client) with its engine config changed by ``changes``, none of
    them drawn again. Where the caller drops the stopped client's engine
    first, the two pools are never held together."""
    import dataclasses

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient

    cfg, params, tokenizer, ecfg, max_new, fmt = parts
    core = TorchCudaClient._core(cfg, params, tokenizer, dataclasses.replace(ecfg, **changes))
    return TorchCudaClient(core, tokenizer, max_new_tokens=max_new, chat_format=fmt)


def client_parts(client) -> tuple:
    core = client.core
    return (core.cfg, core.params, client.tokenizer, core.ecfg, client.max_new_tokens,
            client.chat_format)


def long_run(torch, client, texts: list[str], what: str) -> dict:
    """Serve ``texts`` at once on ``client`` (:func:`serve_texts`, from a
    fresh speculation backoff; the engine stops), with the launch counts set
    to 0 just before and read just after, the rows of every decode dispatch
    and the peak memory."""
    core = client.core
    torch.cuda.reset_peak_memory_stats()
    rows = decode_rows(core)
    reset_counts()
    run = serve_texts(client, texts, LONG_MAX_NEW, what)
    launched = counts()
    return {**run, "launches": {k: n for k, n in launched.items() if n},
            "graph_replays": core.metrics["graph_replays"],
            "mixed_steps": core.metrics["mixed_steps"],
            "decode_dispatch_rows": [r for r, _ in rows],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved()}


def record_first_logits(core, ctx_len: int) -> dict:
    """Keep, from ``core``'s first draw with a row at context ``ctx_len``,
    that row's logits (f32, on the card): a prompt of ``ctx_len`` tokens
    draws its first token from its last position's logits, on the split
    path (prefill) and on the mixed one alike. Wraps this engine's
    ``_draw`` only; each draw before the hit reads its contexts on the
    host, so step graphs must be off."""
    seen: dict = {}
    draw = core._draw

    def recording_draw(logits, inputs, ctx_lens, *args, **kwargs):
        if "logits" not in seen:
            hit = (ctx_lens == ctx_len).nonzero()
            if hit.numel():
                seen["logits"] = logits[int(hit[0, 0])].float().clone()
        return draw(logits, inputs, ctx_lens, *args, **kwargs)

    core._draw = recording_draw
    return seen


def first_token_witness(split, mixed) -> dict:
    """The long request's first token on the split path and on the mixed one
    (``split`` and ``mixed``: the logits of its prompt's last position on
    each, as the engine drew from them): each path's greedy pick (argmax:
    the lowest id among equal logits), the tokens that share its top logit,
    both picks' logits on each path, and how far the two paths' logits lie
    apart. Recorded, not gated: it shows whether a flip is a tie broken
    otherwise after rounding."""
    picks = {"split": int(split.argmax()), "mixed": int(mixed.argmax())}
    res: dict = {}
    for name, logits in (("split", split), ("mixed", mixed)):
        top = logits.max()
        res[name] = {"pick": picks[name], "top_logit": float(top),
                     "tokens_at_top": (logits == top).nonzero().flatten().tolist()[:8],
                     "logits_at_picks": {p: float(logits[t]) for p, t in picks.items()}}
    diff = (split - mixed).abs()
    res.update(max_abs_logit_diff=float(diff.max()), mean_abs_logit_diff=float(diff.mean()),
               same_first_token=picks["split"] == picks["mixed"])
    return res


def check_long_launches(what: str, launched: dict, must: tuple) -> None:
    if any(not launched.get(k) for k in must) or any(
            n and k in BF16_POOL for k, n in launched.items()):
        raise AssertionError(f"{what}: a kernel of the path never launched, or a bf16-pool "
                             f"kernel ran over the fp8 pool: {launched}")


def phase_long_serve(torch) -> dict:
    """Phase 25 (b): the long deployment (:func:`long_client`) serves one
    prompt of about LONG_PROMPT byte tokens together with phase 7's five,
    LONG_MAX_NEW greedy tokens each, with the step graphs on; then twins
    over the same params: graphs off (equal streams), mixed dispatch on
    (W1 over the long row's chunks beside the decode rows; its streams'
    share equal to the split path's is recorded, as phase 14's) and mixed
    with graphs off (equal to mixed on). Reports the long request's TTFT,
    decode seconds a step, peak memory, K1's, K2's and W1's launches, and
    the witness of the long request's first token on the split and the
    mixed path (:func:`first_token_witness`, from the graphs-off runs)."""
    texts = [long_prompt(), *prompts()]
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = long_client(torch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    core = client.core
    n_prompt = len(client._prompt_ids("", texts[0], None))
    if not LONG_PROMPT - 1_000 <= n_prompt <= LONG_SEQ - LONG_MAX_NEW - 1:
        raise AssertionError(f"the long prompt is {n_prompt} tokens")
    res = {"phase": "long_serve", "model": LONG_MODEL, "layers": core.cfg.n_layers,
           "max_seq_len": core.ecfg.max_seq_len, "num_pages": core.ecfg.num_pages,
           "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
           "pool_bytes": core.kv.pool.nbytes(), "table_columns": core.kv.max_pages_per_seq + 1,
           "long_prompt_tokens": n_prompt, "build_s": build_s,
           "graph_capture_s": core.metrics["graph_capture_s"],
           "graph_buckets": len(core._graphs.buckets) if core._graphs else 0,
           "allocated_built": torch.cuda.memory_allocated()}
    on = long_run(torch, client, texts, "long")
    check_long_launches("long", on["launches"], ("paged_decode_attention_fp8",
                                                 "paged_chunk_attention_fp8"))
    if not on["graph_replays"]:
        raise AssertionError("long: step graphs on, but no replay")
    runs = {"graphs": on}
    parts = client_parts(client)
    del client, core
    first_logits = {}
    for name, changes, must in (
            ("graphs_off", dict(step_graphs=False), ("paged_decode_attention_fp8",
                                                     "paged_chunk_attention_fp8")),
            ("mixed", dict(mixed_dispatch=True), ("ragged_plan", "paged_ragged_attention_fp8")),
            ("mixed_graphs_off", dict(mixed_dispatch=True, step_graphs=False),
             ("paged_ragged_attention_fp8",))):
        free_device(torch)
        twin = engine_twin(parts, **changes)
        if changes.get("step_graphs") is False:
            first_logits[name] = record_first_logits(twin.core, n_prompt)
        runs[name] = long_run(torch, twin, texts, f"long {name}")
        check_long_launches(f"long {name}", runs[name]["launches"], must)
        if (runs[name]["graph_replays"] > 0) == (changes.get("step_graphs") is False):
            raise AssertionError(f"long {name}: {runs[name]['graph_replays']} replays")
        if "mixed" in name and not runs[name]["mixed_steps"]:
            raise AssertionError(f"long {name}: mixed dispatch on, but no mixed step ran")
        del twin
    for name, base in (("graphs_off", "graphs"), ("mixed_graphs_off", "mixed")):
        if runs[name]["greedy_tokens"] != runs[base]["greedy_tokens"]:
            raise AssertionError(f"long {name}: other greedy tokens than {base}, first at "
                                 f"{first_divergence(runs[name]['greedy_tokens'], runs[base]['greedy_tokens'])}")
        runs[name][f"same_tokens_as_{base}"] = True
    runs["mixed"]["same_greedy_tokens_as_graphs"] = same_token_share(
        runs["mixed"]["greedy_tokens"], on["greedy_tokens"])
    runs["mixed"]["first_divergence_from_graphs"] = first_divergence(
        runs["mixed"]["greedy_tokens"], on["greedy_tokens"])
    runs["mixed"]["first_token_witness"] = first_token_witness(
        first_logits["graphs_off"]["logits"], first_logits["mixed_graphs_off"]["logits"])
    del first_logits
    for run in runs.values():
        run["long_ttft_ms"] = run["ttft_ms"][0]
        run.pop("greedy_tokens")
    free_device(torch)
    return {**res, **runs}


def long_split_client(torch, tp: int, graphs: bool = True):
    """The long deployment's engine (:func:`long_engine_cfg`) over a pool of
    LONG_SPLIT_PAGES pages at CUT_LAYERS of the 32 layers, bf16 weights over
    the fp8 pool, through ``TorchCudaClient.build``: unsharded (``tp`` 1) or
    on the tp=16 page split with every shard on the one card (8 kv shards x
    2 page shards)."""
    import dataclasses
    from unittest import mock

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models import llama

    cfg = llama.get_config(LONG_MODEL)
    mesh = dict(tp=tp, devices=[f"{DEVICE}:0"] * tp) if tp > 1 else {}
    with mock.patch.dict(llama.CONFIGS, {LONG_MODEL: dataclasses.replace(
            cfg, n_layers=CUT_LAYERS)}):
        return TorchCudaClient.build(LONG_MODEL, device=DEVICE, dtype=torch.bfloat16, seed=0,
                                     engine_cfg=dataclasses.replace(
                                         long_engine_cfg(torch), num_pages=LONG_SPLIT_PAGES),
                                     engine={"step_graphs": graphs},
                                     max_new_tokens=LONG_MAX_NEW, **mesh)


def phase_long_split(torch) -> dict:
    """Phase 25 (c): the long request alone on the tp=16 page split (K4 and
    the chunk partial over fp8 page shards) at CUT_LAYERS layers, step
    graphs on and off, and on the unsharded engine at the same depth: all
    three streams equal; pages of both page shards in use."""
    texts = [long_prompt()]
    runs = {}
    for name, tp, graphs, must in (
            ("unsharded", 1, True, ("paged_decode_attention_fp8", "paged_chunk_attention_fp8")),
            ("page_split", 16, True, FP8_PARTIALS),
            ("page_split_graphs_off", 16, False, FP8_PARTIALS)):
        free_device(torch)
        t0 = time.perf_counter()
        client = long_split_client(torch, tp, graphs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        core = client.core
        pages: set = set()
        alloc = core.kv.allocator.alloc

        def recording_alloc(n, alloc=alloc):
            got = alloc(n)
            pages.update(got)
            return got

        core.kv.allocator.alloc = recording_alloc
        run = long_run(torch, client, texts, f"long {name}")
        check_long_launches(f"long {name}", run["launches"], must)
        run.update(build_s=build_s, graph_capture_s=core.metrics["graph_capture_s"])
        if core.mesh is not None:
            local = core.ecfg.num_pages // core.mesh.seq
            run["pages_allocated_by_shard"] = [sum(1 for p in pages if p // local == s)
                                               for s in range(core.mesh.seq)]
            if not all(run["pages_allocated_by_shard"]):
                raise AssertionError(f"long {name}: a page shard unused")
            run["mesh"] = core.mesh.shape
        runs[name] = run
        del client, core
    want = runs["unsharded"]["greedy_tokens"]
    for name in ("page_split", "page_split_graphs_off"):
        if runs[name]["greedy_tokens"] != want:
            raise AssertionError(f"long {name}: other greedy tokens than the unsharded "
                                 f"engine, first at "
                                 f"{first_divergence(runs[name]['greedy_tokens'], want)}")
    for run in runs.values():
        run["long_ttft_ms"] = run["ttft_ms"][0]
        run.pop("greedy_tokens")
    free_device(torch)
    return {"phase": "long_split", "model": LONG_MODEL, "layers": CUT_LAYERS,
            "same_tokens": True, **runs}


def big_client(torch):
    """llama3-70b-instruct at all 80 layers, int8 weights drawn from seed 0
    on the card (``init_params_quantized``), through
    ``TorchCudaClient.from_config`` on an ``llm`` block: a bf16 pool of
    ``num_pages`` taken from ``plan_serving``'s budget on this card less
    BIG_POOL_MARGIN, ``max_seq_len`` 8,192, 8 slots, byte tokenizer.
    Returns (client, plan, pages)."""
    from runbookai_tpu_torch.engine.memory_plan import plan_serving
    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.utils.config import LLMConfig

    plan = plan_serving(get_config(BIG_MODEL), 8192, batch=8, weights="int8",
                        kv_dtype_bytes=2,
                        hbm_bytes=torch.cuda.get_device_properties(0).total_memory)
    pages = int((plan.pool_budget_bytes - BIG_POOL_MARGIN)
                // (PS * plan.kv_bytes_per_token_per_chip))
    if pages < BIG_MIN_PAGES:
        raise AssertionError(f"70B: the plan leaves {pages} pages: {plan.explain()}")
    llm = LLMConfig(provider="jax-tpu", model=BIG_MODEL, dtype="int8", max_seq_len=8192,
                    num_pages=pages, max_batch_slots=8, max_new_tokens=BIG_MAX_NEW)
    return TorchCudaClient.from_config(llm, device=DEVICE), plan, pages


def big_decode_profile(torch, client) -> dict:
    """Device time of a decode window on ``client``'s engine, stepped in this
    thread: phase 7's prompts prefilled, then BIG_PROFILE_STEPS engine steps
    (speculation off) under the profiler, by kernel class (K5 is ``qmm``),
    and the window's decode steps."""

    from runbookai_tpu_torch.engine.request import EngineRequest

    core = client.core
    speculative, core.ecfg.speculative = core.ecfg.speculative, False
    for u in prompts():
        core.submit(EngineRequest(prompt_ids=client._prompt_ids("", u, None),
                                  sampling=client._sampling()))
    while core.waiting or core.prefilling:
        core.step()
    steps = core.metrics["decode_steps"]
    torch.cuda.synchronize()
    reset_counts()
    with profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(BIG_PROFILE_STEPS):
            core.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    steps = core.metrics["decode_steps"] - steps
    core.run_until_idle()
    core.ecfg.speculative = speculative
    classes, by_name = device_time_by_class(torch, prof, launched, "70B profile")
    busy = sum(v[0] for v in classes.values())
    if not busy or "qmm" not in classes:
        raise AssertionError(f"70B profile: no K5 in the decode window: {classes}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"decode_steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "qmm_ms": classes["qmm"][0], "other_ms": busy - classes["qmm"][0],
            "qmm_ms_per_step": classes["qmm"][0] / max(1, steps),
            "by_class_ms": {k: v[0] for k, v in sorted(classes.items())},
            "kernels_by_class": {k: v[1] for k, v in sorted(classes.items())},
            "top_kernels_ms": {n[:120]: ms for n, ms in top}}


def phase_big(torch) -> dict:
    """Phase 25 (d): llama3-70b-instruct int8 at all 80 layers on the card
    (:func:`big_client`): its weight bytes must equal ``plan_serving``'s;
    phase 7's five requests, BIG_MAX_NEW greedy tokens each, with the step
    graphs on (K5, K1 and K2 must launch; tokens a second, decode seconds a
    step, TTFT, peak memory), one profiled decode window (device time: K5
    and the rest), then the same five on a graphs-off twin over the same
    params: equal streams."""
    from runbookai_tpu_torch.models.quant import weight_bytes

    free_device(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client, plan, pages = big_client(torch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    core = client.core
    w_bytes = weight_bytes(core.params)
    if plan.weight_bytes_per_chip != w_bytes:
        raise AssertionError(f"70B: plan_serving counts {plan.weight_bytes_per_chip} B of "
                             f"weights, the tree holds {w_bytes}")
    res = {"phase": "big_serve", "model": BIG_MODEL, "layers": core.cfg.n_layers,
           "dtype": "int8", "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
           "weight_bytes": w_bytes, "plan_weight_bytes": plan.weight_bytes_per_chip,
           "plan_pool_budget_bytes": plan.pool_budget_bytes, "pool_margin": BIG_POOL_MARGIN,
           "num_pages": pages, "pool_bytes": core.kv.pool.nbytes(),
           "hbm_bytes": plan.hbm_bytes, "allocated_before": before,
           "allocated_built": torch.cuda.memory_allocated() - before,
           "reserved_built": torch.cuda.memory_reserved(), "build_s": build_s,
           "graph_capture_s": core.metrics["graph_capture_s"],
           "graph_buckets": len(core._graphs.buckets) if core._graphs else 0}
    texts = prompts()
    reset_counts()
    on = serve_texts(client, texts, BIG_MAX_NEW, "70B")
    launched = counts()
    if not all(launched[k] for k in ("qmm_int8", "paged_decode_attention",
                                     "paged_chunk_attention")):
        raise AssertionError(f"70B: K5, K1 or K2 never launched: {launched}")
    free_after, total = torch.cuda.mem_get_info()
    res.update({**on, "launches": {k: n for k, n in launched.items() if n},
                "device_free_after_serve": free_after, "device_total": total,
                "graph_replays": core.metrics["graph_replays"],
                "decode_forward_ms": forward_replay_ms(torch, core),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved()})
    res["profile"] = big_decode_profile(torch, client)
    parts = client_parts(client)
    del client, core
    free_device(torch)
    twin = engine_twin(parts, step_graphs=False)
    del parts
    off = serve_texts(twin, texts, BIG_MAX_NEW, "70B graphs off")
    if twin.core.metrics["graph_replays"] or off["greedy_tokens"] != on["greedy_tokens"]:
        raise AssertionError(f"70B: graphs off gave other greedy tokens, first at "
                             f"{first_divergence(off['greedy_tokens'], on['greedy_tokens'])}")
    res["graphs_off"] = {k: off[k] for k in ("wall_s", "tokens_per_s", "decode_s_per_step",
                                             "ttft_ms")}
    res["same_tokens_graphs_off"] = True
    res.pop("greedy_tokens")
    del twin
    free_device(torch)
    return res


def long_phases(pa, torch) -> dict:
    """Phase 25: the kernel cases at the long table, at a group of 8 and K5
    at the 70B's shapes, then the long deployment, its page split and the
    70B. Returns the kernel cases and the serving runs' launches."""
    out = {}
    for key, phase in (("long", lambda: phase_long_kernels(pa, torch)),
                       ("group8", lambda: phase_group8_kernels(pa, torch)),
                       ("qmm", lambda: phase_qmm_big(torch)),
                       ("serve", lambda: phase_long_serve(torch)),
                       ("split", lambda: phase_long_split(torch)),
                       ("big", lambda: phase_big(torch))):
        out[key] = phase()
        emit(out[key])
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from runbookai_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    OUT_DIR.mkdir(exist_ok=True)
    if sys.argv[1:2] == ["--serve-ab"]:
        return serve_ab(Path(sys.argv[2]).resolve(), sys.argv[3:] or ["bfloat16", "int8"])
    if sys.argv[1:2] == ["--kernel-ab"]:
        return kernel_ab(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--streams-ab"]:
        return streams_ab(Path(sys.argv[2]).resolve(), sys.argv[3:] or [
            "bfloat16", "int8", "mixed", "bfloat16:overlap_off", "kv_split"])
    if sys.argv[1:2] == ["--forward-ab"]:
        return forward_ab(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--profiler-clock"]:
        faulthandler.dump_traceback_later(float(sys.argv[2]) + 120, exit=True)
        _LOG.write_text("")
        return profiler_clock_run(torch, float(sys.argv[2]))
    if sys.argv[1:2] == ["--overlap-ab"]:
        print(json.dumps(phase_build()), flush=True)
        return overlap_ab()
    faulthandler.dump_traceback_later(WATCHDOG_S - (time.perf_counter() - _START), exit=True)
    _LOG.write_text("")
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    emit(phase_build())
    if sys.argv[1:2] == ["--agent"]:
        agent_phases(torch)
        return 0
    if sys.argv[1:2] == ["--knowledge"]:
        knowledge_phases(torch)
        return 0
    if sys.argv[1:2] == ["--eval"]:
        eval_phases(torch)
        return 0
    if sys.argv[1:2] == ["--serve"]:
        serve_phases(torch)
        return 0
    if sys.argv[1:2] == ["--lora"]:
        lora_draft_phases(torch)
        return 0
    if sys.argv[1:2] == ["--moe"]:
        moe_phases(torch)
        return 0
    if sys.argv[1:2] == ["--train"]:
        train_phases(torch)
        return 0
    if sys.argv[1:2] == ["--long"]:
        emit(phase_profiler_clock(torch, "start"))
        long_phases(pa, torch)
        emit(phase_profiler_clock(torch, "end"))
        return 0
    # The profiler's clocks at the start and at the end of the run.
    emit(phase_profiler_clock(torch, "start"))
    dec = phase_decode(pa, torch)
    emit(dec)
    chk = phase_chunk(pa, torch)
    emit(chk)
    dec8 = phase_decode(pa, torch, int8=True)
    emit(dec8)
    chk8 = phase_chunk(pa, torch, int8=True)
    emit(chk8)
    rag = phase_ragged(pa, torch)
    emit(rag)
    # fp8 (e4m3) pools: the write on the card against the CPU's, then K1, K2
    # and W1 over fp8 pages on the inputs of phases 2, 3 and 13.
    emit(phase_fp8_cast(torch))
    dec_f8 = phase_decode_fp8(pa, torch)
    emit(dec_f8)
    chk_f8 = phase_chunk_fp8(pa, torch)
    emit(chk_f8)
    rag_f8 = phase_ragged_fp8(pa, torch)
    emit(rag_f8)
    qmm = phase_qmm(torch)
    emit(qmm)
    # Long contexts and the 70B (phase 25), here beside the kernel phases:
    # late in a full run the profiler records no device event, and its
    # kernel checks need one. The kernels at a 2,049-column table, at a GQA
    # group of 8 and K5 at the 70B's shapes; llama3.1-8b at 32k over an fp8
    # pool, its tp=16 page split, llama3-70b int8 at 80 layers.
    long = long_phases(pa, torch)
    emit(phase_forward(torch))
    emit(phase_forward_int8(torch))
    # Serving with the step graphs on (the default), each configuration's
    # graphs-off run beside it: equal greedy streams, and the same profile
    # for bf16 (launch calls a decode forward, idle share).
    eng = phase_engine(torch)
    emit(served_line(eng))
    emit(served_line(phase_graphs_off(torch, "bfloat16", eng)))
    # The profiled reruns and the witnesses at CUT_LAYERS of the 32 layers.
    prof = phase_profile(torch, layers=CUT_LAYERS)
    emit(prof)
    prof_off = phase_profile(torch, graphs=False, layers=CUT_LAYERS)
    prof_off["idle_share_graphs_on"] = prof["idle_share"]
    emit(prof_off)
    eng8 = phase_engine(torch, weights="int8")
    emit(served_line(eng8))
    emit(served_line(phase_graphs_off(torch, "int8", eng8)))
    # int8's at full depth: at CUT_LAYERS its profile held no K5 call on
    # one of the two tensor-core routes that it must show.
    emit(phase_profile(torch, weights="int8"))
    emit(phase_witness(torch, pa, "bfloat16", eng, layers=CUT_LAYERS))
    emit(phase_witness(torch, pa, "int8", eng8, layers=CUT_LAYERS))
    # bf16 weights over an fp8 pool: half of phase 7's pool bytes, the fp8
    # instantiations only (counts and profile), every K1/K2 call witnessed.
    eng_f8 = phase_engine(torch, weights="fp8")
    if eng_f8["pool_bytes"] * 2 != eng["pool_bytes"]:
        raise AssertionError(f"fp8 pool {eng_f8['pool_bytes']} B, bf16 pool "
                             f"{eng['pool_bytes']} B: not half")
    eng_f8["same_greedy_tokens_as_engine"] = same_token_share(
        eng_f8["greedy_tokens"], eng["greedy_tokens"])
    emit(served_line(eng_f8))
    emit(served_line(phase_graphs_off(torch, "fp8", eng_f8)))
    emit(phase_profile(torch, weights="fp8", layers=CUT_LAYERS))
    emit(phase_witness(torch, pa, "fp8", eng_f8, modes=("kernel",), layers=CUT_LAYERS))
    # Mixed dispatch on (bf16): W1 on the main path, its launches counted,
    # its calls witnessed. Not gated on the streams: the ragged blocks and
    # the split path round bf16 at other places.
    mixed = phase_engine(torch, weights="mixed")
    mixed["same_greedy_tokens_as_engine"] = same_token_share(
        mixed["greedy_tokens"], eng["greedy_tokens"])
    mixed["first_divergence_from_engine"] = first_divergence(
        mixed["greedy_tokens"], eng["greedy_tokens"])
    emit(served_line(mixed))
    emit(served_line(phase_graphs_off(torch, "mixed", mixed)))
    emit(phase_profile(torch, weights="mixed", layers=CUT_LAYERS))
    emit(phase_witness(torch, pa, "mixed", mixed, layers=CUT_LAYERS))
    # Mixed dispatch over an fp8 pool: W1's fp8 instantiation on the main path.
    mixed_f8 = phase_engine(torch, weights="mixed_fp8")
    emit(served_line(mixed_f8))
    emit(served_line(phase_graphs_off(torch, "mixed_fp8", mixed_f8)))
    # The overlapped pipeline off (bf16): the greedy streams must equal the
    # overlapped run's wherever both issued the same forwards.
    off = phase_engine(torch, overlap=False)
    same = off["dispatches"] == eng["dispatches"]
    off["same_dispatches_as_engine"] = same
    off["first_divergence_from_engine"] = first_divergence(off["greedy_tokens"],
                                                           eng["greedy_tokens"])
    if same and off["first_divergence_from_engine"] is not None:
        raise AssertionError(f"overlap off: same forwards as the overlapped run, other "
                             f"greedy tokens at {off['first_divergence_from_engine']}")
    emit(served_line(off))
    emit(served_line(phase_graphs_off(torch, "bfloat16", off, overlap=False)))
    off_prof = phase_profile(torch, overlap=False, layers=CUT_LAYERS)
    off_prof["idle_share_overlap_on"] = prof["idle_share"]
    emit(off_prof)
    # Guided JSON at the JAX client's defaults (bf16): the orchestrator's
    # completions beside chats and the sampling extras, then the guided
    # completions with grammar fast-forward, the profiled rerun and the
    # witness of every K1 and K2 call.
    guided = phase_guided(torch)
    emit(guided_line(guided))
    guided_off = phase_guided(torch, graphs=False)
    if guided_off["greedy_tokens"] != guided["greedy_tokens"]:
        raise AssertionError("guided serving: graphs off gave other documents or streams "
                             "than graphs on")
    guided_off["same_tokens_as_graphs"] = True
    emit(guided_line(guided_off))
    emit(guided_line(phase_guided(torch, fast_forward=True, extras=False)))
    guided_prof = phase_guided_profile(torch, layers=CUT_LAYERS)
    guided_prof["idle_share_engine"] = prof["idle_share"]
    emit(guided_prof)
    emit(phase_witness(torch, pa, "bfloat16", guided,
                       run=lambda: phase_guided(torch, graphs=False, layers=CUT_LAYERS),
                       name="engine_guided_witness", modes=("kernel",)))
    # `investigate` and `ask` through the port's CLI (phase 18), graphs on
    # and off: the same output byte for byte.
    agent_phases(torch)
    # The knowledge path (phase 19): the bge encoder beside the 8B, sync and
    # search, and the agent over the knowledge base, graphs on and off.
    knowledge_phases(torch)
    # The eval suite (phase 20): live investigations sharing the engine's
    # decode steps at full depth, then the one-case eval, graphs on and off.
    eval_phases(torch)
    # `serve` (phase 21): the OpenAI-compatible server at full depth under
    # concurrent HTTP load, then its solo requests with graphs on and off.
    serve_phases(torch)
    # Multi-LoRA serving and draft-model speculation (phase 22), with K1's
    # and K2's launches read around it.
    lora_draft = lora_draft_phases(torch)
    # Mixtral (phase 23): moe_ffn at its widths, bf16 at 8 layers and the
    # int8 deployment at 32, each graphs on and off; K1, K2 and K5 counted.
    moe = moe_phases(torch)
    # Fine-tuning and checkpoints (phase 24): the 8B's LoRA published into its
    # live engine, the 1B's full fine-tune restored from its checkpoint, and
    # chat --raw; K1's and K2's launches read around their serving runs.
    train = train_phases(torch)
    decp = phase_decode_partial(pa, torch)
    emit(decp)
    chkp = phase_chunk_partial(pa, torch)
    emit(chkp)
    part_f8 = phase_partial_fp8(pa, torch)
    emit(part_f8)
    emit(phase_forward_tp(torch))
    # The mesh serving phases at CUT_LAYERS of the 32 layers.
    split = phase_engine(torch, weights="kv_split", layers=CUT_LAYERS)
    emit(served_line(split))
    emit(served_line(phase_graphs_off(torch, "kv_split", split)))
    emit(phase_profile(torch, weights="kv_split", layers=CUT_LAYERS))
    emit(phase_witness(torch, pa, "kv_split", split, layers=CUT_LAYERS))
    # The page split over fp8 page shards: the fp8 K4 and chunk partial.
    split_f8 = phase_engine(torch, weights="kv_split_fp8", layers=CUT_LAYERS)
    if split_f8["pool_bytes"] * 2 != split["pool_bytes"]:
        raise AssertionError(f"fp8 page-split pool {split_f8['pool_bytes']} B, bf16 "
                             f"{split['pool_bytes']} B: not half")
    emit(served_line(split_f8))
    emit(served_line(phase_graphs_off(torch, "kv_split_fp8", split_f8)))
    # A tensor-parallel mesh over fp8 pool shards (tp=8: heads only).
    tp8 = phase_engine(torch, weights="tp8_fp8", layers=CUT_LAYERS)
    emit(served_line(tp8))
    emit(served_line(phase_graphs_off(torch, "tp8_fp8", tp8)))

    mma_src = "runbookai_tpu_torch/csrc/chunk_attention.cu"
    dec_src = "runbookai_tpu_torch/csrc/decode_attention.cu"
    pallas = "runbookai_tpu/ops/paged_attention_pallas.py"
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timing = ("device_ms", "graph_ms", "host_ms", "splits", "cold_ms")
    kernels = []
    # K1 and K3 for bf16 queries: the tensor-core kernel over bf16 and int8
    # pools, on the decode input, at head_dim 64 ("hd64") and, for K1, at
    # the served contexts ("served"); f32 queries take the CUDA-core kernel.
    for name, res, served, replaces in (
            ("paged_decode_attention", dec, eng, f"{pallas}:188"),
            ("paged_decode_attention_int8", dec8, eng8, f"{pallas}:240")):
        main_path = res["bfloat16"]
        subs = [x for x in ("served", "hd64") if x in main_path]
        kernels.append({"name": name, "route": "cuda", "source": dec_src,
                        "replaces": replaces, "launches": served["launches"][name],
                        "lora_draft_launches": lora_draft.get(name, 0),
                        "moe_launches": moe.get(name, 0),
                        "train_launches": train.get(name, 0),
                        "max_abs_err": max(main_path["max_abs_err"],
                                           *(main_path[x]["max_abs_err"] for x in subs)),
                        "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
                        **{f: main_path[f] for f in fields + timing},
                        **{x: {f: main_path[x][f] for f in fields + timing} for x in subs}})
    # K2 for bf16 queries: the tensor-core kernel, over bf16 pools and over
    # int8 pools (whose T > 1 calls the JAX package serves on its XLA gather
    # path).
    for name, res, served in (("paged_chunk_attention", chk, eng),
                              ("paged_chunk_attention_int8", chk8, eng8)):
        main_path = res["bfloat16"]
        kernels.append({"name": name, "route": "cuda", "source": mma_src,
                        "replaces": f"{pallas}:397", "launches": served["launches"][name],
                        "lora_draft_launches": lora_draft.get(name, 0),
                        "moe_launches": moe.get(name, 0),
                        "train_launches": train.get(name, 0),
                        "max_abs_err": main_path["max_abs_err"],
                        "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
                        **{f: main_path[f] for f in fields + ("device_ms", "graph_ms",
                                                               "cold_ms")},
                        "splits": main_path["splits"],
                        **{kind: main_path[kind] for kind in MMA_KINDS
                           if kind in main_path and kind != "prefill"}})
    # W1: the ragged kernel's per-layer launch on the mixed batch, at the
    # served contexts; the long-context, int8-pool and other geometries'
    # inputs beside it, and K2's one-row prefill of the same 512 tokens.
    # Launches from engine_mixed.
    rag_keys = ("max_abs_err", "pad_max_abs", "launches_per_call", "splits", "tiles",
                "ms", "device_ms", "graph_ms", "cold_ms", "host_ms", "call_device_ms",
                "plain_ms",
                "bound_ms", "bound_by", "library_ms")
    kernels.append({"name": "paged_ragged_attention", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/ragged_attention.cu",
                    "replaces": f"{pallas}:468",
                    "launches": mixed["launches"]["paged_ragged_attention"],
                    **{f: rag["served"][f] for f in rag_keys},
                    "max_abs_err": rag["max_abs_err"],
                    **{kind: {f: rag[kind][f] for f in rag_keys}
                       for kind in ("long", "int8", *RAGGED_GEOMETRIES)},
                    "k2_one_row_prefill": rag["k2_one_row_prefill"]})
    # W1's tile list, one launch a mixed forward, on the same batches; its
    # plain version is the tensor-op list on the card. Launches from
    # engine_mixed.
    plan_keys = ("max_abs_err", "live", "ms", "device_ms", "graph_ms", "cold_ms", "host_ms",
                 "plain_ms", "plain_device_ms", "plain_host_ms", "bound_ms", "bound_by",
                 "library_ms")
    kernels.append({"name": "ragged_plan", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/ragged_plan.cu",
                    "replaces": f"{pallas}:468", "launches": mixed["launches"]["ragged_plan"],
                    **{f: rag["served"]["plan"][f] for f in plan_keys},
                    "max_abs_err": max(rag[kind]["plan"]["max_abs_err"]
                                       for kind in (*RAGGED_KINDS, "int8", *RAGGED_GEOMETRIES)),
                    **{kind: {f: rag[kind]["plan"][f] for f in plan_keys}
                       for kind in ("long", *RAGGED_GEOMETRIES)}})
    # The second pass of a split K2 call, on the verify input's partials.
    merge = chk["bfloat16"]["merge"]
    kernels.append({"name": "paged_chunk_merge", "route": "cuda", "source": mma_src,
                    "replaces": f"{pallas}:397", "launches": eng["launches"]["paged_chunk_merge"],
                    "launches_int8": eng8["launches"]["paged_chunk_merge"],
                    "launches_fp8": eng_f8["launches"]["paged_chunk_merge"],
                    "lora_draft_launches": lora_draft.get("paged_chunk_merge", 0),
                    "moe_launches": moe.get("paged_chunk_merge", 0),
                    "train_launches": train.get("paged_chunk_merge", 0),
                    "max_abs_err": max(merge["max_abs_err"],
                                       chk8["bfloat16"]["merge"]["max_abs_err"]),
                    **{f: merge[f] for f in fields + ("device_ms", "graph_ms", "cold_ms")},
                    "splits": merge["splits"]})
    # The page-split partial kernels per call as the tp=16 path makes them
    # (one model group's heads over one page shard), the mean over both page
    # shards' calls; launches from engine_kv_split, one call per shard and
    # layer in every forward. library_ms: memory-efficient SDPA with its
    # log-sum-exp over the shard's keys gathered beforehand. bf16 partials
    # run on the tensor-core kernels (K4 decode_attention.cu's, the chunk
    # partial chunk_attention.cu's), f32 queries on the CUDA-core kernel.
    part_fields = fields + ("device_ms", "graph_ms", "host_ms", "cold_ms")
    for name, res, replaces, source in (
            ("paged_decode_attention_partial", decp, f"{pallas}:567", dec_src),
            # The JAX package runs T > 1 page-split attention on XLA.
            ("paged_chunk_attention_partial", chkp,
             "runbookai_tpu/parallel/kv_split.py:104", mma_src)):
        main_path = res["bfloat16"]["served"]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": split["launches"][name],
               "calls_per_forward": split["calls_per_forward"],
               "max_abs_err": res["bfloat16"]["max_abs_err"],
               "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
               **{f: main_path[f] for f in part_fields}, "splits": main_path["splits"],
               "q": main_path["q"], "kv_local": main_path["kv_local"]}
        for kind in ("verify", "verify_one_shard", "verify_hd64", "hd64"):
            if kind in res["bfloat16"]:
                case = res["bfloat16"][kind]["served"]
                row[kind] = {**{f: case[f] for f in part_fields}, "splits": case["splits"],
                             "q": case["q"], "max_abs_err": case["max_abs_err"]}
        kernels.append(row)
    # The fp8 instantiations (bf16 queries over fp8 pools, widened in shared
    # memory): K1 on the decode input, also at the served contexts and head_dim
    # 64; K2 on the prefill, the verify and the one-row prefill; W1 on the
    # served mixed batch; K4 and the chunk partial at the tp=16 call's shape.
    # Launches from engine_fp8, engine_mixed_fp8 and engine_kv_split_fp8; each
    # equal to its bf16 instantiation over the widened pool.
    f8 = dec_f8["bfloat16"]
    kernels.append({"name": "paged_decode_attention_fp8", "route": "cuda", "source": dec_src,
                    "replaces": f"{pallas}:188", "launches": eng_f8["launches"][
                        "paged_decode_attention_fp8"],
                    "max_abs_err": max(f8["max_abs_err"], f8["served"]["max_abs_err"],
                                       f8["hd64"]["max_abs_err"]),
                    "f32_cuda_core_max_abs_err": dec_f8["float32"]["max_abs_err"],
                    **{f: f8[f] for f in fields + timing},
                    **{x: {f: f8[x][f] for f in fields + timing} for x in ("served", "hd64")}})
    f8 = chk_f8["bfloat16"]
    kernels.append({"name": "paged_chunk_attention_fp8", "route": "cuda", "source": mma_src,
                    "replaces": f"{pallas}:397", "launches": eng_f8["launches"][
                        "paged_chunk_attention_fp8"],
                    "max_abs_err": f8["max_abs_err"],
                    "f32_cuda_core_max_abs_err": chk_f8["float32"]["max_abs_err"],
                    **{f: f8[f] for f in fields + ("device_ms", "graph_ms", "cold_ms",
                                                   "splits")},
                    **{kind: {f: f8[kind][f] for f in fields + ("device_ms", "graph_ms",
                                                                "cold_ms", "splits")}
                       for kind in ("verify", "prefill_one_row")}})
    f8 = rag_f8["served"]
    kernels.append({"name": "paged_ragged_attention_fp8", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/ragged_attention.cu",
                    "replaces": f"{pallas}:468",
                    "launches": mixed_f8["launches"]["paged_ragged_attention_fp8"],
                    **{f: f8[f] for f in rag_keys}})
    for name, kind, replaces, source in (
            ("paged_decode_attention_partial_fp8", "decode", f"{pallas}:567", dec_src),
            ("paged_chunk_attention_partial_fp8", "chunk_prefill",
             "runbookai_tpu/parallel/kv_split.py:104", mma_src)):
        f8 = part_f8[kind]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": split_f8["launches"][name], "max_abs_err": f8["max_abs_err"],
               **{f: f8[f] for f in part_fields}, "splits": f8["splits"], "q": f8["q"],
               "kv_local": f8["kv_local"]}
        if kind == "chunk_prefill":
            case = part_f8["chunk_verify"]
            row["verify"] = {**{f: case[f] for f in part_fields}, "splits": case["splits"],
                             "max_abs_err": case["max_abs_err"]}
        kernels.append(row)
    # K5 per decode layer: the sum over its seven products at M=8 (and, under
    # "verify", at M=64), each timed on rotating layer slices. Every timed
    # call reads its weights from outside the 50 MB L2 (32 slices of 4 to
    # 58.7 MB), so the device time is also the cold time.
    qmm_rows = {key: {**row, "cold_ms": row["ms"]} for key, row in qmm["per_layer"].items()}
    kernels.append({"name": "qmm_int8", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/qmm.cu",
                    "replaces": "runbookai_tpu/ops/qmm_pallas.py:83",
                    "launches": eng8["launches"]["qmm_int8"],
                    "moe_launches": moe.get("qmm_int8", 0),
                    "max_abs_err": qmm["max_abs_err"],
                    "f32_cuda_core_max_abs_err": qmm["f32_cuda_core_max_abs_err"],
                    **qmm_rows["decode"], "verify": qmm_rows["verify"],
                    "splits": {f"{c}@{m}": qmm["cases"][f"{m}x{k}x{n}"]["splits"]
                               for m in (8, 64) for c, (k, n) in QMM_SHAPES.items()}})
    # Phase 25's cases beside each row: at the 2,049-column table
    # ("ctx32k", "prefill_32k": K2's and W1's), at the 70B's group of 8 ("group8*") and K5
    # at the 70B's shapes; launches of the long deployment's runs (graphs on,
    # mixed, the page split) and of the 70B's ("long_launches",
    # "big_launches").
    def pick(case, keys):
        return {f: case[f] for f in keys if f in case}

    case_keys = fields + timing + ("max_abs_err", "q", "kv_local", "tiles")
    lk, g8, big = long["long"], long["group8"], long["big"]["launches"]
    serve_on, mixed_on = long["serve"]["graphs"]["launches"], long["serve"]["mixed"]["launches"]
    split_on = long["split"]["page_split"]["launches"]
    extra = {
        "paged_decode_attention": {"ctx32k": lk["decode"], "group8": g8["decode"],
                                   "big_launches": big.get("paged_decode_attention", 0)},
        "paged_decode_attention_int8": {"group8": g8["decode_int8"]},
        "paged_chunk_attention": {"prefill_32k": lk["chunk"],
                                  "group8_prefill": g8["chunk_prefill"],
                                  "group8_verify": g8["chunk_verify"],
                                  "big_launches": big.get("paged_chunk_attention", 0)},
        "paged_chunk_attention_int8": {"group8_prefill": g8["chunk_int8_prefill"],
                                       "group8_verify": g8["chunk_int8_verify"]},
        "paged_ragged_attention": {"ctx32k": lk["ragged"], "group8": g8["ragged"],
                                   "prefill_32k": lk["ragged_prefill32k"]},
        "paged_chunk_merge": {"big_launches": big.get("paged_chunk_merge", 0),
                              "long_launches": serve_on.get("paged_chunk_merge", 0)},
        "paged_decode_attention_partial": {"ctx32k": lk["decode_partial"]},
        "paged_decode_attention_fp8": {"ctx32k": lk["decode_fp8"], "long_launches": serve_on.get(
            "paged_decode_attention_fp8", 0)},
        "paged_chunk_attention_fp8": {"prefill_32k": lk["chunk_fp8"], "long_launches":
                                      serve_on.get("paged_chunk_attention_fp8", 0)},
        "paged_ragged_attention_fp8": {"prefill_32k": lk["ragged_prefill32k_fp8"],
                                       "long_launches": mixed_on.get(
                                           "paged_ragged_attention_fp8", 0)},
        "paged_decode_attention_partial_fp8": {"long_launches": split_on.get(
            "paged_decode_attention_partial_fp8", 0)},
        "paged_chunk_attention_partial_fp8": {"long_launches": split_on.get(
            "paged_chunk_attention_partial_fp8", 0)},
        "qmm_int8": {"llama3_70b": long["qmm"]["per_layer"],
                     "llama3_70b_max_abs_err": long["qmm"]["max_abs_err"],
                     "big_launches": big.get("qmm_int8", 0)},
    }
    for row in kernels:
        for key, val in extra.get(row["name"], {}).items():
            row[key] = pick(val, case_keys) if isinstance(val, dict) and "ms" in val else val
        if row["name"] == "ragged_plan":
            row["ctx32k"] = pick(lk["ragged"]["plan"], plan_keys)
            row["prefill_32k"] = pick(lk["ragged_prefill32k"]["plan"], plan_keys)
    emit(phase_profiler_clock(torch, "end"))
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
