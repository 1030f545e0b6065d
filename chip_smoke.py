#!/usr/bin/env python3
"""Smoke run of the lotus_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds and the card's name and power limit):
1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``lotus_tpu_torch/csrc`` with nvcc,
   one process per source, all started together; report each K1, K2 and
   K3 kernel's registers, spills, wgmma advisories and HGMMA / IGMMA /
   UTMALDG counts, and fail if a tensor-core kernel has none of its type's
   MMA;
3. config 4 build: the seeded 10 * 2**20 x 768 corpus, IVF with nlist 4096,
   residual int8 + int4 refinement, block-aligned at 1024, exact f32 oracle;
4. K1 vs plain: K1 (``probe_fold``) against ``probe_fold_reference`` on
   the card for each variant, with the route each took — int8-dot packed
   (and under the top-1 fold) and int8 store with bf16 queries at the
   config-4 shape of one 2048-query slice, the first two timed beside their
   bound (``k1_bound``) and the plain version; bf16 packed, f32 unpacked,
   bf16 l2 and f16 rows under f32 queries (packed and unpacked, the latter
   timed) on the first 512 lists at full width; the int8 dot at d 770 and
   66 over the same lists (ragged last words; packed and unpacked, bit for
   bit, d 770 packed timed); and int8 over a window past 8192 rows
   (unpacked, top-2 and top-1 folds);
5. IVF main path: ``ivf_search_grouped_probe`` at nprobe 208, rescore 24,
   int8 queries, query_chunk 2048 over B = 4096; recall@10 against the
   exact f32 oracle must reach 0.99, and K3 must run once a slice; QPS over
   chained batches; the capacity model (``ops/capacity.py``) must equal the
   served state's bytes.  Before it, K3 (``pool_select``) against
   ``pool_select_reference`` on the inputs the main path gives it in its
   first slice (scores bit for bit, rows equal as sets across equal
   scores), both timed beside K3's bound (``k3_bound``);
6. window probe over config 4's store (``ops/ivf.py::ivf_search``) at the
   reference's small-batch setting (nprobe 208, rescore 24) for B = 1, 16
   and 64: recall@10 over 64 queries must reach 0.99 at each B; ms per call
   beside K1's grouped probe at the same B; the query chunks and slot groups
   of the gather budget; the transient peak (``max_memory_allocated`` over
   what was allocated before the call), which must stay within the budget
   plus ``PEAK_MARGIN`` at every B (B 64 is the shape that crashed the
   reference's worker); then B 16 under a 1 GiB budget, which must cut each
   query's probe slots into groups and return the same top-10 sets;
7. IVF store: ``TorchVS`` indexes 262,144 x 768 seeded vectors (nlist 256,
   block-aligned) and serves a search without ids (through K1) and one
   with ids (only allowed ids come back);
8. calibration through K1: ``calibrate_nprobe(0.95, k=10, nq=256,
   oracle="exact")`` on phase 7's store walks its ladder through the
   grouped probe (K1 launches > 0); a fresh store adopts the persisted entry
   without launching K1; an entry with the grouped regime dropped sends
   B 1 to the window probe (no K1 launch) and B 256 to the exhaustive scan;
9. config 4 with ids: ``TorchVS._ivf_subset_search`` (the path the pandas
   operators take) at |ids| = 2**16, B 1 and 256: device ms, transient peak
   beside the capacity model's, only allowed ids back;
10. IVF exhaustive scan: K2 against its plain version on the inputs
   ``ivf_residual_scan`` gives it (bf16 queries, the q.c bias plane and the
   row mask over the whole config-4 store at B = 256), both timed; then
   ``ivf_residual_scan`` at rescore 64, whose recall@10 must reach 0.99;
11. stage breakdown of one config-4 slice (CUDA events per stage);
12. BASELINE config 5's lifecycle on 4 ranks sharing the card: the parent
   writes config 4's store as 4 shards (``save_ivf_shards``, planned on the
   card; the free disk first), frees it, and starts 4 ranks of this script
   as ``torchrun`` would (``--rank``: ``MASTER_ADDR``, a free
   ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), all on
   ``cuda:0`` under gloo, each through ``init_runtime()``.  Each rank loads
   only its shard (resident bytes equal to the plan's) and runs
   ``sharded_ivf_search_pallas`` on config 4's queries (nprobe 208, rescore
   24, int8 queries, query_chunk 2048).  Every rank's top-10 sets must equal
   those of the same 4 shards searched in this process before the store was
   freed, K1 must launch on every rank, no id may come back from two ranks'
   local top-10, every local candidate must lie in a list its rank owns, and
   recall@10 against exact f32 must reach 0.95 (the reference's sharded
   gate: its shards rescore with no int4 refinement), printed beside phase
   5's (with the refinement) and the single device's without it.  Chained
   QPS, the merge's all-gathers' ms per batch and one small all-gather's,
   labelled as 4 ranks sharing one card.  Then
   ``TorchVS(mesh=...)`` on the window-regime store of phase 14
   (``index()`` writes the shards, every rank loads): B 1 and 8 through the sharded window probe, B 64
   through the sharded scan, each equal to a single-device store's sets; an
   ids search through ``_disk_subset_search`` and a Flat store with a mesh,
   with ids and without, against exact f32.  Last, ``sharded_kmeans_fit``
   at config 3's shape (1,000,000 x 768, k 1024, 10 iterations), whose
   Lloyd step from the same centroids must equal one process's on the card
   (counts exactly, sums within 1e-4 * (1 + |x|)).  A rank that finds no
   card, or fails, fails the phase;
13. config 4 at spill_frac 0.05, built once phases 3-12's store is freed:
   build seconds per phase, spilled copies, peak memory, recall@10 (must
   reach 0.99), QPS, K1 ms per slice beside the unspilled run; no top-10
   repeats an id; every row's ``ivf_inv_perm`` slot lies in its top-1 list;
   the capacity model against the state's bytes, and the most rows each
   encoding holds on this card;
14. the reference's window-regime store: 200,000 x 768 seeded rows,
   ``TorchVS(index_type="ivf", nlist=512, nprobe=32)`` as float32 and as
   residual int8 with int4 refinement and rescore 24; ``index()`` leaves
   both unaligned; B 1 and 8 go through the window probe, B 64 through the
   exhaustive scan (counted by route, no K1 launch), with recall@10 against
   exact f32 and the warm ms per call; ``ivf_search`` on the float32 store
   at B 1, 16 and 64 with its transient peak; ``calibrate_nprobe(0.95,
   oracle="exact")`` there must calibrate the window regime;
15. the stores the card refused before: through ``TorchVS`` without ids,
   an f16 IVF store (K1, f32 queries on f16 rows), a residual int8 IVF
   store at d 770 with rescore 24 (K1's ragged int8 dot) and an f16 Flat
   store under ``scan="pallas"`` (K2): each must launch its kernel and
   reach recall@10 0.95 against exact f32;
16. BASELINE config 3: ``cluster_vectors`` at 1,000,000 x 768, k 1024, 10
   iterations (seconds, vecs/s, inertia; beside phase 12's sharded fit),
   the k-means++ seeding alone at k 1024 and 4096, the ``sem_dedup``
   self-join as store calls (a Flat
   store, ids = every row, K 65) over 65,536 query rows, extrapolated,
   whose thresholded pairs of 256 queries must equal exact f32's, then
   ``sem_dedup``'s host half over those rows' pairs at two thresholds
   (``lotus_tpu_torch.native.union_find``: edges, components, host ms,
   the same components as its plain version), and the reference's 20k x
   20k self-join at K 16;
17. the ids path at config 1's shape (10,000 x 384 Flat, one query a call:
   recall@10 must be 1.0) and config 2's (100,000 x 100,000 x 768, k 5:
   pair recall against the full exact oracle), warm host ms and device ms;
18. flat corpus: a seeded, normalised 2**20 x 768 corpus (4096 clusters),
   4096 queries, the exact f32 top-10 of 256 of them;
19. K2 vs plain: K2 (``scan_fold``) against ``scan_fold_reference`` on the
   same card tensors: int8 store with int8 queries (bit for bit), int8 store
   with bf16 queries, bf16 store, f32 store, f16 store (timed beside its
   bound), an n_valid past a 1024 block,
   the bias and row-mask planes at blk 512 and 1024, and a d-1536 store
   (bf16, and int8 under bf16 and int8 queries) whose query tile streams
   with the ring; times at the main shape (B = 4096 over all 2**20 rows)
   for bf16 and int8 beside their bounds, and for bf16 at d 1536.  The float
   variants hold every pool score within 2e-5 * (1 + |s|), the best id of
   every lane whose best and second scores lie further apart than that,
   and the top-10 sets except at a near-tie;
20. flat main path: ``flat_search_pallas`` over the bf16 store at k 10;
   recall@10 against the exact f32 top-10 must reach 0.98; QPS over chained
   4096-query batches, K2 against the plain version (``scan_fold_reference``
   and the same pool top-k);
21. Flat store: ``TorchVS(index_type="flat")`` over the same rows serves a
   4096-query search through K2 as bf16 with ``approx`` and as int8 with
   ``scan="pallas"`` (rescore 32); a search with ids does not launch K2 and
   returns only allowed ids;
22. stage breakdown of one bf16 flat batch (CUDA events per stage);
23. the models at their published widths with seeded weights (a seeded
   30,522-entry WordPiece vocabulary; all-MiniLM-L6-v2, e5-base-v2 and
   cross-encoder/ms-marco-MiniLM-L-6-v2 as ``model.safetensors`` directories
   under ``build/lotus_tpu_torch/smoke_models``), each through its entry
   point on the card and held to the port's own CPU run on 64 docs of mixed
   length in f32 (embeddings within 1e-4, scores within 1e-4 * (1 + |s|)),
   and bf16 on the card to f32 on the card (smallest cosine >= 0.99);
24. BASELINE config 1 from text: 10,000 synthetic passages of 150-300 words
   through ``TorchSentenceEncoderRM`` at MiniLM widths in f32 and bf16 (docs/s,
   tokens/s real and padded, the tokenizer's host seconds, the encoder's
   device ms and share of its bound), a ``TorchVS`` Flat store, 256 queries
   through ``convert_query_to_query_vector``: with ids = every row, one query
   a call (recall@10 must be 1.0 against exact f32) and without ids under
   ``scan="pallas"`` (K2; recall@10 >= 0.98); the cross-encoder over the
   top 100 of 64 queries (pairs/s);
25. BASELINE config 2's encoder: 100,000 + 100,000 docs of 8-48 words at
   e5-base-v2 widths in bf16, the right side in ``TorchVS(index_type="ivf",
   nlist=128, device_dtype="int8")`` (block-aligned, so K1): 1,000 left
   queries without ids (recall@5 >= 0.95 against exact f32), then the whole
   left side with ids = every right row at k 5 (pair recall printed);
26. profiling: ``profiling.trace`` in a child process (``chip_smoke.py
   --profile <dir>``) around one encode batch and one config-1 store call
   through K2, each in ``annotate``; the Chrome trace must hold
   ``scan_kernel`` and both regions with device times, ``timed``'s sink both
   regions.  The models' and indexes' files are deleted once the phases pass;
27. the encoder families past BERT at published widths with seeded weights,
   each written under ``build/lotus_tpu_torch/smoke_families`` as
   ``model.safetensors``, ``config.json`` and a ``tokenizer.json`` the script
   generates (a seeded 250,002-piece Unigram with a charsmap, seeded
   byte-level BPE merges, phase 23's WordPiece): multilingual-e5-base and
   bge-reranker-base (XLM-R), all-roberta-large-v1 (RoBERTa, 24 x 1024),
   msmarco-distilbert-base-v4 (DistilBERT) and ms-marco-electra-base
   (ELECTRA, 1 label, ``CHECK_DEPTH`` layers).  Each through its entry
   point on the card against the CPU in f32 (64 docs, 16 for RoBERTa-large; multilingual text for XLM-R;
   within 1e-4, scores within 1e-4 * (1 + |s|)), bf16 against f32 for the
   RMs (smallest cosine >= 0.99); XLM-R over 65,536 of config 2's docs in
   bf16 into an int8 IVF store (nlist 128, block-aligned: K1), recall@5 >=
   0.95 against exact f32 over 1,000 queries, K1 held to its plain version
   on the call's inputs, the XLM-R reranker over 16 x 100 pairs in bf16;
   RoBERTa-large over config 1's 10,000 passages in bf16 into a Flat store:
   recall@10 1.0 through ids (an id outside the oracle's top 10 only as a
   tie within sqrt(d) * 2**-24 * sum|q_i x_i|, ``summation_ties``), >= 0.98
   through K2 at d 1024, K2 held to its
   plain version on the call's inputs and timed beside its bound.  Each
   ingest prints docs/s, tokens/s, the tokenizer's share and cost a word,
   and the encoder's share of its bound.  The files are deleted after;
28. the last encoder families the Flax auto classes load, at published
   widths with seeded weights, each written under
   ``build/lotus_tpu_torch/smoke_late_families`` as a 1-label classifier
   that serves as RM (its encoder) and reranker: paraphrase-albert-small-v2
   (ALBERT: 128-d embeddings, 6 layers in 1 shared group, ``gelu_new``, a
   seeded 30,000-piece Unigram in ``AlbertConverter``'s pipeline with
   ``NFKD``), roformer_chinese_base (RoFormer: rotary positions, a seeded
   50,000-entry WordPiece named ``BertTokenizer``: its own class cuts with
   jieba, which the port refuses), bigbird-roberta-base (BigBird:
   ``block_sparse``, block 64, 3 random blocks, 4096 positions, a seeded
   50,358-piece Unigram in ``BigBirdConverter``'s pipeline) and
   efficient_mlm_m0.40 (RoBERTa-PreLayerNorm at RoBERTa-large widths);
   RoFormer and RoBERTa-PreLayerNorm ``CHECK_DEPTH`` layers deep.
   Each as an RM and as a reranker on the card against the CPU in f32
   (BigBird at the 256- and 512-token buckets; within 1e-4, scores within
   1e-4 * (1 + |s|)), bf16 against f32 for the RMs (smallest cosine >=
   0.99); ALBERT over 65,536 of config 2's docs in bf16 into an int8 IVF
   store (nlist 128, block-aligned: K1), recall@5 >= 0.95 against exact f32,
   K1 held to its plain version on the call's inputs; BigBird over 1,024
   documents of 2,000-3,000 words in bf16, every batch in the 4096-token
   bucket, into a Flat store, with queries of 200 words (the reference's
   block-sparse attention fails below 256 tokens): recall@10 1.0 through
   ids, >= 0.98 through K2, K2 held to its plain version on the call's
   inputs and timed beside its bound.  The encoder's bound counts ALBERT's
   shared groups once a layer and BigBird's block-sparse pairs.  The files
   are deleted after;
29. the encoder-decoder families the Flax auto classes load, at published
   widths with seeded weights, under ``build/lotus_tpu_torch/smoke_seq2seq``
   (``write_seq2seq_models``; ``shared`` alone holds the tied token
   embeddings): bart-base (BART, 6 + 6 layers at 768, RM),
   bart-large (12 + 12 at 1024) and mbart-large-cc25 (mBART, pre-LN,
   250,027 pieces, ``scale_embedding``), each a 1-label classifier serving
   as RM and reranker, pegasus-large (sinusoidal positions, ReLU),
   blenderbot-400M-distill (1280 wide, 128 positions) and
   blenderbot_small-90M (512 wide, the slow tokenizer's ``vocab.json``
   / ``merges.txt``), RMs only, the last three ``CHECK_DEPTH`` layers deep a
   stack (2 + 2); tokenizers seeded in their converters'
   layouts (mBART's template set from ``src_lang``).  Each RM (and
   reranker) on the card against the CPU in f32 (32 docs, 16 for the models
   of 24 layers or more; within 1e-4, scores within 1e-4 * (1 + |s|)), bf16
   against f32 (smallest cosine >= 0.99); Blenderbot at max_seq_length 128,
   and one call at 512 that must raise ``ValueError`` before any layer
   runs; BART-base over 65,536 of config 2's docs in bf16 into an int8 IVF
   store (nlist 128, block-aligned: K1), recall@5 >= 0.95 over 1,000
   queries, K1 held to its plain version on the call's inputs, the
   bart-large reranker over 16 x 100 pairs; mBART over 4,096 of config 1's
   passages in bf16 (the 512-token bucket) into a Flat store: recall@10 1.0
   through ids, >= 0.98 through K2 at d 1024, K2 held to its plain version
   on the call's inputs and timed beside its bound, the mBART reranker over
   16 x 100 pairs.  The encoder-decoder's bound counts both stacks and the
   cross-attention (``seq2seq_pairs``).  The files are deleted after;
30. the decoder-only RMs the Flax auto class loads, under
   ``build/lotus_tpu_torch/smoke_decoders`` (``write_decoder``: weights drawn
   on the card and written in bf16; tokenizers seeded in their converters'
   layouts: GPT-2's byte-level BPE with ``<|endoftext|>`` as its pad
   token, ``LlamaTokenizerFast``'s and ``GemmaTokenizerFast``'s
   sentencepiece BPE with byte fallback, left-padded).  30a: gpt2,
   gpt-neo-1.3B (global / local layers, window 256), gpt-j-6B (``rotary_dim``
   64), Llama-2-7b, Mistral-7B-v0.1 and gemma-2b (one KV head of 256) at
   their published widths, 2 layers deep, each as an RM on the card against
   the CPU in f32 (16 docs in four buckets, a share of their words outside
   the seeded vocabularies: within 1e-5), bf16 against f32 (smallest cosine
   >= 0.99), and with its tokenizer read without a pad token, which must
   raise ``ValueError`` as the reference does; 30b: Mistral-7B-v0.1 at full
   width and depth (32 layers, 7.24 B parameters) written as bf16 shards
   with ``model.safetensors.index.json`` (the free disk and host memory
   printed first), loaded in bf16 tensor by tensor onto the card (seconds,
   host peak RSS), 4,096 of config 2's docs at max_seq_length 512 into an
   int8 IVF store (nlist 8, block-aligned: K1), recall@5 >= 0.95 over 512
   queries, K1 held to its plain version on the call's inputs; 30c: GPT-2
   at gpt2-base widths and depth in f32 over 4,096 of config 1's passages
   (the 512-token bucket) into a Flat store: recall@10 1.0 through ids,
   >= 0.98 through K2 at d 768, K2 held to its plain version on the call's
   inputs and timed beside its bound.  A decoder's bound counts its causal
   s(s+1)/2 pairs a layer (``decoder_attention``).  The files are deleted
   after;
31. BLOOM and XGLM, under ``build/lotus_tpu_torch/smoke_alibi`` (weights
   drawn on the card and written in bf16; BLOOM's byte-level BPE behind its
   ``Split`` on a ``Regex``, left-padded, and XGLM's Unigram with ``</s>
   $A``).  31a: bloom-560m, bloom-7b1 (``n_embed``), xglm-564M and
   xglm-7.5B at their published widths, 2 layers deep, each on the card
   against the CPU in f32 (16 docs in four buckets, left-padded rows for
   BLOOM, words outside the vocabularies: within 2e-6), bf16 against f32
   (smallest cosine >= 0.999), and without a pad token, which must raise;
   31b: BLOOM-7b1 at full width and depth (30 layers, 7,069,016,064
   parameters) from bf16 shards, loaded tensor by tensor onto the card,
   4,096 of config 2's docs into an int8 IVF store (nlist 8, block-aligned:
   K1), recall@5 >= 0.95, K1 held to its plain version on the call's
   inputs and timed beside its bound; 31c: XGLM-564M at full width and
   depth in bf16 over 4,096 of config 1's passages into a Flat store:
   recall@10 1.0 through ids, >= 0.98 through K2 at d 1024, K2 held to its
   plain version on the call's inputs.  The files are deleted after;
32. GPT-SW3 and Marian, under ``build/lotus_tpu_torch/smoke_spm`` (weights
   drawn on the card and written in bf16; their sentencepiece ``.model``
   files written by ``spm_model_bytes``, a protobuf writer of its own: a
   seeded Unigram that holds most words whole and splits the rest in two,
   GPT-SW3's with byte fallback, Marian's behind a charsmap with
   ``vocab.json`` ids).  32a: gpt-sw3-126m, gpt-sw3-6.7b-v2 and
   opus-mt-en-de at their published widths, 2 layers deep, each on the
   card against the CPU in f32 (within 2e-6), bf16 against f32 (smallest
   cosine >= 0.999), and where the reference fails each must raise
   ``ValueError``: GPT-SW3 with a pad token its ``spiece.model`` lacks,
   Marian on a bucket past its 512 positions; 32b: GPT-SW3 6.7B at full
   width and depth (32 layers) from bf16 shards, 4,096 of config 2's docs
   into an int8 IVF store (nlist 8: K1), recall@5 >= 0.95, K1 held to its
   plain version on the call's inputs and timed beside its bound; 32c:
   opus-mt-en-de at full width and depth (6 + 6 layers) in bf16 over 4,096
   of config 1's passages into a Flat store: recall@10 1.0 through ids,
   >= 0.98 through K2 at d 512, K2 held to its plain version on the
   call's inputs.  The files are deleted after;
33. the serving tier (``lotus_tpu_torch.serving`` and ``.native``) under
   ``build/lotus_tpu_torch/smoke_serving``.  33a: config 4's seeded corpus
   in 4 contiguous quarters of 2,621,440 rows, each built on the card with
   config 4's per-list shape (nlist 1,024, block_align 1,024, residual int8
   + int4) and written as built (``save_ivf_state``; build seconds and GB
   each); 4 child processes (``chip_smoke.py --serve <dir> <id_offset>``,
   all on ``cuda:0``) each load one quarter into a ``TorchVS`` (nprobe 208,
   rescore 24, int8 queries, query_chunk 2,048) behind a ``ShardServer``;
   a ``SearchFrontEnd`` sends config 4's 4,096 queries over loopback
   (k 10: recall@10 against phase 3's exact f32 oracle must reach 0.95,
   printed against BASELINE's 0.99 and phase 5's), then 5 timed batches
   (QPS) and 200 single-query requests (p50 / p99 ms); the share of the
   front end's wall outside the stores' calls; each child's exit record
   (K1 launches, each request's seconds, K1 held to its plain version on
   its store call's inputs).  33b: the flat-scan corpus in 2 halves of
   524,288 rows, bf16 ``TorchVS`` stores under ``scan="pallas"`` (K2)
   behind ``ShardServer`` threads: recall@10 at least phase 21's bf16
   store's less 0.001, QPS, the share outside the stores, K2 held to its
   plain version on a half's call.  33c: ``native.topk_merge_batch``
   against its plain version on 33a's (4,096, 4, 10) pools (ids equal,
   scores bit for bit), both timed.  The files are deleted after.

Each main path runs with its kernel's launch count set to 0 just before it
and read just after: K1 and K3 over phases 5-8 (calibration included) and
over phase 13, K3 once a slice in phase 5's first search; K1 also in each
rank over phase 12's sharded search, over each K1 store of phase 15 and
over phase 25's, 27's, 28's, 29's, 30's, 31's and 32's stores, and in
each shard server of 33a over the requests it served; K2 over phase
10, over phases 20-21, over phase 15's Flat store, over phase 24's, 27's,
28's, 29's, 30's, 31's and 32's, and over 33b's front end;
each must have launched its kernel, and each phase prints its count.
The last three lines are the kernel table (K1, whose launches add the
ranks' and the shard servers', K2, K3, then the variants later slices
added, each with its own path's launches: K2 at d 1024 is phase 27's),
the card, and ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository beside this file, it exits non-zero and
prints no result.  ``chip_smoke.py --rank <dir>`` is one rank of phase 12,
``chip_smoke.py --profile <dir>`` phase 26's child and ``chip_smoke.py
--serve <index_dir> <id_offset>`` one shard server of phase 33a, each
started by the script itself.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NPROBE, RESCORE, K, B, QUERY_CHUNK = 208, 24, 10, 4096, 2048
FLAT_N, FLAT_SEED = 2**20, 3
DEEP_N = 2**18  # rows of the d-1536 K2 comparison
# K2's float variants against the plain version: bf16 products are exact and
# the f32 sums run in another order (1.37e-6 at most at the main shape on an
# H100).  Rounding the output to bf16, or skipping the f32 store's rounding
# to bf16 before the dot, moves scores by 1e-5 or more.
K2_TOL = 2e-5
GPU = ""  # the card's "name, power limit", printed beside every time
# NVIDIA's H100 SXM data sheet (dense): the bounds' rates.
HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S, F32_OPS_PER_S = 3.35e12, 1979e12, 989e12, 67e12
# The window probe's transient peak may pass its gather budget by this much:
# the coarse ranking, the candidates' rescoring and the allocator's rounding.
PEAK_MARGIN = 256 << 20
WINDOW_NQ = 64  # queries over which each window-probe recall is taken
PEAK_SEEN = 0  # the process's peak allocation before transient_peak last reset it


def say(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        say(f"== {self.name}: {self.seconds:.3f} s [{GPU}]" + ("" if exc[0] is None else " (FAILED)"))
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, args, *, bl, int8_dot, l2, packed, exact, tol=0.0, reps=0, top1=False):
    """Run K1 and its plain version on the same card tensors and hold them
    together; returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import _LOCAL_MASK, probe_fold, probe_fold_reference

    kw = dict(bl=bl, int8_dot=int8_dot, l2=l2, packed=packed, top1=top1)
    got_s, got_i = probe_fold(*args, **kw)
    torch.cuda.synchronize()
    plan = probe_fold.last_plan
    ref_s, ref_i = probe_fold_reference(*args, **kw)
    torch.cuda.synchronize()
    if exact:
        same = torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32))
        if not packed:
            same = same and torch.equal(got_i, ref_i)
        err = float((got_s.double() - ref_s.double()).abs().max())
        ok = same
    else:
        if packed:  # the low 13 bits carry ids: compare the scores they truncate
            got_s = (got_s.view(torch.int32) & ~_LOCAL_MASK).view(torch.float32)
            ref_s = (ref_s.view(torch.int32) & ~_LOCAL_MASK).view(torch.float32)
        diff = (got_s.double() - ref_s.double()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol * (1.0 + ref_s.double().abs())).all())
    live = int((ref_s > -1e38).sum())
    ms = plain_ms = None
    if reps:
        ms = cuda_ms(lambda: probe_fold(*args, **kw), reps)
        plain_ms = cuda_ms(lambda: probe_fold_reference(*args, **kw), 1)
    say(f"  {name}: {'bitwise equal' if exact else f'tol {tol:g}'} -> {'OK' if ok else 'MISMATCH'}; "
        f"max_abs_err={err!r}; live candidates={live}"
        + ("" if ms is None else f"; K1 {ms:.3f} ms vs plain {plain_ms:.3f} ms [{GPU}]"))
    say(f"    route {plan['route']}; query tile {plan['query']}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {name}")
    return err, ms, plain_ms


def k2_row_scores(args, blk, qs, rows):
    """K2's score of query ``qs[j]`` against storage row ``rows[j]``, each
    pair by the plain formula on ``scan_fold``'s arguments ``args`` (rows
    rounded to bf16, times the row scale, plus the block's bias; -inf where
    the row mask drops the row)."""
    import torch

    xq, xb, _, scales, bias, row_mask = (*args, None, None, None)[:6]
    s = (xq[qs].double() * xb[rows].to(torch.bfloat16).double()).sum(1)
    if scales is not None:
        s = s * scales[rows].double()
    if bias is not None:
        s = s + bias[rows // blk, qs].double()
    if row_mask is not None:
        s = torch.where(row_mask[rows] == 0, float("-inf"), s)
    return s


def k2_compare(name, args, *, exact, blk=1024, reps=0, k=K):
    """Run K2 and its plain version on the same card tensors and hold them
    together: bit for bit, or each pool score within K2_TOL * (1 + |s|), the
    best id equal in every lane whose best and second scores lie further
    apart than that, and every id of K2's top ``k`` that the plain
    version's top ``k`` lacks a tie: a live row whose own score, rescored by
    ``k2_row_scores``, lies within that tolerance of the score K2 gives it
    (its lane slot's score already matches the plain version's).  Returns
    (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lotus_tpu_torch.ops.flat_scan import NL, _pool_topk, scan_fold, scan_fold_reference

    got = scan_fold(*args, blk=blk)
    torch.cuda.synchronize()
    plan = scan_fold.last_plan
    ref = scan_fold_reference(*args, blk=blk)
    torch.cuda.synchronize()
    (gs, gi), (rs, ri) = ((torch.cat([p[0], p[2]], 1), torch.cat([p[1], p[3]], 1)) for p in (got, ref))
    diff = (gs.double() - rs.double()).abs()
    err = float(diff.max())
    ids = ""
    if exact:
        ok = torch.equal(gs.view(torch.int32), rs.view(torch.int32)) and torch.equal(gi, ri)
    else:
        tol = K2_TOL * (1.0 + rs.double().abs())
        close = bool((diff <= tol).all())
        clear = (rs[:, :NL] - rs[:, NL:]).double() > tol[:, :NL]
        same_best = torch.equal(gi[:, :NL][clear], ri[:, :NL][clear])
        (ts, ti), (_, ui) = (_pool_topk(p, None, k) for p in (got, ref))
        pairs = []  # (query, rank) of K2's top-k ids outside the plain version's
        for q, (a, b) in enumerate(zip(ti.tolist(), ui.tolist())):
            theirs = set(b)
            pairs += [(q, j) for j, i in enumerate(a) if i not in theirs]
        ties = True
        if pairs:
            qs, js = (torch.tensor(v, device=gs.device) for v in zip(*pairs))
            rows, claimed = ti[qs, js].long(), ts[qs, js].double()
            own = k2_row_scores(args, blk, qs, rows.clamp(0, args[1].shape[0] - 1))
            live_rows = bool(((rows >= 0) & (rows < min(int(args[2]), args[1].shape[0]))).all())
            ties = live_rows and bool(((claimed - own).abs() <= K2_TOL * (1.0 + claimed.abs())).all())
        ok = close and same_best and ties
        ids = (f"; best ids {'equal' if same_best else 'DIFFER'} in {int(clear.sum())} clear lanes; "
               f"{len(pairs)} top-{k} ids outside the plain version's, "
               f"{'each a tie' if ties else 'NOT all ties'}")
    live = int((rs > -1e38).sum())
    ms = plain_ms = None
    if reps:
        ms = cuda_ms(lambda: scan_fold(*args, blk=blk), reps)
        plain_ms = cuda_ms(lambda: scan_fold_reference(*args, blk=blk), 1)
    say(f"  {name}: {'bitwise equal' if exact else f'tol {K2_TOL:g}*(1+|s|), top-{k} sets up to ties'} -> "
        f"{'OK' if ok else 'MISMATCH'}; max_abs_err={err!r}; live candidates={live}{ids}"
        + ("" if ms is None else f"; K2 {ms:.3f} ms vs plain {plain_ms:.3f} ms [{GPU}]"))
    say(f"    loader {plan['loader']}; query tile {plan['query']}; "
        f"{plan['splits']} row splits of {plan['rows_per_split']:,} rows")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {name}")
    return err, ms, plain_ms


def k3_bound(args, k_out: int) -> tuple[float, float]:
    """K3's bound on these inputs: the candidates of every pair whose list
    holds rows, the pair tables (row, list, bias) and the query scales read
    once, the (b, k_out) head written once, at 3.35 TB/s.  Returns (ms,
    bytes)."""
    cand, _, _, lists, _, sizes, bias, q_scales = args
    b, nprobe = lists.shape
    live = int((sizes[lists.long()] > 0).sum())
    nbytes = (live * cand.shape[-1] * 4 + b * nprobe * (8 + 4 + (4 if bias is not None else 0))
              + (b * 4 if q_scales is not None else 0) + b * k_out * 8)
    return 1e3 * nbytes / HBM_BYTES_PER_S, float(nbytes)


def k3_compare(state, queries, reps: int = 20):
    """K3 (``pool_select``) against ``pool_select_reference`` on the inputs
    the main path (``ivf_search_grouped_probe`` at phase 5's settings) gives
    it for ``queries``, recorded through the plain version so that recording
    launches no K3: scores bit for bit; rows equal, as sets of (score, row),
    wherever the score is above MASK_SCORE / 2 and above the head's last
    score (where ties may take other candidates of the same score); both
    timed beside ``k3_bound``.  Returns (max_abs_err, ms, plain ms, bound
    ms, "bytes")."""
    import torch

    from lotus_tpu_torch.ops import ivf_probe
    from lotus_tpu_torch.ops.common import MASK_SCORE

    record, calls = recording(ivf_probe.pool_select_reference)
    kernel = ivf_probe.pool_select
    ivf_probe.pool_select = record
    try:
        ivf_probe.ivf_search_grouped_probe(state, queries, K, nprobe=NPROBE, metric="ip", rescore=RESCORE,
                                           int8_queries=True, query_chunk=QUERY_CHUNK)
    finally:
        ivf_probe.pool_select = kernel
    args, kw = calls[0]
    got_s, got_r = kernel(*args, **kw)
    ref_s, ref_r = ivf_probe.pool_select_reference(*args, **kw)
    torch.cuda.synchronize()
    bits, ref_bits = got_s.view(torch.int32), ref_s.view(torch.int32)
    bitwise = torch.equal(bits, ref_bits)
    above = (got_s > MASK_SCORE / 2) & (bits != bits[:, -1:])
    held = [torch.sort(torch.where(above, (v.long() << 32) | r.long(), -1), dim=1).values
            for v, r in ((bits, got_r), (ref_bits, ref_r))]
    rows_equal = torch.equal(*held)
    err = float((got_s.double() - ref_s.double()).abs().max())
    ms = cuda_ms(lambda: kernel(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: ivf_probe.pool_select_reference(*args, **kw), 3)
    bound, nbytes = k3_bound(args, kw["k_out"])
    b, nprobe = args[3].shape
    say(f"  K3 at config 4's first slice (b {b}, nprobe {nprobe}, kc {args[0].shape[-1]}, k_out {kw['k_out']}, "
        f"{'packed' if kw['packed'] else 'unpacked'}, bias {args[6] is not None}, scale {args[7] is not None}): "
        f"scores {'bitwise equal' if bitwise else 'DIFFER'}, rows {'equal' if rows_equal else 'DIFFER'} "
        f"({int(above.sum()):,} head entries above the last score); max_abs_err={err!r}; K3 {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; bound {bound:.3f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), K3 at "
        f"{100 * bound / ms:.1f}% of it [{GPU}]")
    assert bitwise and rows_equal, "K3 disagrees with its plain version on config 4's slice"
    return err, ms, plain_ms, bound, "bytes"


def kernel_report() -> None:
    """K1's, K2's and K3's kernels as built: registers and spill bytes from ptxas,
    ptxas's wgmma advisories counted by code (an injected warpgroup.wait or
    arrive: C7517, C7519; serialized wgmma: C7510, C7514), and the
    tensor-core (HGMMA bf16, IGMMA int8) and TMA-load (UTMALDG) instructions
    that ``cuobjdump -sass`` shows in each.  Fails unless every bf16
    tensor-core instantiation (K2's scan_kernel, K1's probe_wgmma) has HGMMA
    and every int8 one IGMMA.  K1's probe_cores (f32, and rows TMA cannot
    take) and K3's pool_select (a selection, no dot) run on the CUDA cores
    by design."""
    from lotus_tpu_torch.ops import _kernels

    ptxas = {}
    for part in _kernels.build_log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        ptxas[name] = (regs and int(regs.group(1)), spill and (int(spill.group(1)), int(spill.group(2))))
    notes: dict[str, dict[str, int]] = {}
    for m in re.finditer(r"\((C75(?:10|14|17|19))\).*?function '([^']+)'", _kernels.build_log):
        per = notes.setdefault(m.group(2), {})
        per[m.group(1)] = per.get(m.group(1), 0) + 1
    sass = subprocess.run([_kernels.cuda_tool("cuobjdump"), "-sass", str(_kernels.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(("HGMMA", "IGMMA", "UTMALDG"), 0)
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    for kind in ("scan_kernel", "probe_wgmma", "probe_cores", "pool_select"):
        found = sorted(f for f in counts if kind in f)
        assert found, f"no {kind} in the built library"
        for f in found:
            int8_dot = f"{kind}Ia" in f  # the operand type is int8
            regs, spill = ptxas.get(f, (None, None))
            dot = "selection" if kind == "pool_select" else f"{'int8' if int8_dot else 'float'} dot"
            say(f"  {f}: {dot}; ptxas {regs} registers, spill "
                f"stores/loads {spill} bytes, wgmma advisories {notes.get(f, {})}; SASS {counts[f]}")
            if kind in ("scan_kernel", "probe_wgmma"):
                op = "IGMMA" if int8_dot else "HGMMA"
                assert counts[f][op] > 0, f"{f} has no {op}: not on the tensor cores"


def k1_bound(units, vecs, chunk_list, sizes, *, int8_dot, packed, top1=False, rate=None):
    """K1's bound on this card for one launch: the larger of its bytes (each
    probed list's live rows, whole 64-row slices, and their scales read once;
    the live chunks' query tiles; the whole output written) over 3.35 TB/s
    and its operations (2 * 128 * d per live row of every live chunk) over
    the dense tensor-core rate (int8 1,979 TOP/s, bf16 989 TFLOP/s) or
    ``rate`` (f32 variants: 67 TFLOP/s outside the tensor cores), from
    NVIDIA's H100 SXM data sheet.  Returns (ms, "bytes" or "operations",
    live chunks, MACs, bytes the kernel streams: every live chunk's rows)."""
    import torch

    from lotus_tpu_torch.ops.ivf_probe import QU, ncand

    d = vecs.shape[1]
    live = chunk_list[chunk_list >= 0].long()

    def rows64(lists):  # live rows of these lists, whole 64-row slices
        return float((((sizes[lists].double() + 63) // 64) * 64).sum())

    row_bytes = d * vecs.element_size() + (4 if vecs.dtype == torch.int8 else 0)
    out_bytes = chunk_list.numel() * QU * ncand(top1) * (4 if packed else 8)
    q_bytes = live.numel() * QU * d * units.element_size()
    need = rows64(torch.unique(live)) * row_bytes + q_bytes + out_bytes
    macs = QU * d * rows64(live)
    t_bytes = need / HBM_BYTES_PER_S
    t_ops = 2 * macs / (rate or (INT8_OPS_PER_S if int8_dot else BF16_OPS_PER_S))
    streamed = rows64(live) * row_bytes + q_bytes + out_bytes
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", int(live.numel()),
            macs, streamed)


def sync(dev=None) -> None:
    """Wait for ``dev`` (default: the current card); a CPU device has nothing to wait for."""
    import torch

    if dev is None or torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def chained_qps(fn, batch: int, dev=None) -> tuple[float, float]:
    """Best of 3 windows of 3 chained calls, with a synchronize around each
    window: (queries per second, ms per call)."""
    per_call = float("inf")
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync(dev)
        per_call = min(per_call, (time.perf_counter() - t0) / 3)
    return batch / per_call, per_call * 1e3


def recall_at(ids, gt) -> float:
    """recall@K of the first len(gt) rows of ``ids`` against ``gt``."""
    return float(sum(len(set(ids[i]) & set(gt[i])) for i in range(len(gt))) / (K * len(gt)))


def print_stages(title: str, stages: dict, whole, reps: int = 5) -> None:
    """Device ms of each stage and of the whole call, each run on its own
    between CUDA events (torch.profiler's CUDA tracing crashes the process on
    the chip machine, so there is no per-kernel trace); the rest is the
    whole minus the stages' sum."""
    times = {name: cuda_ms(fn, reps) for name, fn in stages.items()}
    whole_ms = cuda_ms(whole, reps)
    say(f"  {title}, device ms (CUDA events) [{GPU}]:")
    for name, ms in [*times.items(), ("the rest", whole_ms - sum(times.values()))]:
        say(f"    {ms:9.3f} ms {100 * ms / whole_ms:5.1f}%  {name}")
    say(f"    {whole_ms:9.3f} ms 100.0%  whole")


def stage_breakdown(state, queries) -> None:
    """The stages of one config-4 query_chunk slice."""
    import torch

    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.ivf import rescore_candidates
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, probe_fold, probe_layout
    from lotus_tpu_torch.ops.quant import quantize_rows

    q = queries[:QUERY_CHUNK]
    bl = int(state["meta"]["block_align"])
    _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
    lists = lists.to(torch.int32)
    units, chunk_list, _, _ = probe_layout(lists, quantize_rows(q)[0], state["ivf_list_size"], bl)
    _, cand = ivf_search_grouped_probe(state, q, RESCORE, nprobe=NPROBE, int8_queries=True)
    print_stages(f"stage breakdown of one {QUERY_CHUNK}-query slice (the rest: reassembly, pool top-k, scale)", {
        "coarse ranking (flat_search over centroids)":
            lambda: flat_search(state["centroids"], q, NPROBE, metric="ip"),
        "query quantization + probe_layout":
            lambda: probe_layout(lists, quantize_rows(q)[0], state["ivf_list_size"], bl),
        "K1 probe_fold": lambda: probe_fold(
            units, state["ivf_vectors"], state["ivf_row_scales"], None, chunk_list,
            state["ivf_list_start"], state["ivf_list_size"], bl=bl, int8_dot=True, l2=False, packed=True),
        "exact rescore (24 -> 10)": lambda: rescore_candidates(state, q, cand, K),
    }, lambda: ivf_search_grouped_probe(state, q, K, nprobe=NPROBE, rescore=RESCORE, int8_queries=True))


def flat_stage_breakdown(xb16, fq) -> None:
    """The stages of one bf16 flat batch through ``flat_search_pallas``."""
    import torch

    from lotus_tpu_torch.ops.flat_scan import _pool_topk, flat_search_pallas, scan_fold

    qb = fq.to(torch.bfloat16)
    pool = scan_fold(qb, xb16, FLAT_N)
    print_stages(f"stage breakdown of one {B}-query flat batch (bf16 store)", {
        "query cast to bf16": lambda: fq.to(torch.bfloat16).contiguous(),
        "K2 scan_fold (scan + merge)": lambda: scan_fold(qb, xb16, FLAT_N),
        f"pool top-k (256 -> {K})": lambda: _pool_topk(pool, None, K),
    }, lambda: flat_search_pallas(xb16, fq, K), reps=3)


def transient_peak(fn):
    """Run ``fn`` once: (its result, the most it had allocated at once beyond
    what was allocated before it).  The process-wide peak so far is kept in
    PEAK_SEEN, since this resets the allocator's."""
    import torch

    global PEAK_SEEN
    torch.cuda.synchronize()
    PEAK_SEEN = max(PEAK_SEEN, torch.cuda.max_memory_allocated())
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def host_ms(fn, reps: int = 3) -> float:
    """Best host-clock milliseconds of ``fn`` (a store call, whose results
    reach the host before it returns) over ``reps`` runs."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def window_probe_runs(state, queries, gt, nprobe, rescore, *, min_recall=None, grouped=False,
                      split_budget=None) -> None:
    """``ivf_search`` (the window probe) over ``state`` at B = 1, 16 and 64:
    recall@K over the first WINDOW_NQ queries (WINDOW_NQ / B calls), device ms
    per call, the gather budget's query chunks and slot groups, and one call's
    transient peak, which must stay within the budget plus PEAK_MARGIN;
    beside it K1's grouped probe at the same B when ``grouped``.  With
    ``split_budget``, B 16 runs again under that budget, which must cut each
    query's slots into groups and return the same top-K sets."""
    import torch

    from lotus_tpu_torch.ops.ivf import DEFAULT_GATHER_BUDGET_BYTES, ivf_search, plan_window_probe
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

    vecs, window = state["ivf_vectors"], int(state["meta"]["probe_window"])
    budget = DEFAULT_GATHER_BUDGET_BYTES
    say(f"  window {window} rows; gather budget {budget / 2**30:.2f} GiB "
        f"(+ {PEAK_MARGIN / 2**20:.0f} MiB margin); {vecs.dtype} store")
    for b in (1, 16, 64):
        def win(lo=0, b=b):
            return ivf_search(state, queries[lo : lo + b], K, nprobe=nprobe, metric="ip", rescore=rescore)

        ids = torch.cat([win(lo)[1] for lo in range(0, WINDOW_NQ, b)]).cpu().numpy()
        recall = recall_at(ids, gt[:WINDOW_NQ])
        qc, group, step = plan_window_probe(b, nprobe, window, vecs.shape[1], vecs.dtype, budget)
        _, peak = transient_peak(win)
        ms = cuda_ms(win, 3)
        line = (f"  window probe B={b}: recall@{K} {recall!r} over {WINDOW_NQ} queries; {ms:.3f} ms per call; "
                f"{-(-b // qc)} query chunks x {-(-nprobe // group)} slot groups of {qc * group * window:,} rows "
                f"({step / 2**30:.3f} GiB counted a step); transient peak {peak / 2**30:.3f} GiB")
        if grouped:
            k1_ms = cuda_ms(lambda: ivf_search_grouped_probe(
                state, queries[:b], K, nprobe=nprobe, metric="ip", rescore=rescore, int8_queries=True), 5)
            line += f"; K1's grouped probe {k1_ms:.3f} ms"
        say(line + f" [{GPU}]")
        assert peak <= budget + PEAK_MARGIN, f"window probe B={b}: transient peak {peak} past the budget"
        if min_recall is not None:
            assert recall >= min_recall, f"window probe B={b}: recall@10 {recall} below {min_recall}"
    if split_budget is not None:
        b = 16
        qc, group, step = plan_window_probe(b, nprobe, window, vecs.shape[1], vecs.dtype, split_budget)

        def split():
            return ivf_search(state, queries[:b], K, nprobe=nprobe, metric="ip", rescore=rescore,
                              gather_budget_bytes=split_budget)

        (_, got), peak = transient_peak(split)
        _, want = ivf_search(state, queries[:b], K, nprobe=nprobe, metric="ip", rescore=rescore)
        same = all(set(x) == set(y) for x, y in zip(got.tolist(), want.tolist()))
        say(f"  window probe B={b} under a {split_budget / 2**30:.2f} GiB budget: {-(-b // qc)} query chunks x "
            f"{-(-nprobe // group)} slot groups ({step / 2**30:.3f} GiB counted a step); top-{K} sets "
            f"{'equal to' if same else 'DIFFER from'} the {budget / 2**30:.0f} GiB run; {cuda_ms(split, 2):.3f} ms "
            f"per call; transient peak {peak / 2**30:.3f} GiB [{GPU}]")
        assert group < nprobe and same, "the slot-grouped window probe changed the top-k sets"
        assert peak <= split_budget + PEAK_MARGIN, f"slot-grouped window probe: transient peak {peak}"


def window_store_phase(dev) -> None:
    """The reference's window-regime store (``docs/benchmarks.md:65,80``):
    200,000 x 768 seeded rows, nlist 512, nprobe 32, float32 and residual
    int8 with int4 refinement and rescore 24."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.io import read_meta
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    n, nlist, nprobe = 200_000, 512, 32
    emb_t = gen_chunk(13, 0, corpus_centers(13, 4096, 768, dev), n, 2.5)
    emb = emb_t.cpu().numpy()
    g = torch.Generator(device=dev).manual_seed(13)
    qs = emb_t[torch.randint(0, n, (WINDOW_NQ,), generator=g, device=dev)]
    qs = qs + 0.05 * torch.randn((WINDOW_NQ, 768), generator=g, device=dev)
    qs = qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)
    gt = torch.topk(qs @ emb_t.T, K, dim=1).indices.cpu().numpy()
    qs_np = qs.cpu().numpy()
    index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_window_index")
    k1_before = probe_fold.launches
    for label, kw in (("float32", {}), ("residual int8 + int4 refinement, rescore 24",
                                        dict(device_dtype="int8", int8_refine=True, rescore=RESCORE))):
        shutil.rmtree(index_dir, ignore_errors=True)
        vs = TorchVS(index_type="ivf", nlist=nlist, nprobe=nprobe, **kw)
        t0 = time.perf_counter()
        vs.index([], emb, index_dir)
        meta = read_meta(index_dir)
        say(f"  {label}: index() {time.perf_counter() - t0:.2f} s [{GPU}]; block_align {meta['block_align']}; "
            f"window {meta['probe_window']} rows")
        assert int(meta["block_align"]) == 0, "the 200k store came out block-aligned"
        for b, route in ((1, "window_probe"), (8, "window_probe"), (64, "scan")):
            before = dict(vs.stats["routes"])
            ids = [row for lo in range(0, WINDOW_NQ, b) for row in vs(qs_np[lo : lo + b], K).indices]
            served = {r: vs.stats["routes"][r] - before[r] for r in before}
            assert served == {**dict.fromkeys(before, 0), route: WINDOW_NQ // b}, f"B={b} served by {served}"
            say(f"    B={b}: {route.replace('_', ' ')}; recall@{K} {recall_at(ids, gt)!r} over {WINDOW_NQ} "
                f"queries; {host_ms(lambda: vs(qs_np[:b], K)):.3f} ms per call warm (host clock) [{GPU}]")
        if not kw:
            window_probe_runs(vs._materialize(), qs, gt, nprobe, None)
            t0 = time.perf_counter()
            cal = vs.calibrate_nprobe(0.95, oracle="exact")
            say(f"    calibrate_nprobe(0.95, oracle='exact'): regimes {cal['regimes']}; ladder {cal['ladder']}; "
                f"nprobe {cal['nprobe']}; ceiling {cal['ceiling']!r}; {time.perf_counter() - t0:.2f} s [{GPU}]")
            assert cal["regimes"] == ["window"], cal
        shutil.rmtree(index_dir, ignore_errors=True)
        del vs
    k1 = probe_fold.launches - k1_before
    say(f"  K1 launches over the window-regime stores: {k1}")
    assert k1 == 0, "an unaligned store launched K1"


def calibration_phase(vs, index_dir: str, store_kw: dict, qs_np, store_gt) -> None:
    """``calibrate_nprobe(0.95, k=K, nq=256, oracle="exact")`` on the
    block-aligned store of phase 7 walks its ladder through K1; a fresh store
    adopts the persisted entry without launching K1; an entry whose grouped
    regime was dropped routes B 1 to the window probe and B 256 to the
    exhaustive scan, with no K1 launch."""
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.io import read_meta, write_meta
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    before = probe_fold.launches
    t0 = time.perf_counter()
    cal = vs.calibrate_nprobe(0.95, k=K, nq=256, oracle="exact")
    cal_s = time.perf_counter() - t0
    cal_launches = probe_fold.launches - before
    say(f"  ladder {cal['ladder']}; nprobe {cal['nprobe']} at recall@{K} {cal['recall']!r} vs exact f32; "
        f"ceiling {cal['ceiling']!r}; regimes {cal['regimes']}; {cal_s:.2f} s; K1 launches {cal_launches} "
        f"[{GPU}]")
    assert cal_launches > 0, "calibration did not launch K1"
    assert cal["regimes"] == ["pallas"] and not cal["target_unreachable"], cal
    fresh = TorchVS(recall_target=0.95, **store_kw)
    fresh.load_index(index_dir)
    before = probe_fold.launches
    adopted = fresh.calibrate_nprobe(0.95, k=K, oracle="exact")
    adopted_launches = probe_fold.launches - before
    say(f"  a fresh TorchVS(recall_target=0.95) adopts nprobe {fresh.nprobe} from meta.json; "
        f"K1 launches {adopted_launches}")
    assert adopted_launches == 0 and adopted["nprobe"] == cal["nprobe"] == fresh.nprobe, adopted
    # An entry whose grouped regime was dropped: the lazy autotune adopts
    # it and routes B 1 to the window probe, B 256 to the exhaustive scan.
    disk = read_meta(index_dir)
    disk["calibration"][f"0.95@{K}"] = {**disk["calibration"][f"0.95@{K}/exact"], "regimes_dropped": ["pallas"]}
    write_meta(index_dir, disk)
    dropped = TorchVS(recall_target=0.95, **store_kw)
    dropped.load_index(index_dir)
    before = probe_fold.launches
    one, many = dropped(qs_np[:1], K), dropped(qs_np, K)
    dropped_launches = probe_fold.launches - before
    say(f"  regimes_dropped ['pallas']: routes {dropped.stats['routes']}; recall@{K} B=1 "
        f"{recall_at(one.indices, store_gt[:1])!r}, B=256 {recall_at(many.indices, store_gt)!r}; "
        f"K1 launches {dropped_launches}")
    assert dropped.stats["routes"] == {"grouped_probe": 0, "window_probe": 1, "scan": 1}, dropped.stats
    assert dropped_launches == 0, "a dropped grouped regime launched K1"


def reset_peak() -> None:
    """Reset the allocator's peak, keeping the process-wide one in PEAK_SEEN."""
    import torch

    global PEAK_SEEN
    torch.cuda.synchronize()
    PEAK_SEEN = max(PEAK_SEEN, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def seeded_queries(rows, nq: int, seed: int):
    """``nq`` unit queries: perturbed copies of seeded picks of ``rows``."""
    import torch

    g = torch.Generator(device=rows.device).manual_seed(seed)
    q = rows[torch.randint(0, rows.shape[0], (nq,), generator=g, device=rows.device)]
    q = q + 0.05 * torch.randn(q.shape, generator=g, device=rows.device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def exact_topk(q, rows, k: int, chunk: int = 8192):
    """Exact f32 top-k ids of ``q`` over ``rows`` (no TF32), in query chunks."""
    import torch

    return torch.cat([torch.topk(q[lo : lo + chunk] @ rows.T, k, dim=1).indices
                      for lo in range(0, q.shape[0], chunk)])


def capacity_report(label: str, state, n: int, peak: int) -> int:
    """The capacity model's bytes for a served config-4 state beside the
    state's own ``nbytes`` and the build's ``max_memory_allocated``; they
    must agree.  Returns the state's bytes."""
    import torch

    from lotus_tpu_torch.ops import capacity
    from lotus_tpu_torch.ops.ivf import ensure_pos_list

    ensure_pos_list(state)
    have = sum(t.nbytes for t in state.values() if isinstance(t, torch.Tensor))
    meta = state["meta"]
    want = capacity.state_bytes(n, state["ivf_vectors"].shape[0], int(meta["nlist"]), int(meta["d"]), torch.int8,
                                residual=True, refine=True)
    say(f"  capacity ({label}): formula {want / 2**30:.3f} GiB, state nbytes {have / 2**30:.3f} GiB "
        f"({state['ivf_vectors'].shape[0]:,} slots for {n:,} rows), build peak {peak / 2**30:.2f} GiB [{GPU}]")
    assert have == want, f"capacity formula {want} != state nbytes {have}"
    return have


def capacity_table(dev, window: int) -> None:
    """The most rows of d 768 each encoding holds on this card at config 4's
    geometry (nlist 4096, block_align 1024, this run's window) beside the
    transients of the serving paths: the window probe's gather budget plus
    PEAK_MARGIN, K1's pool at query_chunk 2048 and nprobe 208, and the ids
    path's f32 reconstruction of 2**16 rows."""
    import torch

    from lotus_tpu_torch.ops import capacity
    from lotus_tpu_torch.ops.ivf import DEFAULT_GATHER_BUDGET_BYTES

    total = torch.cuda.get_device_properties(dev).total_memory
    transient = {"window probe": DEFAULT_GATHER_BUDGET_BYTES + PEAK_MARGIN,
                 "K1 pool": capacity.k1_pool_bytes(QUERY_CHUNK, NPROBE, 4096),
                 "ids path": capacity.subset_bytes(1 << 16, 768, torch.int8, residual=True)}
    free = total - max(transient.values())
    say(f"  card memory {total / 2**30:.2f} GiB; transients " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in transient.items()) + " (the largest is reserved)")
    for name, dtype, kw in (("f32", torch.float32, {}), ("bf16", torch.bfloat16, {}),
                            ("f16", torch.float16, {}), ("plain int8", torch.int8, {}),
                            ("residual int8 + int4", torch.int8, dict(residual=True, refine=True)),
                            ("residual int8 + int4, spill 0.05", torch.int8,
                             dict(residual=True, refine=True, spill_frac=0.05))):
        per_slot = capacity.slot_bytes(768, dtype, residual=kw.get("residual", False))
        per_row = capacity.row_bytes(768, refine=kw.get("refine", False))
        rows = capacity.max_rows(free, 768, dtype, nlist=4096, block_align=1024, window=window, **kw)
        say(f"    {name}: {per_slot} B a slot + {per_row} B a row -> at most {rows:,} rows")


CONFIG4 = dict(n=10 * 2**20, d=768, nlist=4096, n_clusters=65536, cluster_scale=2.5, chunk=2**18,
               queries_b=B, gt_queries=256, k=K, block_align=1024, seed=0)


def spill_phase(dev, unspilled: dict, cfg: dict = CONFIG4) -> tuple[int, int]:
    """Config 4 at ``spill_frac=0.05`` (the reference's measured spill point),
    beside the unspilled run of this call: build seconds per phase, vecs/s,
    spilled copies, peak memory, recall@10 at nprobe 208 / rescore 24, QPS,
    K1's ms per slice; no id repeats in any top-10, and every row's
    ``ivf_inv_perm`` slot lies in its top-1 list.  Returns K1's and K3's
    launches."""
    import torch

    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.ivf import ensure_pos_list
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, pool_select, probe_fold, probe_layout
    from lotus_tpu_torch.ops.quant import quantize_rows

    reset_peak()
    held = torch.cuda.memory_allocated()  # what survives the unspilled store: nothing of it
    built = synth_ivf_device_build(**cfg, spill_frac=0.05, device=dev, log=say)
    peak = torch.cuda.max_memory_allocated()
    state, xq, gt = built["state"], built["queries"], built["gt"]
    say(f"  spill_frac 0.05: build {built['build_seconds']:.2f} s = {built['build_vecs_per_s']:,.0f} vecs/s; phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in built["timings"].items())
        + f"; {built['spilled']:,} spilled copies; window {state['meta']['probe_window']}; "
          f"peak {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB allocated before it) [{GPU}]")

    def search(queries):
        return ivf_search_grouped_probe(state, queries, K, nprobe=NPROBE, metric="ip", rescore=RESCORE,
                                        int8_queries=True, query_chunk=QUERY_CHUNK)

    probe_fold.launches = pool_select.launches = 0  # this path's launches
    dists, ids = search(xq)
    torch.cuda.synchronize()
    k1_launches, k3_launches = probe_fold.launches, pool_select.launches
    ids_np = ids.cpu().numpy()
    recall = recall_at(ids_np, gt)
    repeats = sum(len(set(r[r >= 0].tolist())) != int((r >= 0).sum()) for r in ids_np)
    qps, batch_ms = chained_qps(lambda: search(xq), B)
    k1_launches_all, k3_launches_all = probe_fold.launches, pool_select.launches
    q = xq[:QUERY_CHUNK]
    _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
    units, chunk_list, _, _ = probe_layout(lists.to(torch.int32), quantize_rows(q)[0], state["ivf_list_size"], 1024)
    k1_ms = cuda_ms(lambda: probe_fold(units, state["ivf_vectors"], state["ivf_row_scales"], None, chunk_list,
                                       state["ivf_list_start"], state["ivf_list_size"], bl=1024, int8_dot=True,
                                       l2=False, packed=int(state["meta"]["probe_window"]) <= 8192), 10)
    bound, by, n_live, _, _ = k1_bound(units, state["ivf_vectors"], chunk_list, state["ivf_list_size"],
                                       int8_dot=True, packed=True)
    primary_ok = bool((ensure_pos_list(state)[state["ivf_inv_perm"].long()] == built["assign"]).all())
    say(f"  spilled: recall@{K} {recall!r}; QPS {qps:,.1f} ({batch_ms:.2f} ms per batch); K1 {k1_ms:.3f} ms per "
        f"{QUERY_CHUNK}-query slice ({n_live} live chunks, bound {bound:.3f} ms, {by}); K1 launches {k1_launches} "
        f"(then {k1_launches_all - k1_launches} timed), K3 {k3_launches} (then {k3_launches_all - k3_launches}); "
        f"top-{K} rows repeating an id {repeats}; ivf_inv_perm in "
        f"the top-1 list {primary_ok} [{GPU}]")
    say(f"  unspilled, same call: build {unspilled['build_s']:.2f} s = {unspilled['vecs_s']:,.0f} vecs/s; phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in unspilled["timings"].items())
        + f"; peak {unspilled['peak'] / 2**30:.2f} GiB; recall@{K} {unspilled['recall']!r}; QPS "
          f"{unspilled['qps']:,.1f}; K1 {unspilled['k1_ms']:.3f} ms per slice [{GPU}]")
    capacity_report("spill 0.05", state, cfg["n"], peak)
    capacity_table(dev, int(state["meta"]["probe_window"]))
    assert bool(torch.isfinite(dists).all()), "spilled search output is not finite"
    assert recall >= 0.99, f"spilled recall@10 {recall} below 0.99"
    assert repeats == 0, "a spilled top-10 repeats an id"
    assert primary_ok, "ivf_inv_perm does not point at each row's primary copy"
    assert k1_launches > 0, "the spilled search did not launch K1"
    assert k3_launches == -(-B // QUERY_CHUNK), "the spilled search did not launch K3 once a slice"
    return k1_launches_all, k3_launches_all


def queue3_stores_phase(dev, n: int = 131_072, nlist: int = 128) -> dict:
    """The store types the card rejected before (ROADMAP Queue 3), through
    ``TorchVS`` without ids: an f16 block-aligned IVF store (K1, f32 queries
    on f16 rows), a residual int8 IVF store at d 770 with rescore 24 (K1's
    int8 dot with a ragged last word) and an f16 Flat store under
    ``scan="pallas"`` (K2, f16 rows rounded to bf16).  Each must launch its
    kernel and reach recall@10 0.95 against exact f32.  Returns each
    store's launches by label."""
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.flat_scan import scan_fold
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_queue3_index")
    launched = {}
    for label, d, kw, fold in (
        ("f16 IVF store", 768, dict(index_type="ivf", device_dtype="float16", nlist=nlist), probe_fold),
        ("residual int8 IVF store, d 770, rescore 24", 770,
         dict(index_type="ivf", device_dtype="int8", int8_refine=True, rescore=RESCORE, nlist=nlist), probe_fold),
        ("f16 Flat store, scan='pallas'", 768, dict(index_type="flat", device_dtype="float16", scan="pallas"),
         scan_fold),
    ):
        emb_t = gen_chunk(17, 0, corpus_centers(17, 1024, d, dev), n, 2.5)
        qs = seeded_queries(emb_t, 256, 17)
        gt = exact_topk(qs, emb_t, K).tolist()
        shutil.rmtree(index_dir, ignore_errors=True)
        vs = TorchVS(device=dev, **kw)
        vs.index([], emb_t.cpu().numpy(), index_dir)
        fold.launches = 0  # this path's launches
        out = vs(qs.cpu().numpy(), K)
        launches = fold.launches
        recall = recall_at(out.indices, gt)
        plan = fold.last_plan
        say(f"  {label}: recall@{K} vs exact f32 {recall!r}; {'K1' if fold is probe_fold else 'K2'} launches "
            f"{launches}; {plan} [{GPU}]")
        assert launches > 0, f"{label}: TorchVS did not launch its kernel"
        assert recall >= 0.95, f"{label}: recall@10 {recall} below 0.95"
        launched[label] = launches
        del vs, emb_t
    shutil.rmtree(index_dir, ignore_errors=True)
    return launched


def config3_phase(dev, n: int = 1_000_000, k: int = 1024, seed_ks=(1024, 4096), q_rows: int = 65536) -> None:
    """BASELINE config 3 on the port: k-means at 1,000,000 x 768, k 1024, 10
    iterations (``benchmarks/cluster_dedup.py:18-34``: seconds, n * iters / s,
    inertia), the k-means++ seeding alone at k 1024 and 4096, and the
    self-join ``sem_dedup`` makes (``sem_dedup.py:57-60``) as the store calls
    it: a ``TorchVS`` Flat store over the same rows, ids = every row, K =
    max_neighbors + 1 = 65; then the reference's own measure, the 20k x 20k
    self-join at K 16 (``cluster_dedup.py:36-41``)."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.kmeans import _kmeanspp_init
    from lotus_tpu_torch.utils import cluster_vectors

    d, iters, kd = 768, 10, 65
    x = gen_chunk(23, 0, corpus_centers(23, max(8, int(n ** 0.5 / 4)), d, dev), n, 2.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cluster_vectors(x, k, iters, device=dev)
    used = int(torch.unique(res.assignments).numel())
    secs = time.perf_counter() - t0
    say(f"  cluster_vectors: {n:,} x {d}, k {k}, {iters} iterations: {secs:.3f} s = {n * iters / secs:,.0f} "
        f"vecs/s (n * iters / s); inertia {float(res.inertia)!r}; {used} clusters used [{GPU}]")
    if SHARDED_KMEANS:
        say(f"    beside sharded_kmeans_fit on {SHARDS} ranks sharing the card (the config-5 phase): "
            f"{SHARDED_KMEANS['secs']:.3f} s, inertia {SHARDED_KMEANS['inertia']!r} (it seeds k rows drawn at "
            f"random; cluster_vectors seeds k-means++)")
    for kk in seed_ks:
        sub = x[: max(64 * kk, 4096)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _kmeanspp_init(sub, kk, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        say(f"  k-means++ seeding, k {kk} over {sub.shape[0]:,} rows: {time.perf_counter() - t0:.3f} s [{GPU}]")
    del res

    index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_dedup_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    vs = TorchVS(index_type="flat", device=dev)
    vs.index([], x.cpu().numpy(), index_dir)
    every = list(range(n))
    q_np = x[:q_rows].cpu().numpy()
    vs(q_np[:256], kd, ids=every)  # loads the store
    t0 = time.perf_counter()
    out = vs(q_np, kd, ids=every)
    slice_s = time.perf_counter() - t0
    whole_s = slice_s * n / q_np.shape[0]
    ran = ""
    if whole_s < 20.0:
        t0 = time.perf_counter()
        vs(x.cpu().numpy(), kd, ids=every)
        ran = f"; the whole {n:,} ran in {time.perf_counter() - t0:.3f} s"
    say(f"  sem_dedup self-join (TorchVS Flat f32, ids = all {n:,} rows, K {kd}): {slice_s:.3f} s for "
        f"{q_np.shape[0]:,} query rows (host clock, results on the host) -> {whole_s:.1f} s for all {n:,} "
        f"rows, extrapolated{ran} [{GPU}]")
    # The thresholded pairs of 256 queries against exact f32, except at a
    # near-tie with the threshold or the K-th score.
    q = x[:256]
    top = torch.topk(q @ x.T, kd + 1, dim=1)
    got_s, got_i = torch.tensor(out.distances[:256]), torch.tensor(out.indices[:256])
    mismatched = 0
    for r in range(256):
        want = {int(j) for j, s in zip(top.indices[r, :kd].tolist(), top.values[r, :kd].tolist()) if s > 0.9}
        have = {int(j) for j, s in zip(got_i[r].tolist(), got_s[r].tolist()) if s > 0.9}
        edge = abs(float(top.values[r, kd - 1]) - float(top.values[r, kd])) < 1e-5 and top.values[r, kd - 1] > 0.9
        near = [s for s in top.values[r, :kd + 1].tolist() if abs(s - 0.9) < 1e-5]
        mismatched += want != have and not edge and not near
    over = top.values[:, :kd] > 0.9
    others = int((over & (top.indices[:, :kd] != torch.arange(256, device=dev)[:, None])).sum())
    say(f"  thresholded pairs (> 0.9) of 256 queries vs exact f32: {int(over.sum())} pairs ({others} with another "
        f"row), {mismatched} queries differ")
    assert mismatched == 0, "the self-join's thresholded pairs differ from exact f32"
    dedup_components(out, slice_s)
    del vs
    shutil.rmtree(index_dir, ignore_errors=True)
    sub = x[:20_000]
    flat_search(sub, sub, 16, metric="ip", block_rows=8192)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, i2 = flat_search(sub, sub, 16, metric="ip", block_rows=8192)
    i2.cpu()
    say(f"  the reference's measure, 20k x 20k self-join at K 16 (flat_search): "
        f"{1e3 * (time.perf_counter() - t0):.3f} ms [{GPU}]")


DEDUP_THRESHOLDS = (0.9, 0.875)  # the phase's own, and the median of a row's 64 same-cluster neighbours' scores


def dedup_components(out, join_s: float, thresholds=DEDUP_THRESHOLDS) -> None:
    """``sem_dedup``'s host half (``sem_dedup.py:61-70``) over the self-join's
    output ``out`` (each query row's neighbours): the pairs above the
    threshold with another row, their values numbered, and the components
    by ``lotus_tpu_torch.native.union_find`` beside the self-join's
    ``join_s`` seconds, held to the plain version (``union_find_reference``:
    the same components; its roots differ, having no union by rank)."""
    import numpy as np

    from lotus_tpu_torch import native

    t0 = time.perf_counter()
    native.lib()
    say(f"  lotus_tpu_torch.native built and loaded in {time.perf_counter() - t0:.3f} s (g++ at first use)")
    sims, nbrs = np.asarray(out.distances, np.float32).ravel(), np.asarray(out.indices, np.int64).ravel()
    rows = len(out.indices)
    left = np.repeat(np.arange(rows), len(out.indices[0]))
    for threshold in thresholds:
        keep = (sims > threshold) & (nbrs != left) & (nbrs >= 0)
        values, edges = np.unique(np.stack([left[keep], nbrs[keep]], 1), return_inverse=True)
        edges = edges.reshape(-1, 2)
        t0 = time.perf_counter()
        labels = native.union_find(edges, len(values))
        uf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = native.union_find_reference(edges, len(values))
        plain_s = time.perf_counter() - t0
        n_comp = len(np.unique(labels))
        same = n_comp == len(np.unique(plain)) == len(np.unique(np.stack([labels, plain], 1), axis=0))
        say(f"  sem_dedup's union-find at threshold {threshold} over the {rows:,} query rows' pairs: {len(edges):,} "
            f"edges over {len(values):,} values -> {n_comp:,} components ({len(values) - n_comp:,} values removed); "
            f"union_find {1e3 * uf_s:.3f} ms (host) beside the self-join's {join_s:.3f} s; the plain version "
            f"{1e3 * plain_s:.1f} ms, components {'equal' if same else 'DIFFER'} [{GPU}]")
        assert same, "native.union_find's components differ from its plain version's"


def ids_store_runs(label: str, vs, q, k: int, ids, device_fn, gt) -> float:
    """One ids path: recall of the store call against ``gt``, its warm
    host-clock ms, and the device ms of its search function (CUDA events)."""
    out = vs(q.cpu().numpy(), k, ids=ids)
    got = out.indices
    recall = float(sum(len(set(a) & set(b)) for a, b in zip(got, gt)) / (k * len(gt)))
    host = host_ms(lambda: vs(q.cpu().numpy(), k, ids=ids))
    dev_ms = cuda_ms(device_fn, 3)
    say(f"  {label}: recall@{k} {recall!r}; {host:.3f} ms warm (host clock), {dev_ms:.3f} ms on the device "
        f"(CUDA events) [{GPU}]")
    return recall


def ids_path_phase(dev, shapes=((10_000, 384, 1), (100_000, 768, 100_000))) -> None:
    """The ids path the pandas operators take (``sem_search`` and
    ``sem_sim_join`` always pass ``ids``): config 1's shape (10,000 x 384
    Flat, one query a call, ids = every row; recall@10 must be 1.0) and
    config 2's (100,000 x 100,000 x 768, k 5: pair recall against the full
    exact oracle)."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.flat import flat_search

    index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_ids_index")
    (n1, d1, _), (n2, d2, nq2) = shapes
    for cfg, n, d, nq, k, seed in (("config 1 (sem_search)", n1, d1, 1, K, 29),
                                   ("config 2 (sem_sim_join)", n2, d2, nq2, 5, 31)):
        centers = corpus_centers(seed, max(8, int(n ** 0.5 / 4)), d, dev)
        rows = gen_chunk(seed, 0, centers, n, 2.5)
        q = gen_chunk(seed, 1, centers, nq, 2.5) if nq > 1 else seeded_queries(rows, 64, seed)
        shutil.rmtree(index_dir, ignore_errors=True)
        vs = TorchVS(index_type="flat", device=dev)
        vs.index([], rows.cpu().numpy(), index_dir)
        every = list(range(n))
        state = vs._materialize()
        gt = exact_topk(q, rows, k).tolist()
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        if nq == 1:  # one query a call, as sem_search makes them
            ids = [i for row in q for i in vs(row[None].cpu().numpy(), k, ids=every).indices[0]]
            recall = recall_at([ids[i * k : (i + 1) * k] for i in range(q.shape[0])], gt)
            ids_store_runs(f"{cfg}: {n:,} x {d} Flat, B 1, ids = every row", vs, q[:1], k, every,
                           lambda: flat_search(state["xb"], q[:1], k, n_rows=n, valid=valid), gt[:1])
            say(f"    recall@{k} over {q.shape[0]} single-query calls {recall!r}")
            assert recall == 1.0, f"{cfg}: recall@10 {recall} is not 1.0"
        else:
            recall = ids_store_runs(f"{cfg}: {nq:,} x {n:,} x {d}, k {k}, ids = every right row", vs, q,
                                    k, every, lambda: flat_search(state["xb"], q, k, n_rows=n, valid=valid), gt)
            say(f"    pair recall against the full exact oracle {recall!r} ({nq * k:,} pairs)")
            assert recall >= 0.999, f"{cfg}: pair recall {recall}"
        del vs, state, rows, q
    shutil.rmtree(index_dir, ignore_errors=True)


def ivf_ids_phase(state, xq, n_ids: int = 1 << 16) -> None:
    """A config-4 IVF store searched with ids (``TorchVS._ivf_subset_search``,
    the f32 reconstruction of the allowed rows) at |ids| = 2**16, B 1 and
    256: device ms, and the transient peak beside the capacity model's
    ``subset_bytes``; only allowed ids may come back."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops import capacity

    n = int(state["meta"]["n"])
    ids = sorted(torch.randperm(n, generator=torch.Generator().manual_seed(5))[:n_ids].tolist())
    vs = TorchVS(index_type="ivf", device=state["centroids"].device)
    model = capacity.subset_bytes(len(ids), state["ivf_vectors"].shape[1], torch.int8, residual=True)
    for b in (1, 256):
        q = xq[:b]
        (_, got), peak = transient_peak(lambda: vs._ivf_subset_search(state, q, K, ids))
        ms = cuda_ms(lambda: vs._ivf_subset_search(state, q, K, ids), 3)
        say(f"  config 4 with ids, |ids| = {len(ids):,}, B {b}: {ms:.3f} ms on the device (CUDA events); transient "
            f"peak {peak / 2**30:.3f} GiB (model {model / 2**30:.3f} GiB); ids in the allowed set "
            f"{set(got.flatten().tolist()) <= set(ids)} [{GPU}]")
        assert set(got.flatten().tolist()) <= set(ids), "an ids search returned an id outside ids"


# ---------------------------------------------------------------------------
# Config 5's lifecycle on SHARDS ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

SHARDS = 4  # ranks of the config-5 phase, all on this card under gloo
CONFIG5_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_config5")
# Sizes the ranks run at: config 4's search settings over its shards, the
# reference's window-regime store (as in the window-regime phase) and
# config 3's k-means shape, 250,000 rows a rank in blocks of 15,625 so a
# rank's blocks are the one-process step's blocks.
CONFIG5 = dict(device="cuda", nprobe=NPROBE, rescore=RESCORE, query_chunk=QUERY_CHUNK, store_n=200_000,
               store_nlist=512, store_nprobe=32, d=768, km_n=1_000_000, km_k=1024, km_iters=10, km_block=15_625)
RANK_TIMEOUT = 600  # seconds the ranks may take together before they are killed
SHARDED_KMEANS: dict = {}  # the ranks' k-means figures, printed beside config 3's cluster_vectors


def write_config5_shards(state, xq, gt, io: str = CONFIG5_DIR) -> None:
    """Config 5's first half on config 4's store, still on the card:
    ``save_ivf_shards`` writes SHARDS shards (planned one at a time on the
    card) beside the ``ivf_centroids``,
    ``ivf_list_size`` and ``meta.json`` that ``load_sharded_ivf_state``
    reads, with the queries and the exact f32 oracle the ranks use."""
    import numpy as np

    from lotus_tpu_torch.ops import io as index_io
    from lotus_tpu_torch.parallel import save_ivf_shards

    shutil.rmtree(io, ignore_errors=True)
    os.makedirs(io)
    by_shape = sum(t.nbytes for k, t in state.items()
                   if k in ("ivf_vectors", "ivf_row_ids", "ivf_row_scales"))
    say(f"  free disk {shutil.disk_usage(io).free / 2**30:.1f} GiB at {os.path.relpath(io, REPO)}; the shards "
        f"take about {by_shape / 2**30:.1f} GiB by shape")
    t0 = time.perf_counter()
    save_ivf_shards(io, state, SHARDS)
    index_io.write_array(io, "ivf_centroids", state["centroids"].cpu().numpy())
    index_io.write_array(io, "ivf_list_size", state["ivf_list_size"].cpu().numpy())
    index_io.write_meta(io, {"kind": "ivf", **state["meta"]})
    np.save(os.path.join(io, "queries.npy"), xq.cpu().numpy())
    np.save(os.path.join(io, "gt.npy"), gt)
    written = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(io) for f in fs)
    say(f"  save_ivf_shards: {SHARDS} shards, {written / 1e9:.3f} GB written in {time.perf_counter() - t0:.2f} s "
        f"[{GPU}]")


def emulate_config5(state, xq, io: str = CONFIG5_DIR) -> dict:
    """What the SHARDS ranks must return, computed in this process: each
    shard of config 4's store built on the card in turn
    (``shard_ivf_state``), its local top-k (``local_grouped_probe``) and the
    merge; saved for the ranks' results to be held to.  Beside it, the
    single-device grouped probe without the int4 refinement, whose rescore
    rebuilds rows as the shards' does.
    These launches are comparisons, not a main path."""
    import numpy as np
    import torch

    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe
    from lotus_tpu_torch.parallel import ShardMesh, shard_ivf_state
    from lotus_tpu_torch.parallel.ivf import local_grouped_probe

    kw = dict(nprobe=NPROBE, metric="ip", int8_queries=True, rescore=RESCORE)
    cand_s, cand_i = [], []
    for slot in range(SHARDS):
        sharded = shard_ivf_state(state, ShardMesh(None, list(range(SHARDS)), slot, xq.device))
        parts = [local_grouped_probe(sharded, xq[lo : lo + QUERY_CHUNK], K, **kw)
                 for lo in range(0, xq.shape[0], QUERY_CHUNK)]
        cand_s.append(torch.cat([p[0] for p in parts]))
        cand_i.append(torch.cat([p[1] for p in parts]))
        del sharded, parts
    top_s, pos = torch.topk(torch.cat(cand_s, 1), K, dim=1)
    top_i = torch.gather(torch.cat(cand_i, 1), 1, pos)
    np.save(os.path.join(io, "emulated_ids.npy"), top_i.cpu().numpy())
    np.save(os.path.join(io, "emulated_scores.npy"), top_s.cpu().numpy())
    plain = {k: v for k, v in state.items() if k not in ("ivf_refine", "ivf_refine_scales")}
    _, ids = ivf_search_grouped_probe(plain, xq, K, query_chunk=QUERY_CHUNK, **kw)
    return dict(emulated=top_i.cpu().numpy(), no_refine_ids=ids.cpu().numpy())


def launch_ranks(io: str, world: int) -> list[dict]:
    """Start ``world`` ranks of this script as ``torchrun`` would (a free
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), wait for them
    and return their reports.  A rank that fails stops the others; every
    rank is gone when this returns."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world))
    logs = [open(os.path.join(io, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", io],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        for r in range(world):
            with open(os.path.join(io, f"rank{r}.log")) as f:
                say(f"  rank {r} exited {codes[r]}; the end of its log:\n" + f.read()[-3000:])
        raise AssertionError(f"config 5: ranks exited {codes}")
    reports = []
    for r in range(world):
        with open(os.path.join(io, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def config5_phase(single: dict, io: str = CONFIG5_DIR, cfg: dict = CONFIG5) -> int:
    """Config 5's lifecycle on SHARDS ranks sharing this card under gloo:
    each loads only its shard and serves config 4's search, then a
    ``TorchVS(mesh=...)`` store and sharded k-means (``rank_main``).  Checks
    their reports (each rank's config-4 result against ``emulate_config5``'s,
    written in ``io``) and returns K1's launches on the sharded main path,
    over all ranks.  ``single``: phase 5's recall and the single device's
    without the int4 refinement."""
    import numpy as np

    from lotus_tpu_torch.ops import _kernels

    if cfg["device"] == "cuda":
        _kernels.lib()  # built: the ranks load the library by its hash and never run nvcc
    with open(os.path.join(io, "config.json"), "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    reports = launch_ranks(io, SHARDS)
    say(f"  {SHARDS} ranks ran in {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"rank {r['rank']} on {r['device']} ({r['backend']})" for r in reports))
    label = f"{SHARDS} ranks sharing one card, not a multi-card figure"
    for r in reports:
        a = r["a"]
        say(f"  rank {r['rank']}: loaded its shard in {a['load_s']:.2f} s; resident {a['resident'] / 2**30:.3f} GiB, "
            f"the plan's {a['plan'] / 2**30:.3f} GiB; K1 launches {a['launches']}; local candidates "
            f"{a['live_local']:,}, all in owned lists {a['owned_ok']}; peak {a['peak'] / 2**30:.2f} GiB [{GPU}]")
    a = reports[0]["a"]
    want = np.load(os.path.join(io, "emulated_ids.npy"))
    want_s = np.load(os.path.join(io, "emulated_scores.npy"))
    differ = [sets_differ(np.load(os.path.join(io, f"ids_rank{r['rank']}.npy")).tolist(), want.tolist(),
                          np.load(os.path.join(io, f"scores_rank{r['rank']}.npy")).tolist(), want_s.tolist())
              for r in reports]
    say(f"  sharded config 4 (sharded_ivf_search_pallas, nprobe {cfg['nprobe']}, rescore {cfg['rescore']}, int8 "
        f"queries, query_chunk {cfg['query_chunk']}): recall@{K} vs exact f32 {a['recall']!r} (the shards "
        f"rescore with no int4 refinement, as the reference's); single device: {single['recall']!r} (phase 5, "
        f"with the refinement), {single['no_refine']!r} without it; ids from two ranks' local top-{K}: "
        f"{sum(r['a']['dup'] for r in reports)}; finite {a['finite']}; queries whose sets differ from the "
        f"one-process run of the same {SHARDS} shards, past a near-tie, by rank: {differ}")
    say(f"  chained QPS {a['qps']:,.1f} ({a['ms']:.2f} ms per {B}-query batch; slowest rank "
        f"{max(r['a']['ms'] for r in reports):.2f} ms) -- {label}; the merge's all-gathers take "
        f"{a['gather_s'] * 1e3:.3f} ms per batch, one of 8 x {K} scores {a['small_gather_s'] * 1e3:.3f} ms "
        f"(gloo) [{GPU}]")
    b = reports[0]["b"]
    for bb, run in b["runs"].items():
        say(f"  TorchVS(mesh) window-regime store, B={bb}: {run['route'].replace('_', ' ')}; recall@{K} "
            f"{run['recall']!r} over {WINDOW_NQ} queries (single-device store {run['solo_recall']!r}, sets differing "
            f"past a near-tie {run['mismatched']}); {run['ms']:.3f} ms per call warm (host clock) -- {label} [{GPU}]")
    say(f"  TorchVS(mesh): state shard-only {b['shard_only']}; ids search through _disk_subset_search: only "
        f"allowed ids {b['sub_allowed']}, equal to exact f32 over the allowed rows {b['sub_exact']}; Flat store "
        f"with a mesh: recall@{K} {b['flat_recall']!r} without ids, with ids only allowed {b['flat_sub_allowed']} and "
        f"exact {b['flat_sub_exact']}; K1 launches {b['k1']}")
    c = reports[0]["c"]
    SHARDED_KMEANS.update(c)
    say(f"  sharded_kmeans_fit: {cfg['km_n']:,} x {cfg['d']}, k {cfg['km_k']}, {cfg['km_iters']} iterations on "
        f"{SHARDS} ranks: {c['secs']:.3f} s; inertia {c['inertia']!r}; {c['used']} clusters used -- {label} [{GPU}]")
    say(f"  one Lloyd step from the same centroids against one process on the card: counts equal "
        f"{c['counts_equal']}; sums within 1e-4*(1+|x|) {c['sums_ok']} (max abs err {c['max_err']!r}); "
        f"score rel err {c['score_rel']!r}")
    launches = sum(r["a"]["launches"] for r in reports)
    for r in reports:
        assert r["device"].startswith(cfg["device"]), f"rank {r['rank']} ran on {r['device']}"
        assert r["a"]["resident"] == r["a"]["plan"], f"rank {r['rank']}: resident bytes differ from the plan's"
        assert r["a"]["owned_ok"], f"rank {r['rank']}: a local candidate lies in a list it does not own"
        assert cfg["device"] != "cuda" or r["a"]["launches"] > 0, f"rank {r['rank']} did not launch K1"
    assert a["finite"], "sharded search output is not finite or has the wrong shape"
    assert not any(differ), "a rank's sharded search differs from the one-process run of the same shards"
    # The reference's own sharded gate (tests/test_parallel.py:508): its
    # shards rescore without the int4 refinement, so BASELINE's 0.99 is the
    # single device's bar, not theirs.
    assert a["recall"] >= 0.95, f"sharded recall@10 {a['recall']} below 0.95"
    assert sum(r["a"]["dup"] for r in reports) == 0, "an id came back from two ranks on an unspilled store"
    for bb, run in b["runs"].items():
        assert run["served"], f"TorchVS(mesh) B={bb} took another route"
        assert run["mismatched"] == 0, f"TorchVS(mesh) B={bb} differs from the single-device store"
    assert b["shard_only"] and b["sub_allowed"] and b["sub_exact"], "the ids path on the shard-only state"
    assert b["flat_recall"] >= 0.999 and b["flat_sub_allowed"] and b["flat_sub_exact"], "the Flat store with a mesh"
    assert b["k1"] == 0, "the unaligned store launched K1"
    assert c["counts_equal"] and c["sums_ok"], "the sharded Lloyd step differs from the one-process step"
    return launches


# ---- the rank side (``chip_smoke.py --rank <dir>``) ------------------------


def sets_differ(a, b, da, db, tol: float = 1e-5) -> int:
    """Queries whose top-k sets differ, except where the two sets' lowest
    scores agree within ``tol`` (a near-tie at the k-th place)."""
    return sum(set(x) != set(y) and abs(min(u) - min(v)) > tol for x, y, u, v in zip(a, b, da, db))


def rank_config4_search(io: str, mesh, cfg: dict) -> dict:
    """This rank's shard of config 4: load it alone, run the sharded grouped
    probe over config 4's queries (K1's launches counted over that run),
    check its local top-k, and time the chained search and the all-gathers."""
    import numpy as np
    import torch

    from lotus_tpu_torch.ops.io import read_array, read_meta
    from lotus_tpu_torch.ops.ivf_probe import probe_fold
    from lotus_tpu_torch.parallel import load_sharded_ivf_state, sharded_ivf_search_pallas
    from lotus_tpu_torch.parallel.distributed import load_index_shard
    from lotus_tpu_torch.parallel.ivf import local_grouped_probe

    dev = mesh.device
    t0 = time.perf_counter()
    sharded = load_sharded_ivf_state(io, read_meta(io), mesh)
    sync(dev)
    load_s = time.perf_counter() - t0
    resident = sum(t.nbytes for t in sharded.values() if isinstance(t, torch.Tensor))
    plan = sum(a.nbytes for a in load_index_shard(io, mesh.slot).values()) + sum(
        read_array(io, name).nbytes for name in ("ivf_centroids", "ivf_list_size"))
    xq = torch.from_numpy(np.load(os.path.join(io, "queries.npy"))).to(dev)
    gt = np.load(os.path.join(io, "gt.npy"))
    kw = dict(nprobe=cfg["nprobe"], metric="ip", int8_queries=True, rescore=cfg["rescore"])

    def search(q):
        return sharded_ivf_search_pallas(sharded, q, K, query_chunk=cfg["query_chunk"], **kw)

    probe_fold.launches = 0  # the sharded main path's launches
    dists, ids = search(xq)
    sync(dev)
    launches = probe_fold.launches
    recall = recall_at(ids.cpu().numpy(), gt)
    finite = bool(torch.isfinite(dists).all()) and tuple(ids.shape) == (xq.shape[0], K)
    owned_ok, dup, live_local = True, 0, 0
    for lo in range(0, xq.shape[0], cfg["query_chunk"]):
        q = xq[lo : lo + cfg["query_chunk"]]
        _, local, rows = local_grouped_probe(sharded, q, K, **kw)
        live = local >= 0
        live_local += int(live.sum())
        owned_ok &= bool(sharded["owned"][sharded["row_list"][rows[live].long()].long()].all())
        every = torch.sort(mesh.all_gather(local).permute(1, 0, 2).reshape(q.shape[0], -1), dim=1).values
        dup += int(((every[:, 1:] == every[:, :-1]) & (every[:, 1:] >= 0)).sum())
    np.save(os.path.join(io, f"ids_rank{mesh.slot}.npy"), ids.cpu().numpy())
    np.save(os.path.join(io, f"scores_rank{mesh.slot}.npy"), dists.cpu().numpy())
    mesh.barrier()
    qps, ms = chained_qps(lambda: search(xq), xq.shape[0], dev)
    # The merge's collectives alone (the all-gathers of a slice's
    # (query_chunk, K) f32 scores and int32 ids), and one of 8 x K scores:
    # gloo's latency.
    times = {}
    slices = xq.shape[0] // cfg["query_chunk"]
    for name, parts, per_batch in (
        ("merge", [torch.zeros((cfg["query_chunk"], K), device=dev),
                   torch.zeros((cfg["query_chunk"], K), dtype=torch.int32, device=dev)], slices),
        ("small", [torch.zeros((8, K), device=dev)], 1),
    ):
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(5 * per_batch):
            for t in parts:
                mesh.all_gather(t)
        sync(dev)
        times[name] = (time.perf_counter() - t0) / 5
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del sharded
    return dict(load_s=load_s, resident=resident, plan=plan, launches=launches, recall=recall,
                finite=finite, owned_ok=owned_ok, dup=dup, live_local=live_local, qps=qps, ms=ms,
                gather_s=times["merge"], small_gather_s=times["small"], peak=peak)


def rank_store(io: str, mesh, cfg: dict) -> dict:
    """``TorchVS(mesh=...)`` end to end on the reference's window-regime
    store (as the window-regime phase builds it): ``index()`` on every rank
    (rank 0 writes the vectors, the IVF lists and the shards), a fresh store
    loads, B 1 and 8 through the sharded window probe and B 64 through the
    route ``TpuVS`` takes (the sharded scan), each beside a single-device
    store over the same files; an ids search on the shard-only state; a
    Flat store with a mesh, with ids and without."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    dev, n, d = mesh.device, cfg["store_n"], cfg["d"]
    emb_t = gen_chunk(13, 0, corpus_centers(13, 4096, d, dev), n, 2.5)
    g = torch.Generator(device=dev).manual_seed(13)
    qs = emb_t[torch.randint(0, n, (WINDOW_NQ,), generator=g, device=dev)]
    qs = qs + 0.05 * torch.randn((WINDOW_NQ, d), generator=g, device=dev)
    qs = qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)
    gt = torch.topk(qs @ emb_t.T, K, dim=1).indices.cpu().numpy()
    emb, qs_np = emb_t.cpu().numpy(), qs.cpu().numpy()
    k1_before = probe_fold.launches
    store_dir = os.path.join(io, "store")
    kw = dict(index_type="ivf", nlist=cfg["store_nlist"], nprobe=cfg["store_nprobe"])
    TorchVS(mesh=mesh, **kw).index([], emb, store_dir)
    vs = TorchVS(mesh=mesh, **kw)
    vs.load_index(store_dir)
    solo = TorchVS(device=dev, **kw)
    solo.load_index(store_dir)
    runs = {}
    for b, route in ((1, "window_probe"), (8, "window_probe"), (64, "scan")):
        before = dict(vs.stats["routes"])
        outs = [vs(qs_np[lo : lo + b], K) for lo in range(0, WINDOW_NQ, b)]
        served = {r: vs.stats["routes"][r] - before[r] for r in before}
        solos = [solo(qs_np[lo : lo + b], K) for lo in range(0, WINDOW_NQ, b)]
        ids = [row for o in outs for row in o.indices]
        solo_ids = [row for o in solos for row in o.indices]
        runs[b] = dict(route=route, served=served == {**dict.fromkeys(before, 0), route: WINDOW_NQ // b},
                       recall=recall_at(ids, gt), solo_recall=recall_at(solo_ids, gt),
                       mismatched=sets_differ(ids, solo_ids, [r for o in outs for r in o.distances],
                                              [r for o in solos for r in o.distances]),
                       ms=host_ms(lambda b=b: vs(qs_np[:b], K)))
    shard_only = "ivf_sharded" in vs._state and "ivf_vectors" not in vs._state
    allowed = sorted(torch.randperm(n, generator=torch.Generator().manual_seed(3))[:1000].tolist())
    allowed_t = torch.tensor(allowed, device=dev)
    want = allowed_t[torch.topk(qs[:4] @ emb_t[allowed_t].T, K, dim=1).indices].tolist()
    want_d = torch.topk(qs[:4] @ emb_t[allowed_t].T, K, dim=1).values.tolist()
    sub = vs(qs_np[:4], K, ids=allowed)
    flat = TorchVS(index_type="flat", mesh=mesh)
    flat.index([], emb, os.path.join(io, "flat"))
    flat_out = flat(qs_np, K)
    flat_sub = flat(qs_np[:4], K, ids=allowed)
    allowed_set = set(allowed)
    return dict(
        runs=runs, shard_only=shard_only,
        sub_allowed=all(i in allowed_set for row in sub.indices for i in row),
        sub_exact=sets_differ(sub.indices, want, sub.distances, want_d) == 0,
        flat_recall=recall_at(flat_out.indices, gt),
        flat_sub_allowed=all(i in allowed_set for row in flat_sub.indices for i in row),
        flat_sub_exact=sets_differ(flat_sub.indices, want, flat_sub.distances, want_d) == 0,
        k1=probe_fold.launches - k1_before,
    )


def rank_kmeans(io: str, mesh, cfg: dict) -> dict:
    """Sharded k-means at config 3's shape: each rank makes the seeded
    corpus of config 3's phase and keeps its rows; ``sharded_kmeans_fit``
    (seconds, inertia); then one Lloyd step from the same centroids on the
    ranks, held by rank 0 against one process's step over all rows."""
    import torch

    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk
    from lotus_tpu_torch.parallel import shard_rows, sharded_kmeans_fit
    from lotus_tpu_torch.parallel.kmeans import _local_stats, lloyd_step

    dev, n, k, br = mesh.device, cfg["km_n"], cfg["km_k"], cfg["km_block"]
    x = gen_chunk(23, 0, corpus_centers(23, max(8, int(n ** 0.5 / 4)), cfg["d"], dev), n, 2.5)
    x_local = shard_rows(x, mesh)[0].clone()
    if mesh.slot != 0:
        del x
    n_local = min(max(n - mesh.slot * x_local.shape[0], 0), x_local.shape[0])
    mesh.barrier()
    sync(dev)
    t0 = time.perf_counter()
    res = sharded_kmeans_fit(x_local, k, n_rows=n, mesh=mesh, iters=cfg["km_iters"], seed=0, block_rows=br)
    sync(dev)
    secs = time.perf_counter() - t0
    c0 = sharded_kmeans_fit(x_local, k, n_rows=n, mesh=mesh, iters=0, seed=0, block_rows=br).centroids
    (sums, counts, score), _ = lloyd_step(x_local, c0, n_local=n_local, k=k, metric="l2", mesh=mesh, block_rows=br)
    out = dict(secs=secs, inertia=float(res.inertia), used=int(torch.unique(res.assignments).numel()))
    if mesh.slot == 0:
        s1, c1, sc1 = _local_stats(x, c0, n, k, "l2", br)
        out.update(counts_equal=bool(torch.equal(counts, c1)),
                   sums_ok=bool(((sums - s1).abs() <= 1e-4 * (1 + s1.abs())).all()),
                   max_err=float((sums - s1).abs().max()), score_rel=float(abs(score - sc1) / abs(sc1)))
    return out


def rank_main(io: str) -> int:
    """One rank of the config-5 phase, started by ``launch_ranks``."""
    import torch

    sys.path.insert(0, REPO)
    with open(os.path.join(io, "config.json")) as f:
        cfg = json.load(f)
    if cfg["device"] == "cuda" and not torch.cuda.is_available():
        print("rank: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from lotus_tpu_torch.parallel import init_runtime, serving_mesh

    assert init_runtime(), "rank: no torchrun environment"
    mesh = serving_mesh(device=None if cfg["device"] == "cuda" else cfg["device"])
    report = {"rank": mesh.slot, "device": str(mesh.device), "backend": dist.get_backend()}
    report["a"] = rank_config4_search(io, mesh, cfg)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    report["b"] = rank_store(io, mesh, cfg)
    report["c"] = rank_kmeans(io, mesh, cfg)
    with open(os.path.join(io, f"rank{mesh.slot}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The models (M9) at published widths, configs 1 and 2 from text, profiling
# ---------------------------------------------------------------------------

MODELS_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_models")
TEXT_INDEX_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_text_index")
VOCAB_SIZE = 30_522  # bert-base-uncased's vocabulary size, which all three models share
# Each model's published widths (its config.json; max_seq_length from its
# sentence-transformers config, or flax_rm.py:48), with seeded weights.
MODELS = {
    "all-MiniLM-L6-v2": dict(num_hidden_layers=6, hidden_size=384, num_attention_heads=12,
                             intermediate_size=1536, max_seq_length=256),
    "e5-base-v2": dict(num_hidden_layers=12, hidden_size=768, num_attention_heads=12,
                       intermediate_size=3072, max_seq_length=512),
    "ms-marco-MiniLM-L-6-v2": dict(num_hidden_layers=6, hidden_size=384, num_attention_heads=12,
                                   intermediate_size=1536, max_seq_length=512, num_labels=1),
}
# The synthetic corpus's topic structure.  The seeded weights put every text
# near one common direction (for text without topics a mean pairwise cosine
# of 0.99 and k-th to (k+1)-th score gaps of 2e-5, under bf16's rounding), and
# they order texts by length before content, so k-means over config 2's
# embeddings made lists of one length: with texts of a topic at random
# lengths, a query's nearest texts lay in unprobed lists (recall@5 0.808
# through the coarse ranking alone at nprobe 32 of 128; 0.981 with the
# topic's texts at one length, on an H100).  So each topic has exactly k
# texts at about one length, which draw ON_TOPIC of their words from the
# topic's TOPIC_WORDS: a query's k nearest texts are its topic's, with a
# median gap of 2e-2 below them.
TOPIC_WORDS, ON_TOPIC = 4, 0.9
# max_batch_size of config 2's encoder: the documented setting's
# (docs/api/configurations.md:43, flax_rm.py's default).  Its docs of 8-48
# words are short, so the right side is encoded once more at CONFIG2_WIDE_BATCH
# a batch, four times the work a forward for the same launches, and both
# figures are printed.
CONFIG2_BATCH, CONFIG2_WIDE_BATCH = 64, 256


def recording(plain):
    """A stand-in for a kernel's wrapper that records the arguments of each
    call and answers through ``plain``, the kernel's plain version, so it
    launches nothing.  Returns (the stand-in, its list of (args, kwargs))."""
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return plain(*args, **kw)

    return record, calls


def smoke_vocab(seed: int = 0, size: int = VOCAB_SIZE) -> list[str]:
    """A seeded ``size``-entry WordPiece vocabulary in bert-base-uncased's
    layout: ``[PAD]``, ``[unused*]``, ``[UNK]`` ``[CLS]`` ``[SEP]``
    ``[MASK]`` at 100-103, single characters and their ``##`` forms, then
    seeded whole words (3-10 letters) and ``##`` pieces (2-4 letters); a
    larger ``size`` extends the smaller one's list."""
    import string

    import numpy as np

    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = string.punctuation + string.digits + string.ascii_lowercase
    vocab += list(chars) + ["##" + c for c in string.digits + string.ascii_lowercase]
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    seen = set(vocab)
    while len(vocab) < size:
        piece = rng.random() < 0.15
        tok = ("##" if piece else "") + "".join(rng.choice(letters, rng.integers(2, 5) if piece else rng.integers(3, 11)))
        if tok not in seen:
            seen.add(tok)
            vocab.append(tok)
    return vocab


def write_safetensors(path: str, tensors: dict) -> None:
    """f32 tensors as a ``.safetensors`` file (header padded to 8 bytes)."""
    import struct

    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().float().contiguous().cpu().numpy().data)


def write_models(vocab: list[str], dev, seed: int = 0) -> dict[str, str]:
    """One checkpoint directory per model under MODELS_DIR: ``config.json``,
    ``vocab.txt``, ``tokenizer_config.json`` and ``model.safetensors`` with
    weights drawn as BERT's initialiser draws them (N(0, 0.02), biases 0,
    LayerNorm 1 / 0), made on ``dev``.  Returns the directories."""
    import torch

    from lotus_tpu_torch.models import BertConfig, BertForSequenceClassification, BertModel

    dirs = {}
    for i, (name, shape) in enumerate(MODELS.items()):
        d = os.path.join(MODELS_DIR, name)
        os.makedirs(d, exist_ok=True)
        widths = {k: v for k, v in shape.items() if k not in ("max_seq_length", "num_labels")}
        config = dict(model_type="bert", vocab_size=len(vocab), max_position_embeddings=512, type_vocab_size=2,
                      hidden_act="gelu", layer_norm_eps=1e-12, **widths)
        if "num_labels" in shape:
            config["id2label"] = {str(j): f"LABEL_{j}" for j in range(shape["num_labels"])}
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(vocab) + "\n")
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, f)
        cfg = BertConfig.from_dict(config)
        with torch.device(dev):
            module = BertForSequenceClassification(cfg) if "num_labels" in shape else BertModel(cfg)
        g = torch.Generator(device=dev).manual_seed(seed + i)
        with torch.no_grad():
            for pname, p in module.named_parameters():
                if "LayerNorm" in pname:
                    p.fill_(1.0 if pname.endswith("weight") else 0.0)
                elif pname.endswith("bias"):
                    p.zero_()
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
        write_safetensors(os.path.join(d, "model.safetensors"), module.state_dict())
        dirs[name] = d
        del module
    return dirs


def synth_texts(vocab: list[str], n: int, lo: int, hi: int, seed: int, per_topic: int = 10) -> list[str]:
    """``n`` seeded texts of ``lo``-``hi`` words on ``n // per_topic`` topics,
    ``per_topic`` texts each (a seeded shuffle; the same topics for the same
    ``n``, ``per_topic`` and lengths).  A topic has one length, its texts
    within two words of it, and a text draws each word with probability
    ON_TOPIC from its topic's TOPIC_WORDS, else from the whole vocabulary;
    one word in 20 is two words run together, which WordPiece splits into
    ``##`` pieces."""
    import numpy as np

    words = np.array([w for w in vocab if w.isalpha() and len(w) > 2 and not w.startswith("[")], dtype=object)
    topics = max(1, n // per_topic)
    topic_rng = np.random.default_rng(12345)
    topic_words = topic_rng.integers(0, len(words), (topics, TOPIC_WORDS))
    topic_len = topic_rng.integers(lo + 2, hi - 1, topics)
    rng = np.random.default_rng(seed)
    doc_topic = rng.permutation(n) % topics
    lengths = topic_len[doc_topic] + rng.integers(-2, 3, n)
    total = int(lengths.sum())
    topic = np.repeat(doc_topic, lengths)
    idx = np.where(rng.random(total) < ON_TOPIC, topic_words[topic, rng.integers(0, TOPIC_WORDS, total)],
                   rng.integers(0, len(words), total))
    flat = words[idx]
    joined = rng.random(total) < 0.05
    flat[joined] = flat[joined] + words[rng.integers(0, len(words), int(joined.sum()))]
    cuts = np.cumsum(lengths)[:-1]
    return [" ".join(ws).capitalize() + "." for ws in np.split(flat, cuts)]


def forward_weights(enc) -> int:
    """The parameters a token's forward multiplies by: every non-embedding
    one (an encoder-decoder's ``shared`` tokens, a decoder's ``wte``,
    ``wpe``, ``embed_tokens`` or ``word_embeddings`` and position tables are
    gathers), but
    ALBERT's shared groups once for each layer that runs them."""
    groups = getattr(getattr(enc, "encoder", None), "albert_layer_groups", None)
    if groups is None:
        return sum(p.numel() for name, p in enc.named_parameters()
                   if not name.startswith(("embeddings.", "shared.", "wte.", "wpe.", "embed_tokens.",
                                           "word_embeddings."))
                   and "embed_positions" not in name)
    cfg = enc.config
    sizes = [sum(p.numel() for p in g.parameters()) for g in groups]
    runs = [int(i / (cfg.num_hidden_layers / cfg.num_hidden_groups)) for i in range(cfg.num_hidden_layers)]
    return sum(p.numel() for p in enc.encoder.embedding_hidden_mapping_in.parameters()) + sum(sizes[g] for g in runs)


def attention_pairs(cfg, s: int) -> int:
    """The (query, key) pairs one sequence of ``s`` tokens scores: s * s,
    or BigBird's block-sparse pattern (the first and last query blocks over
    all s keys, the second and second-last over 4 + r blocks, the middle
    ones over 5 + r)."""
    if getattr(cfg, "attention_type", "original_full") != "block_sparse":
        return s * s
    bs, r = cfg.block_size, cfg.num_random_blocks
    return 2 * bs * s + 2 * bs * (4 + r) * bs + (s // bs - 4) * bs * (5 + r) * bs


def seq2seq_pairs(cfg, s):
    """The (query, key) pairs, summed over the layers, that an
    encoder-decoder scores for a sequence of ``s`` tokens (a number or a
    tensor of lengths): each encoder layer s * s, each decoder layer its
    causal s * (s + 1) / 2 and the cross-attention's s * s."""
    return cfg.encoder_layers * s * s + cfg.decoder_layers * (s * (s + 1) / 2 + s * s)


def decoder_attention(cfg) -> tuple[int, int] | None:
    """A decoder's (layers, query heads x head size), or None for an
    encoder or an encoder-decoder."""
    if hasattr(cfg, "n_layer"):  # GPT-2, GPT-J, BLOOM
        return cfg.n_layer, cfg.hidden_size
    if hasattr(cfg, "head_size"):  # Llama, Mistral, Gemma
        return cfg.num_hidden_layers, cfg.num_attention_heads * cfg.head_size
    if hasattr(cfg, "attention_types"):  # GPT-Neo
        return cfg.num_layers, cfg.hidden_size
    if hasattr(cfg, "attention_heads"):  # XGLM
        return cfg.num_layers, cfg.d_model
    return None


def encode_split(rm, texts: list[str]):
    """``rm(texts)``, what ``sem_index`` calls, and its time split: host
    seconds in the tokenizer, device ms of the encoder's forwards (CUDA
    events around each, by module hooks), wall seconds; real and padded
    tokens; the forwards' operations (2 x ``forward_weights`` a token, plus
    attention's 4 * L * h a scored pair, ``attention_pairs``; an
    encoder-decoder's 4 * d_model a pair of ``seq2seq_pairs``, both stacks
    and the cross-attention; a decoder's 4 * L * heads * head size a causal
    pair, s * (s + 1) / 2 a sequence, which Mistral's 4096-token window
    leaves whole at these lengths) over the padded tokens, and over the real
    ones alone (s each text's own length).  Returns (embeddings, figures)."""
    import torch

    enc, cfg = rm.encoder, rm.encoder.config
    weights = forward_weights(enc)
    decoder = decoder_attention(cfg)
    fig = dict(tokenize_s=0.0, padded=0, flops=0.0)
    events, real, real_flops = [], [], []
    encode = rm.tokenizer.encode

    def counted_encode(*args, **kw):
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        fig["tokenize_s"] += time.perf_counter() - t0
        return out

    def before(_, args):
        ids, mask = args[:2]
        b, s = ids.shape
        fig["padded"] += b * s
        lens = mask.sum(1).double()
        real.append(mask.sum())
        if decoder is not None:
            layers, width = decoder
            fig["flops"] += 2.0 * weights * b * s + 4.0 * layers * width * (s * (s + 1) / 2) * b
            real_flops.append(2.0 * weights * lens.sum() + 4.0 * layers * width * (lens * (lens + 1) / 2).sum())
        elif hasattr(cfg, "decoder_layers"):
            fig["flops"] += 2.0 * weights * b * s + 4.0 * cfg.d_model * seq2seq_pairs(cfg, s) * b
            real_flops.append(2.0 * weights * lens.sum() + 4.0 * cfg.d_model * seq2seq_pairs(cfg, lens).sum())
        else:
            pairs = attention_pairs(cfg, s)
            fig["flops"] += 2.0 * weights * b * s + 4.0 * cfg.num_hidden_layers * cfg.hidden_size * pairs * b
            # A real token's keys: its own text's under full attention, the
            # padded pattern's mean row under block-sparse attention.
            keys = torch.full_like(lens, pairs / s) if getattr(cfg, "attention_type", "") == "block_sparse" else lens
            real_flops.append(2.0 * weights * lens.sum()
                              + 4.0 * cfg.num_hidden_layers * cfg.hidden_size * (lens * keys).sum())
        events.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        events[-1][0].record()

    def after(*_):
        events[-1][1].record()

    hooks = [enc.register_forward_pre_hook(before), enc.register_forward_hook(after)]
    rm.tokenizer.encode = counted_encode  # the instance's own, shadowing the method for this call
    try:
        sync(rm.device)
        t0 = time.perf_counter()
        emb = rm(texts)
        fig["wall_s"] = time.perf_counter() - t0
    finally:
        del rm.tokenizer.encode
        for h in hooks:
            h.remove()
    sync(rm.device)
    fig["device_ms"] = sum(a.elapsed_time(b) for a, b in events)
    fig["real"] = int(sum(int(r) for r in real))
    fig["real_flops"] = float(sum(float(f) for f in real_flops))
    return emb, fig


def print_split(label: str, n: int, fig: dict, rate: float, rate_name: str) -> None:
    """One ingest's figures: docs/s, tokens/s real and padded, the tokenizer's
    host seconds, the encoder's device ms and its share of its bound over
    the padded tokens (the work it is given) and over the real tokens (the
    ingest's own work)."""
    bound_ms, real_ms = (1e3 * fig[f] / rate for f in ("flops", "real_flops"))
    wall = fig["wall_s"]
    say(f"  {label}: {n:,} docs in {wall:.3f} s wall = {n / wall:,.1f} docs/s; tokens/s {fig['real'] / wall:,.0f} "
        f"real ({fig['real']:,}), {fig['padded'] / wall:,.0f} padded ({fig['padded']:,}); tokenizing "
        f"{fig['tokenize_s']:.3f} s on the host ({100 * fig['tokenize_s'] / wall:.1f}% of the wall); encoder "
        f"{fig['device_ms']:.3f} ms on the device (CUDA events) = {100 * fig['device_ms'] / (1e3 * wall):.1f}% of "
        f"the wall; bound over padded tokens {bound_ms:.3f} ms ({fig['flops']:.4e} operations at {rate_name}), "
        f"the encoder at {100 * bound_ms / fig['device_ms']:.1f}% of it; over real tokens {real_ms:.3f} ms "
        f"({fig['real_flops']:.4e} operations), the encoder at {100 * real_ms / fig['device_ms']:.1f}% of it [{GPU}]")


def models_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 64) -> None:
    """Phase 23: each model through its entry point on the card, held to the
    port's own CPU run in the same process on ``n_docs`` docs of mixed length
    (four 16-doc batches in four sequence buckets), in f32: embeddings within
    1e-4, reranker scores within 1e-4 * (1 + |s|); bf16 on the card against
    f32 on the card: the smallest cosine must reach 0.99."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    quarter = n_docs // 4
    docs = [t for i, (lo, hi) in enumerate(((3, 10), (11, 24), (25, 50), (51, 100)))
            for t in synth_texts(vocab, quarter, lo, hi, 40 + i)]
    for name, d in dirs.items():
        seq = MODELS[name]["max_seq_length"]
        kw = dict(model=d, max_batch_size=16, max_seq_length=seq)
        if "num_labels" in MODELS[name]:
            queries = synth_texts(vocab, 4, 3, 9, 44)
            card_rr, cpu_rr = TorchCrossEncoderReranker(device=dev, **kw), TorchCrossEncoderReranker(device="cpu", **kw)
            got, want = (np.concatenate([rr.score_pairs(q, docs[i * quarter : (i + 1) * quarter])
                                         for i, q in enumerate(queries)]) for rr in (card_rr, cpu_rr))
            err = float(np.abs(got - want).max())
            ok = bool((np.abs(got - want) <= 1e-4 * (1 + np.abs(want))).all())
            say(f"  {name} (TorchCrossEncoderReranker, f32): {len(got)} pair scores on the card vs the CPU: max abs "
                f"err {err!r} (tol 1e-4*(1+|s|)) -> {'OK' if ok else 'MISMATCH'}; scores {float(want.min())!r}.."
                f"{float(want.max())!r} [{GPU}]")
            assert ok, f"{name}: the card's scores differ from the CPU's"
            continue
        card_rm = TorchSentenceEncoderRM(device=dev, **kw)
        got = card_rm(docs)
        want = TorchSentenceEncoderRM(device="cpu", **kw)(docs)
        bf16 = TorchSentenceEncoderRM(device=dev, dtype=torch.bfloat16, **kw)(docs)
        err = float(np.abs(got - want).max())
        cos = float(np.sum(bf16 * got, axis=1).min())
        buckets = sorted({a.shape[1] for _, a, _ in bucketed_batches(card_rm.tokenizer, docs, None, 16, seq, "cpu")})
        say(f"  {name} (TorchSentenceEncoderRM, f32, buckets {buckets}): {got.shape} embeddings on the card vs the "
            f"CPU: max abs err {err!r} (tol 1e-4) -> {'OK' if err <= 1e-4 else 'MISMATCH'}; bf16 on the card vs "
            f"f32 on the card: smallest cosine {cos!r} (must reach 0.99) [{GPU}]")
        assert got.shape == (n_docs, MODELS[name]["hidden_size"]) and bool(np.isfinite(got).all())
        assert err <= 1e-4, f"{name}: the card's embeddings differ from the CPU's"
        assert cos >= 0.99, f"{name}: bf16 embeddings drift from f32 (cosine {cos})"
        del card_rm


def mean_cosine(emb, n: int = 2000) -> float:
    """Mean pairwise cosine of the first ``n`` (unit) rows, the diagonal
    left out: how close together the seeded weights put the texts."""
    import numpy as np

    e = emb[:n]
    g = e @ e.T
    return float((g.sum() - np.trace(g)) / (len(e) * (len(e) - 1)))


def config1_text_phase(dev, vocab: list[str], dirs: dict, n: int = 10_000, nq: int = 256, n_rerank_q: int = 64,
                       top: int = 100) -> int:
    """Phase 24, BASELINE config 1 from text: ``n`` passages of 150-300 words
    through ``TorchSentenceEncoderRM.__call__`` at MiniLM widths in f32 and
    bf16; a Flat store over the f32 embeddings; ``nq`` queries embedded
    through ``convert_query_to_query_vector``; the store called with ids =
    every row, one query a call (``sem_search.py:35``: recall@10 must be 1.0
    against exact f32 on the same embeddings) and without ids under
    ``scan="pallas"`` (K2; recall@10 at least 0.98), and K2 held to its
    plain version on the arguments that call gives it (``k2_compare`` at k
    ``top``); then the reranker over the top ``top`` of ``n_rerank_q``
    queries.  Returns K2's launches."""
    import numpy as np
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM
    from lotus_tpu_torch.ops.flat_scan import scan_fold

    rm_dir = dirs["all-MiniLM-L6-v2"]
    seq = MODELS["all-MiniLM-L6-v2"]["max_seq_length"]
    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 50, per_topic=K)
    queries = [" ".join(np.random.default_rng(51 + i).choice(passages[j].split(), 12))
               for i, j in enumerate(np.random.default_rng(52).integers(0, n, nq))]
    say(f"  {n:,} passages of 150-300 words, {nq} queries of 12 words drawn from a passage; made in "
        f"{time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=rm_dir, max_seq_length=seq, device=dev)
    emb, fig = encode_split(rm, passages)
    print_split("all-MiniLM-L6-v2 f32, max_batch_size 64", n, fig, F32_OPS_PER_S, "67 TFLOP/s f32")
    rm16 = TorchSentenceEncoderRM(model=rm_dir, max_seq_length=seq, dtype=torch.bfloat16, device=dev)
    emb16, fig16 = encode_split(rm16, passages)
    print_split("all-MiniLM-L6-v2 bf16, max_batch_size 64", n, fig16, BF16_OPS_PER_S, "989 TFLOP/s bf16")
    say(f"    bf16 against f32 embeddings: smallest cosine {float(np.sum(emb * emb16, axis=1).min())!r}; mean "
        f"pairwise cosine of f32 rows {mean_cosine(emb)!r}")
    del rm16

    shutil.rmtree(TEXT_INDEX_DIR, ignore_errors=True)
    vs = TorchVS(index_type="flat", device=dev)
    t0 = time.perf_counter()
    vs.index(passages, emb, TEXT_INDEX_DIR)
    index_s = time.perf_counter() - t0
    qv = rm.convert_query_to_query_vector(queries)
    emb_t, qv_t = torch.from_numpy(emb).to(dev), torch.from_numpy(qv).to(dev)
    gt = exact_topk(qv_t, emb_t, K).tolist()
    every = list(range(n))
    vs(qv[:1], K, ids=every)  # loads the store
    t0 = time.perf_counter()
    got = [vs(qv[i : i + 1], K, ids=every).indices[0] for i in range(nq)]
    ids_ms = 1e3 * (time.perf_counter() - t0) / nq
    ids_recall = recall_at(got, gt)
    k2 = TorchVS(index_type="flat", scan="pallas", device=dev)
    k2.load_index(TEXT_INDEX_DIR)
    k2(qv[:8], K)  # loads the store
    scan_fold.launches = 0  # this path's launches
    t0 = time.perf_counter()
    out = k2(qv, top)
    k2_ms = 1e3 * (time.perf_counter() - t0)
    launches = scan_fold.launches
    k2_recall = recall_at([row[:K] for row in out.indices], gt)
    say(f"  TorchVS(index_type='flat') over {n:,} x {emb.shape[1]}: index() {index_s:.3f} s; with ids = every row, "
        f"one query a call: recall@{K} {ids_recall!r} vs exact f32, {ids_ms:.3f} ms a call (host clock); without "
        f"ids, scan='pallas' (K2), {nq} queries at k {top}: recall@{K} {k2_recall!r}, {k2_ms:.3f} ms (host clock, "
        f"results on the host); K2 launches {launches} [{GPU}]")
    if ids_recall < 1.0 or k2_recall < 0.98:
        say(f"    mean pairwise cosine of the passages {mean_cosine(emb)!r}")
    assert bool(np.isfinite(emb).all()) and emb.shape == (n, 384), "config 1 embeddings"
    assert ids_recall == 1.0, f"config 1 with ids: recall@10 {ids_recall} is not 1.0"
    assert launches > 0, "the scan='pallas' store did not launch K2"
    assert k2_recall >= 0.98, f"config 1 through K2: recall@10 {k2_recall} below 0.98"
    k2_store_compare("config 1 from text", k2, qv, top)

    rr_dir = dirs["ms-marco-MiniLM-L-6-v2"]
    rr = TorchCrossEncoderReranker(model=rr_dir, device=dev)
    rr(queries[0], [passages[i] for i in out.indices[0]], K)  # warm
    sync(dev)
    t0 = time.perf_counter()
    orders = [rr(queries[q], [passages[i] for i in out.indices[q]], K).indices for q in range(n_rerank_q)]
    rr_s = time.perf_counter() - t0
    pairs = n_rerank_q * top
    say(f"  TorchCrossEncoderReranker (f32, max_batch_size 64) over the top {top} of {n_rerank_q} queries "
        f"(sem_search(n_rerank=...)'s shape): {pairs:,} pairs in {rr_s:.3f} s = {pairs / rr_s:,.1f} pairs/s (host "
        f"clock) [{GPU}]")
    assert all(len(o) == K and len(set(o)) == K for o in orders), "the reranker's orders"
    return launches


def k2_store_compare(label: str, store, qv, top: int) -> list:
    """K2 against its plain version on the inputs a ``scan="pallas"`` Flat
    store's call gives it: the same call once more, with the wrapper
    recording them (``k2_compare`` at k ``top``, timed).  Returns
    ``k2_compare``'s figures and the arguments of each call."""
    import torch

    from lotus_tpu_torch.ops import flat_scan

    scan_fold = flat_scan.scan_fold
    record, calls = recording(flat_scan.scan_fold_reference)
    flat_scan.scan_fold = record
    try:
        store(qv, top)
    finally:
        flat_scan.scan_fold = scan_fold
    assert calls, "the scan='pallas' store did not call K2's wrapper"
    return [(k2_compare(f"{label}: the Flat store's {args[1].dtype} rows ({args[1].shape[0]:,} x {args[1].shape[1]}), "
                        f"{args[0].shape[0]} {args[0].dtype} queries, top {top}", args,
                        exact=args[0].dtype == torch.int8, k=top, reps=5, **kw), args) for args, kw in calls]


def k1_store_compare(label: str, store, queries, k: int) -> list[tuple]:
    """K1 against its plain version on the inputs an IVF store's call gives
    it: the same call once more, the grouped probe folding through a
    recorder (bit for bit where the dot is int8); each call timed beside
    its bound (``k1_bound``).  Returns (max_abs_err, ms, plain ms, bound ms,
    bound_by) for each call."""
    from lotus_tpu_torch.ops import ivf_probe

    record, calls = recording(ivf_probe.probe_fold_reference)
    grouped = ivf_probe.ivf_search_grouped_probe
    ivf_probe.ivf_search_grouped_probe = lambda *a, **kw: grouped(*a, **kw, fold=record)
    try:
        store(queries, k)
    finally:
        ivf_probe.ivf_search_grouped_probe = grouped
    assert calls, f"{label}: the store did not call K1's wrapper"
    figures = []
    for args, kw in calls:
        err, ms, plain_ms = compare(f"{label}: the IVF store's {args[1].dtype} rows (bl {kw['bl']}, {args[1].shape[0]:,} "
                           f"storage rows), {len(queries):,} {args[0].dtype} queries, "
                           f"{'int8' if kw['int8_dot'] else 'float'} dot, {'packed' if kw['packed'] else 'unpacked'}",
                           args, exact=kw["int8_dot"], tol=2e-3 if kw["packed"] else 1e-4, reps=5, **kw)
        bound, by, n_live, _, _ = k1_bound(args[0], args[1], args[4], args[6], int8_dot=kw["int8_dot"],
                                           packed=kw["packed"], top1=kw.get("top1", False))
        say(f"    bound {bound:.4f} ms ({by}; {n_live} live chunks, each probed list read once), K1 at "
            f"{100 * bound / ms:.1f}% of it [{GPU}]")
        figures.append((err, ms, plain_ms, bound, by))
    return figures


def config2_text_phase(dev, vocab: list[str], dirs: dict, n: int = 100_000, nq: int = 1000,
                       nlist: int = 128) -> int:
    """Phase 25, BASELINE config 2's encoder: ``n`` + ``n`` seeded docs of
    8-48 words at e5-base-v2 widths in bf16, CONFIG2_BATCH a batch (the
    right side again at CONFIG2_WIDE_BATCH), the right side indexed in
    ``TorchVS(index_type="ivf", nlist=128, device_dtype="int8")``
    (block-aligned at 512, so a call without ids goes to K1); ``nq`` left
    queries without ids (recall@5 at least 0.95 against exact f32), and K1
    held to its plain version on the arguments that call gives it (bit for
    bit where the dot is int8); the whole left side with ids = every right
    row at k 5 (``sem_sim_join.py:97``), whose pair recall is printed.
    Returns K1's launches."""
    import numpy as np
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.models import TorchSentenceEncoderRM
    from lotus_tpu_torch.models.wordpiece import WordPieceTokenizer
    from lotus_tpu_torch.ops.io import read_meta
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    k = 5
    t0 = time.perf_counter()
    left, right = synth_texts(vocab, n, 8, 48, 60, per_topic=k), synth_texts(vocab, n, 8, 48, 61, per_topic=k)
    say(f"  {n:,} + {n:,} docs of 8-48 words made in {time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=dirs["e5-base-v2"], max_batch_size=CONFIG2_BATCH, dtype=torch.bfloat16,
                                device=dev)
    right_emb, fig = encode_split(rm, right)
    print_split(f"e5-base-v2 bf16, max_batch_size {CONFIG2_BATCH}, right side", n, fig, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    left_emb, fig_l = encode_split(rm, left)
    print_split(f"e5-base-v2 bf16, max_batch_size {CONFIG2_BATCH}, left side", n, fig_l, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    rm.max_batch_size = CONFIG2_WIDE_BATCH
    rm.tokenizer = WordPieceTokenizer.from_dir(dirs["e5-base-v2"])  # its word memo cold, as the first pass's was
    wide_emb, fig_w = encode_split(rm, right)
    print_split(f"e5-base-v2 bf16, max_batch_size {CONFIG2_WIDE_BATCH}, right side again", n, fig_w, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    say(f"    max_batch_size {CONFIG2_WIDE_BATCH} against {CONFIG2_BATCH}: smallest cosine "
        f"{float(np.sum(wide_emb * right_emb, axis=1).min())!r}")
    del wide_emb
    index_dir = os.path.join(TEXT_INDEX_DIR, "config2")
    shutil.rmtree(index_dir, ignore_errors=True)
    vs = TorchVS(index_type="ivf", nlist=nlist, device_dtype="int8", device=dev)
    t0 = time.perf_counter()
    vs.index([], right_emb, index_dir)
    index_s = time.perf_counter() - t0
    bl = read_meta(index_dir)["block_align"]
    right_t, left_t = torch.from_numpy(right_emb).to(dev), torch.from_numpy(left_emb).to(dev)
    gt = exact_topk(left_t[:nq], right_t, k).tolist()
    vs(left_emb[:8], k)  # loads the store
    probe_fold.launches = 0  # this path's launches
    t0 = time.perf_counter()
    out = vs(left_emb[:nq], k)
    probe_ms = 1e3 * (time.perf_counter() - t0)
    launches = probe_fold.launches
    recall = float(sum(len(set(a) & set(b)) for a, b in zip(out.indices, gt)) / (k * nq))
    say(f"  TorchVS(index_type='ivf', nlist {nlist}, int8) over the right side: index() {index_s:.3f} s; "
        f"block_align {bl}; {nq:,} left queries without ids (nprobe {vs.nprobe}): recall@{k} {recall!r} vs exact "
        f"f32, {probe_ms:.3f} ms (host clock); K1 launches {launches}; routes {vs.stats['routes']} [{GPU}]")
    if recall < 0.95:
        say(f"    mean pairwise cosine of the right side {mean_cosine(right_emb)!r}")
    assert int(bl) > 0 and launches > 0, "config 2's store did not take K1"
    assert recall >= 0.95, f"config 2 through K1: recall@5 {recall} below 0.95"
    k1_store_compare("config 2 from text", vs, left_emb[:nq], k)
    every = list(range(n))
    t0 = time.perf_counter()
    joined = vs(left_emb, k, ids=every)
    join_s = time.perf_counter() - t0
    full_gt = exact_topk(left_t, right_t, k).tolist()
    pair_recall = float(sum(len(set(a) & set(b)) for a, b in zip(joined.indices, full_gt)) / (k * n))
    say(f"  the whole left side with ids = every right row, k {k} (sem_sim_join's call): {join_s:.3f} s (host "
        f"clock); pair recall against the full exact f32 oracle {pair_recall!r} ({n * k:,} pairs) [{GPU}]")
    shutil.rmtree(index_dir, ignore_errors=True)
    return launches


def profile_main(out_dir: str) -> int:
    """The profiling phase's child (``chip_smoke.py --profile <dir>``): one
    encode batch of phase 24's model and one config-1 store call through K2
    under ``profiling.trace``, each inside ``annotate`` and ``timed``; the
    sink is written to ``<dir>/sink.json``."""
    import torch

    sys.path.insert(0, REPO)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    from lotus_tpu_torch import TorchVS, profiling
    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    with open(os.path.join(MODELS_DIR, "all-MiniLM-L6-v2", "vocab.txt")) as f:
        vocab = f.read().split("\n")[:-1]
    rm = TorchSentenceEncoderRM(model=os.path.join(MODELS_DIR, "all-MiniLM-L6-v2"), max_seq_length=256)
    vs = TorchVS(index_type="flat", scan="pallas")
    vs.load_index(TEXT_INDEX_DIR)
    docs = synth_texts(vocab, 64, 150, 300, 70)
    qv = rm(docs[:8])
    vs(qv, K)  # loads the store
    sink: dict = {}
    with profiling.trace(os.path.join(out_dir, "trace")):
        with profiling.annotate("encode batch"), profiling.timed("encode batch", sink):
            rm(docs)
        with profiling.annotate("store call (K2)"), profiling.timed("store call (K2)", sink):
            vs(qv, K)
    with open(os.path.join(out_dir, "sink.json"), "w") as f:
        json.dump(sink, f)
    return 0


def profiling_phase(out_dir: str = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_profile")) -> None:
    """Phase 26: ``profiling.trace`` in a child process (``profile_main``);
    the child must exit 0, its Chrome trace must hold K2's ``scan_kernel``
    and both ``annotate`` regions with device times, and ``timed``'s sink
    both regions."""
    import glob

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile", out_dir], capture_output=True,
                          text=True, timeout=300)
    say(f"  child exited {proc.returncode} after {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        say("  the end of its output:\n" + (proc.stdout + proc.stderr)[-3000:])
        raise AssertionError(f"the profiling child exited {proc.returncode}")
    (path,) = glob.glob(os.path.join(out_dir, "trace", "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(out_dir, "sink.json")) as f:
        sink = json.load(f)
    regions = ("encode batch", "store call (K2)")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    scan = [e for e in kernels if "scan_kernel" in e.get("name", "")]
    on_device = {r: sum(e["dur"] for e in events if e.get("cat") == "gpu_user_annotation" and e.get("name") == r)
                 for r in regions}
    on_host = {r: sum(e["dur"] for e in events if e.get("cat") == "user_annotation" and e.get("name") == r)
               for r in regions}
    say(f"  trace {os.path.relpath(path, REPO)}: {os.path.getsize(path) / 1e6:.2f} MB, {len(events):,} events, "
        f"{len(kernels):,} kernels on the device ({sum(e['dur'] for e in kernels) / 1e3:.3f} ms); scan_kernel x "
        f"{len(scan)} ({sum(e['dur'] for e in scan) / 1e3:.3f} ms); regions on the host (us) {on_host}, on the device "
        f"(us) {on_device}; timed's sink (s) {sink} [{GPU}]")
    assert scan and all(e["dur"] > 0 for e in scan), "the trace holds no scan_kernel with a device time"
    assert all(on_host[r] > 0 and on_device[r] > 0 for r in regions), "an annotate region lacks its times"
    assert set(sink) == set(regions), "timed's sink lacks a region"
    shutil.rmtree(out_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 27: the encoder families past BERT (M13) at published widths, from text
# ---------------------------------------------------------------------------

FAMILY_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_families")
_XLMR = dict(model_type="xlm-roberta", num_hidden_layers=12, hidden_size=768, num_attention_heads=12,
             intermediate_size=3072, vocab_size=250_002, max_position_embeddings=514, type_vocab_size=1,
             layer_norm_eps=1e-5, pad_token_id=1, tokenizer="unigram")
# The depth of the models phases 27-29 only hold to the CPU (no ingest or
# rerank rate reads them): depth adds seconds to that check, not coverage,
# and the whole script must stay near half its time limit (their published
# depths are 12, 12, 24, 16 + 16, 2 + 12 and 8 + 8 layers).
CHECK_DEPTH = 2
# Each model's published config.json widths, with seeded weights (the
# check-only models CHECK_DEPTH layers deep); max_seq_length is the
# reference's default (flax_rm.py:48), but 128 for all-roberta-large-v1,
# its model card's truncation length.
FAMILY_MODELS = {
    "multilingual-e5-base": dict(_XLMR, max_seq_length=512),
    "bge-reranker-base": dict(_XLMR, num_labels=1, max_seq_length=512),
    "all-roberta-large-v1": dict(model_type="roberta", num_hidden_layers=24, hidden_size=1024, num_attention_heads=16,
                                 intermediate_size=4096, vocab_size=50_265, max_position_embeddings=514,
                                 type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1, tokenizer="bpe",
                                 max_seq_length=128),
    "msmarco-distilbert-base-v4": dict(model_type="distilbert", n_layers=6, dim=768, n_heads=12, hidden_dim=3072,
                                       vocab_size=VOCAB_SIZE, max_position_embeddings=512, tokenizer="wordpiece",
                                       max_seq_length=512),
    "ms-marco-electra-base": dict(model_type="electra", num_hidden_layers=CHECK_DEPTH, hidden_size=768,
                                  num_attention_heads=12, intermediate_size=3072, embedding_size=768,
                                  vocab_size=VOCAB_SIZE, max_position_embeddings=512, type_vocab_size=2,
                                  layer_norm_eps=1e-12, tokenizer="wordpiece", num_labels=1, max_seq_length=512),
}
# The seeded XLM-R tokenizer's charsmap: full-width letters, circled digits,
# the ideographic space, a multi-character replacement and key.
SMOKE_CHARSMAP = {
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)}, **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
    **{chr(0x2460 + i): str(i + 1) for i in range(9)}, "\u3000": " ", "\u337f": "\u682a\u5f0f\u4f1a\u793e",
    "e\u0301": "\u00e9",
}
# Words the XLM-R docs mix in: accents, full-width letters and circled
# digits (the charsmap), CJK, a combining mark, an emoji (unknown to the vocab).
NON_ASCII = ["café", "naïve", "Ｆｕｌｌ", "①②", "日本語", "Über", "straße", "\U0001F600", "e\u0301t", "\u337f",
             "ｗｉｄｅ", "中文"]


def _added(tokens: list[tuple[str, int]], lstrip: str = "") -> list[dict]:
    return [{"id": i, "content": t, "single_word": False, "lstrip": t == lstrip, "rstrip": False,
             "normalized": False, "special": True} for t, i in tokens]


def _template(cls_tok: str, cls_id: int, sep_tok: str, sep_id: int, double_sep: bool) -> dict:
    def tok(t, type_id=0):
        return {"SpecialToken": {"id": t, "type_id": type_id}}

    def seq(name, type_id=0):
        return {"Sequence": {"id": name, "type_id": type_id}}

    second = 0 if double_sep else 1
    pair = [tok(cls_tok), seq("A"), tok(sep_tok), *([tok(sep_tok)] if double_sep else []), seq("B", second),
            tok(sep_tok, second)]
    return {"type": "TemplateProcessing", "single": [tok(cls_tok), seq("A"), tok(sep_tok)], "pair": pair,
            "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                               for t, i in ((cls_tok, cls_id), (sep_tok, sep_id))}}


# BLOOM's pre-tokenizer pattern, as its tokenizer.json writes it (Oniguruma's syntax).
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
# MBartConverter's language codes, after the pieces, and PegasusConverter's
# head of the vocabulary (offset 103).
MBART_LANGS = ("ar_AR", "cs_CZ", "de_DE", "en_XX", "es_XX", "et_EE", "fi_FI", "fr_XX", "gu_IN", "hi_IN", "it_IT",
               "ja_XX", "kk_KZ", "ko_KR", "lt_LT", "lv_LV", "my_MM", "ne_NP", "nl_XX", "ro_RO", "ru_RU", "si_LK",
               "tr_TR", "vi_VN", "zh_CN")
PEGASUS_HEAD = ("<pad>", "</s>", "<mask_1>", "<mask_2>", *(f"<unk_{i}>" for i in range(2, 103)), "<unk>")


def suffix_template(suffix: list[str], ids: dict) -> dict:
    """``A`` / ``A B`` followed by the ``suffix`` tokens, all of type 0."""
    def part(name):
        kind = "Sequence" if name in ("A", "B") else "SpecialToken"
        return {kind: {"id": name, "type_id": 0}}

    return {"type": "TemplateProcessing", "single": [part(x) for x in ("A", *suffix)],
            "pair": [part(x) for x in ("A", "B", *suffix)],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]} for t in suffix}}


def unigram_spec(words: list[str], size: int, seed: int, flavor: str = "xlm-roberta") -> dict:
    """A sentencepiece Unigram ``tokenizer.json`` over a seeded vocabulary of
    ``size`` pieces (``▁`` + every whole word, the ``##`` pieces bare,
    single characters, seeded fillers; scores seeded so that whole words
    win) with the special tokens, normalizer and template the converter of
    ``flavor`` writes: ``XLMRobertaConverter`` (``<s> <pad> </s> <unk>``
    first and ``<mask>`` last; the quote ``Replace``s, the charsmap,
    ``Replace(" {2,}", " ")``; ``<s> A </s> </s> B </s>``),
    ``AlbertConverter`` (``<pad> <unk> [CLS] [SEP] [MASK]`` first; the quote
    ``Replace``s, ``NFKD``, ``StripAccents``, ``Lowercase``, the charsmap,
    ``Replace(" {2,}", " ")``; ``[CLS] A [SEP] B:1 [SEP]:1``) or, for
    ``big_bird``, ``BigBirdConverter`` (``<pad> <s> </s> <unk> [CLS] [SEP]
    [MASK]`` first; ``SpmConverter``'s charsmap, right ``Strip`` and
    ``Replace(" {2,}", "▁")``; ALBERT's template), ``mbart``
    (``MBartConverter``: ``<s> <pad> </s> <unk>`` first, the language codes
    and ``<mask>`` last; ``SpmConverter``'s normalizer; ``A </s> en_XX``) or
    ``pegasus`` (``PegasusConverter``: ``<pad> </s> <mask_1> <mask_2>``,
    ``<unk_2>`` .. ``<unk_102>`` and ``<unk>`` first; ``SpmConverter``'s
    normalizer; ``WhitespaceSplit`` before ``Metaspace``; ``A </s>``) or
    ``xglm`` (``XGLMConverter``: ``<s> <pad> </s> <unk>`` first and the
    seven ``<madeupwordN>`` last; ``SpmConverter``'s normalizer; ``</s>
    A`` / ``</s> A </s> </s> B``); ``Metaspace`` for all."""
    import base64
    import string

    import numpy as np

    from lotus_tpu_torch.models.charsmap import build_charsmap

    charsmap = {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(build_charsmap(SMOKE_CHARSMAP)).decode()}
    quotes = [{"type": "Replace", "pattern": {"String": q}, "content": '"'} for q in ("``", "''")]
    collapse = {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}
    if flavor == "xlm-roberta":
        head, tail, mask = ["<s>", "<pad>", "</s>", "<unk>"], ["<mask>"], "<mask>"
        steps = [*quotes, charsmap, collapse]
    elif flavor == "albert":
        head, tail, mask = ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"], [], "[MASK]"
        steps = [*quotes, {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"}, charsmap, collapse]
    else:  # SpmConverter's normalizer
        steps = [charsmap, {"type": "Strip", "strip_left": False, "strip_right": True},
                 {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]
        if flavor == "mbart":
            head, tail, mask = ["<s>", "<pad>", "</s>", "<unk>"], [*MBART_LANGS, "<mask>"], "<mask>"
        elif flavor == "pegasus":
            head, tail, mask = list(PEGASUS_HEAD), [], "<mask_2>"
        elif flavor == "xglm":
            head, tail, mask = ["<s>", "<pad>", "</s>", "<unk>"], [f"<madeupword{i}>" for i in range(7)], ""
        else:
            head, tail, mask = ["<pad>", "<s>", "</s>", "<unk>", "[CLS]", "[SEP]", "[MASK]"], [], "[MASK]"
    rng = np.random.default_rng(seed)
    pieces: dict[str, float] = {}
    for w in words:
        pieces.setdefault(w[2:] if w.startswith("##") else "▁" + w, -float(rng.uniform(8, 12)))
    chars = string.ascii_letters + string.digits + string.punctuation + "▁éïüßÜ日本語中文株式会社"
    for c in chars:
        pieces.setdefault(c, -float(rng.uniform(12, 16)))
    n_pieces = size - len(head) - len(tail)
    for p in [p for p in pieces if p not in chars][n_pieces - len(pieces):] if len(pieces) > n_pieces else []:
        del pieces[p]  # a vocabulary smaller than the word list keeps the first words and every character
    letters = np.array(list(string.ascii_lowercase))
    while len(pieces) < n_pieces:
        lengths = rng.integers(2, 8, n_pieces - len(pieces))
        for n in lengths:
            pieces.setdefault(("▁" if rng.random() < 0.5 else "") + "".join(rng.choice(letters, n)),
                              -float(rng.uniform(10, 15)))
    vocab = [[t, 0.0] for t in head] + [[p, sc] for p, sc in pieces.items()] + [[t, 0.0] for t in tail]
    assert len(vocab) == size
    ids = {t: i for i, (t, _) in enumerate(vocab) if t in head or t in tail}
    pre = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    if flavor == "xlm-roberta":
        template = _template("<s>", ids["<s>"], "</s>", ids["</s>"], double_sep=True)
    elif flavor == "mbart":  # the file's; MBartTokenizerFast sets its own from src_lang
        template = suffix_template(["</s>", "en_XX"], ids)
    elif flavor == "pegasus":
        template = suffix_template(["</s>"], ids)
        pre = {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"}, pre]}
    elif flavor == "xglm":
        eos = {"SpecialToken": {"id": "</s>", "type_id": 0}}
        a, b = ({"Sequence": {"id": x, "type_id": 0}} for x in ("A", "B"))
        template = {"type": "TemplateProcessing", "single": [eos, a], "pair": [eos, a, eos, eos, b],
                    "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]} for t in ("<s>", "</s>")}}
    else:
        template = _template("[CLS]", ids["[CLS]"], "[SEP]", ids["[SEP]"], double_sep=False)
    return {
        "version": "1.0", "added_tokens": _added(list(ids.items()), lstrip=mask),
        "normalizer": {"type": "Sequence", "normalizers": steps},
        "pre_tokenizer": pre,
        "post_processor": template,
        "model": {"type": "Unigram", "unk_id": ids["<unk>"], "vocab": vocab, "byte_fallback": False},
    }


def bpe_spec(words: list[str], size: int, flavor: str = "roberta") -> dict:
    """RoBERTa's (and BART's) ``tokenizer.json`` (byte-level BPE) with
    ``size`` tokens: ``<s> <pad> </s> <unk>``, the 256 byte characters, then
    the merges that build each word left to right (``Ġ`` + word, for every
    word in the seeded order, then the bare words) until the vocabulary is
    full, each merge's result in the vocabulary, and ``<mask>`` last.  The
    ``blenderbot`` flavor is ``BlenderbotConverter``'s: ``<pad> <s> </s>
    <unk>`` first, a prefix space, and ``A </s>``; the ``gpt2`` flavor
    ``GPT2Converter``'s: no special token but ``<|endoftext|>`` last, and
    the ``ByteLevel`` post-processor, which adds none; the ``bloom`` flavor
    BLOOM's file's: ``<unk> <s> </s> <pad>`` first, the capitalised words
    built too (as far as ``size`` goes), nothing last, ``Split`` on
    ``BLOOM_SPLIT`` (isolated) before ``ByteLevel`` without its own regex,
    and the ``ByteLevel`` post-processor."""
    from lotus_tpu_torch.models.bpe import bytes_to_unicode

    heads = {"roberta": ("<s>", "<pad>", "</s>", "<unk>"), "blenderbot": ("<pad>", "<s>", "</s>", "<unk>"),
             "gpt2": (), "bloom": ("<unk>", "<s>", "</s>", "<pad>")}
    last = {"gpt2": "<|endoftext|>", "bloom": None}.get(flavor, "<mask>")
    vocab = {t: i for i, t in enumerate(heads[flavor])}
    for c in bytes_to_unicode().values():
        vocab.setdefault(c, len(vocab))
    merges = []
    forms = ["Ġ" + w for w in words] + list(words)
    if flavor == "bloom":
        forms += ["Ġ" + w.capitalize() for w in words] + [w.capitalize() for w in words]
    for form in forms:
        for k in range(1, len(form)):
            if len(vocab) >= size - (last is not None):
                break
            if form[: k + 1] not in vocab:
                merges.append([form[:k], form[k]])
                vocab[form[: k + 1]] = len(vocab)
    if last is not None:
        vocab[last] = len(vocab)
    assert len(vocab) == size
    specials = [(t, vocab[t]) for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>", "<|endoftext|>") if t in vocab]
    pre = {"type": "ByteLevel", "add_prefix_space": flavor == "blenderbot", "trim_offsets": True, "use_regex": True}
    if flavor in ("gpt2", "bloom"):
        post = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": True}
    elif flavor == "blenderbot":
        post = suffix_template(["</s>"], vocab)
    else:
        post = {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0], "trim_offsets": True,
                "add_prefix_space": False}
    if flavor == "bloom":
        pre = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": BLOOM_SPLIT}, "behavior": "Isolated", "invert": False},
            {**pre, "use_regex": False}]}
    return {
        "version": "1.0", "added_tokens": _added(specials, lstrip="<mask>"), "normalizer": None,
        "pre_tokenizer": pre,
        "post_processor": post,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def wordpiece_spec(vocab: list[str]) -> dict:
    """BERT's ``tokenizer.json`` (what ``DistilBertTokenizerFast`` and
    ``ElectraTokenizerFast`` save) over phase 23's vocabulary."""
    ids = {t: i for i, t in enumerate(vocab)}
    specials = [(t, ids[t]) for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")]
    return {
        "version": "1.0", "added_tokens": _added(specials),
        "normalizer": {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
                       "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": _template("[CLS]", ids["[CLS]"], "[SEP]", ids["[SEP]"], double_sep=False),
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": ids},
    }


def write_family_models(vocab: list[str], dev, seed: int = 10, models: dict | None = None,
                        root: str | None = None) -> dict[str, str]:
    """One checkpoint directory per ``models`` entry (FAMILY_MODELS by
    default) under ``root`` (FAMILY_DIR by default): ``config.json`` (the family's keys),
    ``tokenizer.json`` (generated here: seeded Unigram in XLM-R's, ALBERT's
    or BigBird's pipeline, seeded BPE merges, phase 23's WordPiece vocabulary
    or its 50,000-entry extension), ``tokenizer_config.json`` (WordPiece ones
    name ``BertTokenizer``) and ``model.safetensors`` with weights drawn as
    the initialiser draws them (N(0, 0.02), biases 0, LayerNorm 1 / 0), made
    on ``dev``.  Returns the directories."""
    words = [w for w in vocab if not w.startswith("[")]
    specs = {}
    dirs = {}
    for i, (name, shape) in enumerate((models or FAMILY_MODELS).items()):
        d = os.path.join(root or FAMILY_DIR, name)
        os.makedirs(d, exist_ok=True)
        config = {k: v for k, v in shape.items() if k not in ("tokenizer", "max_seq_length", "num_labels")}
        if shape["model_type"] != "distilbert":
            config = {"hidden_act": "gelu", "position_embedding_type": "absolute", **config}
        else:
            config.update(activation="gelu", sinusoidal_pos_embds=False)
        if "num_labels" in shape:
            config["id2label"] = {str(j): f"LABEL_{j}" for j in range(shape["num_labels"])}
        kind = shape["tokenizer"]
        if kind not in specs:
            specs[kind] = {"unigram": lambda: unigram_spec(words, shape["vocab_size"], seed),
                           "albert": lambda: unigram_spec(words, shape["vocab_size"], seed, "albert"),
                           "spm": lambda: unigram_spec(words, shape["vocab_size"], seed, "big_bird"),
                           "bpe": lambda: bpe_spec([w for w in words if w.isalpha()], shape["vocab_size"]),
                           "wordpiece": lambda: wordpiece_spec(vocab),
                           "wordpiece-50k": lambda: wordpiece_spec(smoke_vocab(0, shape["vocab_size"]))}[kind]()
        if kind.startswith("wordpiece"):  # RoFormer's own class would cut with jieba, which the port refuses
            tok_config = {"pad_token": "[PAD]", "do_lower_case": True, "tokenizer_class": "BertTokenizer"}
        else:
            tok_config = {"pad_token": "<pad>"}
        for fname, obj in (("config.json", config), ("tokenizer.json", specs[kind]),
                           ("tokenizer_config.json", tok_config)):
            with open(os.path.join(d, fname), "w", encoding="utf-8") as f:
                json.dump(obj, f)
        write_seeded_weights(d, config, "num_labels" in shape, dev, seed + i)
        dirs[name] = d
    return dirs


def write_seeded_weights(path: str, config: dict, classifier: bool, dev, seed: int) -> None:
    """``model.safetensors`` in ``path``: the family's encoder (or sequence
    classifier) of the parsed ``config.json`` ``config``, with weights drawn
    as the initialiser draws them (N(0, 0.02), biases 0, each LayerNorm 1 /
    0) from ``seed``, made on ``dev``."""
    import torch

    from lotus_tpu_torch.models.checkpoint import encoder_config, new_module

    with torch.device(dev):
        module = new_module(encoder_config(config), classifier=classifier)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for pname, p in module.named_parameters():
            if "LayerNorm" in pname or "layer_norm" in pname or "layernorm_embedding" in pname:
                p.fill_(1.0 if pname.endswith("weight") else 0.0)
            elif pname.endswith("bias"):
                p.zero_()
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    write_safetensors(os.path.join(path, "model.safetensors"), module.state_dict())


def multilingual(texts: list[str], seed: int, share: float = 0.15) -> list[str]:
    """``texts`` with a seeded ``share`` of their words swapped for NON_ASCII
    ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for t in texts:
        ws = t.split()
        out.append(" ".join(NON_ASCII[rng.integers(len(NON_ASCII))] if rng.random() < share else w for w in ws))
    return out


def families_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 64, n_large: int = 16) -> None:
    """Phase 27a: each family model through its entry point on the card and
    on the CPU in f32 (``n_docs`` docs of mixed length in four sequence
    buckets, ``n_large`` for RoBERTa-large; multilingual text for XLM-R):
    embeddings within 1e-4, reranker scores within 1e-4 * (1 + |s|); bf16
    against f32 on the card for the RMs: smallest cosine at least 0.99."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    for name, d in dirs.items():
        shape = FAMILY_MODELS[name]
        n = n_large if name == "all-roberta-large-v1" else n_docs
        quarter = n // 4
        docs = [t for i, (lo, hi) in enumerate(((3, 10), (11, 24), (25, 50), (51, 100)))
                for t in synth_texts(vocab, quarter, lo, hi, 80 + i)]
        if shape["model_type"] == "xlm-roberta":
            docs = multilingual(docs, 85)
        seq = shape["max_seq_length"]
        kw = dict(model=d, max_batch_size=16, max_seq_length=seq)
        t0 = time.perf_counter()
        if "num_labels" in shape:
            queries = synth_texts(vocab, 4, 3, 9, 86)
            card_rr, cpu_rr = TorchCrossEncoderReranker(device=dev, **kw), TorchCrossEncoderReranker(device="cpu", **kw)
            got, want = (np.concatenate([rr.score_pairs(q, docs[i * quarter : (i + 1) * quarter])
                                         for i, q in enumerate(queries)]) for rr in (card_rr, cpu_rr))
            err = float(np.abs(got - want).max())
            ok = bool((np.abs(got - want) <= 1e-4 * (1 + np.abs(want))).all())
            say(f"  {name} ({shape['model_type']}, TorchCrossEncoderReranker, f32): {len(got)} pair scores on the "
                f"card vs the CPU: max abs err {err!r} (tol 1e-4*(1+|s|)) -> {'OK' if ok else 'MISMATCH'}; scores "
                f"{float(want.min())!r}..{float(want.max())!r}; {time.perf_counter() - t0:.2f} s [{GPU}]")
            assert ok and bool(np.isfinite(got).all()), f"{name}: the card's scores differ from the CPU's"
            del card_rr, cpu_rr
            continue
        card_rm = TorchSentenceEncoderRM(device=dev, **kw)
        got = card_rm(docs)
        want = TorchSentenceEncoderRM(device="cpu", **kw)(docs)
        bf16 = TorchSentenceEncoderRM(device=dev, dtype=torch.bfloat16, **kw)(docs)
        err = float(np.abs(got - want).max())
        cos = float(np.sum(bf16 * got, axis=1).min())
        buckets = sorted({a.shape[1] for _, a, _ in bucketed_batches(card_rm.tokenizer, docs, None, 16, seq, "cpu")})
        width = shape.get("hidden_size", shape.get("dim"))
        say(f"  {name} ({shape['model_type']}, TorchSentenceEncoderRM, f32, buckets {buckets}): {got.shape} "
            f"embeddings on the card vs the CPU: max abs err {err!r} (tol 1e-4) -> {'OK' if err <= 1e-4 else 'MISMATCH'}"
            f"; bf16 on the card vs f32 on the card: smallest cosine {cos!r} (must reach 0.99); "
            f"{time.perf_counter() - t0:.2f} s [{GPU}]")
        assert got.shape == (n, width) and bool(np.isfinite(got).all())
        assert err <= 1e-4, f"{name}: the card's embeddings differ from the CPU's"
        assert cos >= 0.99, f"{name}: bf16 embeddings drift from f32 (cosine {cos})"
        del card_rm


def print_tokenizer(label: str, texts: list[str], fig: dict) -> None:
    """How the tokenizer's host time scales: words, tokens a word, and host
    microseconds a word and a token."""
    words = sum(len(t.split()) for t in texts)
    say(f"    {label} tokenizer: {words:,} words -> {fig['real']:,} tokens ({fig['real'] / words:.3f} a word, "
        f"truncation included); {1e6 * fig['tokenize_s'] / words:.3f} us a word, "
        f"{1e6 * fig['tokenize_s'] / fig['real']:.3f} us a token on the host")


def ivf_text_store(dev, label: str, right: list[str], right_emb, left_emb, k: int, nlist: int,
                   width: int) -> tuple[int, object, str]:
    """``right_emb`` (the embeddings of the texts ``right``) in a
    ``TorchVS(index_type="ivf", nlist=nlist, device_dtype="int8")`` store,
    block-aligned (len(right) >= 512 * nlist), so a search without ids goes
    to K1; the ``left_emb`` queries through it with K1's launches counted
    from 0: recall@k at least 0.95 against exact f32, K1 held to its plain
    version on the call's own inputs (``k1_store_compare``).  Returns K1's
    launches, the store and its directory (deleted by the caller)."""
    import numpy as np
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.io import read_meta
    from lotus_tpu_torch.ops.ivf_probe import probe_fold

    n, nq = len(right), len(left_emb)
    index_dir = os.path.join(TEXT_INDEX_DIR, re.sub(r"\W+", "_", label.lower()))
    shutil.rmtree(index_dir, ignore_errors=True)
    vs = TorchVS(index_type="ivf", nlist=nlist, device_dtype="int8", device=dev)
    t0 = time.perf_counter()
    vs.index(right, right_emb, index_dir)
    index_s = time.perf_counter() - t0
    bl = read_meta(index_dir)["block_align"]
    right_t, left_t = torch.from_numpy(right_emb).to(dev), torch.from_numpy(left_emb).to(dev)
    gt = exact_topk(left_t, right_t, k).tolist()
    vs(left_emb[:8], k)  # loads the store
    probe_fold.launches = 0  # this path's launches
    t0 = time.perf_counter()
    out = vs(left_emb, k)
    probe_ms = 1e3 * (time.perf_counter() - t0)
    launches = probe_fold.launches
    recall = float(sum(len(set(a) & set(b)) for a, b in zip(out.indices, gt)) / (k * nq))
    say(f"  TorchVS(index_type='ivf', nlist {nlist}, int8) over {n:,} x {right_emb.shape[1]}: index() {index_s:.3f} s; "
        f"block_align {bl}; {nq:,} queries (nprobe {vs.nprobe}): recall@{k} {recall!r} vs exact f32, "
        f"{probe_ms:.3f} ms (host clock); K1 launches {launches}; routes {vs.stats['routes']}; mean pairwise cosine "
        f"{mean_cosine(right_emb)!r} [{GPU}]")
    assert bool(np.isfinite(right_emb).all()) and right_emb.shape == (n, width), f"{label} embeddings"
    assert int(bl) > 0 and launches > 0, f"the {label} store did not take K1"
    assert recall >= 0.95, f"{label} through K1: recall@{k} {recall} below 0.95"
    k1_store_compare(f"{label} from text", vs, left_emb, k)
    return launches, vs, index_dir


def xlmr_phase(dev, vocab: list[str], dirs: dict, n: int = 65_536, nq: int = 1000, nlist: int = 128,
               n_rerank_q: int = 16, top: int = 100) -> int:
    """Phase 27b, XLM-R at multilingual-e5-base widths: ``n`` of config 2's
    docs (8-48 words, a share of them multilingual) through
    ``TorchSentenceEncoderRM`` in bf16 at max_batch_size 64, a
    ``TorchVS(index_type="ivf", nlist=128, device_dtype="int8")`` store
    (``n`` >= 512 * nlist, so it is block-aligned and K1 serves it); ``nq``
    left-side queries: recall@5 at least 0.95 against exact f32, K1 held to
    its plain version on the call's own inputs; then the bge-reranker-base
    widths in bf16 over the top ``top`` of ``n_rerank_q`` queries.  Returns
    K1's launches."""
    import torch

    from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM

    k = 5
    t0 = time.perf_counter()
    right = multilingual(synth_texts(vocab, n, 8, 48, 61, per_topic=k), 62, share=0.05)
    left = multilingual(synth_texts(vocab, n, 8, 48, 60, per_topic=k)[:nq], 63, share=0.05)
    say(f"  {n:,} docs + {nq:,} queries of 8-48 words (5% of words non-ASCII) made in "
        f"{time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=dirs["multilingual-e5-base"], max_batch_size=CONFIG2_BATCH,
                                dtype=torch.bfloat16, device=dev)
    right_emb, fig = encode_split(rm, right)
    print_split(f"multilingual-e5-base (XLM-R) bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    print_tokenizer("Unigram + charsmap", right, fig)
    left_emb = rm(left)
    launches, vs, index_dir = ivf_text_store(dev, "XLM-R", right, right_emb, left_emb, k, nlist,
                                             FAMILY_MODELS["multilingual-e5-base"]["hidden_size"])
    del rm

    rr = TorchCrossEncoderReranker(model=dirs["bge-reranker-base"], dtype=torch.bfloat16, device=dev)
    cands = vs(left_emb[:n_rerank_q], top).indices
    rr(left[0], [right[i] for i in cands[0]], K)  # warm
    sync(dev)
    t0 = time.perf_counter()
    orders = [rr(left[q], [right[i] for i in cands[q]], K).indices for q in range(n_rerank_q)]
    rr_s = time.perf_counter() - t0
    pairs = n_rerank_q * top
    say(f"  bge-reranker-base (XLM-R, 1 label) bf16, max_batch_size 64, over the top {top} of {n_rerank_q} queries: "
        f"{pairs:,} pairs in {rr_s:.3f} s = {pairs / rr_s:,.1f} pairs/s (host clock) [{GPU}]")
    assert all(len(o) == K and len(set(o)) == K for o in orders), "the XLM-R reranker's orders"
    shutil.rmtree(index_dir, ignore_errors=True)
    return launches


def summation_ties(q, rows, got, gt) -> tuple[list[tuple[int, int, float]], int]:
    """The ids of ``got`` (each query's top k from an exact f32 search)
    outside ``gt`` (the f32 oracle's), as (query, id, gap as a share of its
    bound), and how many of them are not a tie.  A tie is an id whose f64
    score lies within sqrt(d) * 2**-24 * sum(|q_i x_i|) of the oracle's k-th
    (f64 too): the rounding error of an f32 dot product of d terms, summed
    in an order its kernel picks (a GEMV one query a call against the
    oracle's GEMM), grows as sqrt(d) times the unit roundoff times that
    sum, so two such sums cannot order scores closer than that."""
    exempt = []
    d = rows.shape[1]
    for i, (a, b) in enumerate(zip(got, gt)):
        extra = [j for j in a if j not in set(b)]
        if not extra:
            continue
        qd = q[i].double()
        kth = float(rows[b[-1]].double() @ qd)
        for j in extra:
            x = rows[j].double()
            bound = d**0.5 * 2.0**-24 * float((qd * x).abs().sum())
            exempt.append((i, j, abs(kth - float(x @ qd)) / bound))
    return exempt, sum(share > 1.0 for _, _, share in exempt)


def flat_text_store(dev, label: str, rm, passages: list[str], emb, queries: list[str], top: int,
                    width: int) -> tuple[int, tuple]:
    """``emb`` (the embeddings of ``passages``) in a Flat store; the
    ``queries`` through ``rm`` and the store with ids = every row, one a
    call (recall@10 1.0 against exact f32: an id outside the oracle's top 10
    must be a summation tie, ``summation_ties``), and without ids under
    ``scan="pallas"`` (K2, its launches counted from 0: recall@10 at least
    0.98); K2 held to its plain version on the call's own inputs and timed
    beside its bound.  Returns K2's launches and its (max_abs_err, ms, plain
    ms, bound ms, bound_by)."""
    import numpy as np
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.flat_scan import scan_fold

    n, nq = len(passages), len(queries)
    index_dir = os.path.join(TEXT_INDEX_DIR, re.sub(r"\W+", "_", label.lower()))
    shutil.rmtree(index_dir, ignore_errors=True)
    vs = TorchVS(index_type="flat", device=dev)
    vs.index(passages, emb, index_dir)
    qv = rm.convert_query_to_query_vector(queries)
    emb_t, qv_t = torch.from_numpy(emb).to(dev), torch.from_numpy(qv).to(dev)
    gt = exact_topk(qv_t, emb_t, K).tolist()
    every = list(range(n))
    vs(qv[:1], K, ids=every)  # loads the store
    got = [vs(qv[i : i + 1], K, ids=every).indices[0] for i in range(nq)]
    ids_recall = recall_at(got, gt)
    outside, untied = summation_ties(qv_t, emb_t, got, gt)
    k2 = TorchVS(index_type="flat", scan="pallas", device=dev)
    k2.load_index(index_dir)
    k2(qv[:8], K)  # loads the store
    scan_fold.launches = 0  # this path's launches
    out = k2(qv, top)
    launches = scan_fold.launches
    k2_recall = recall_at([row[:K] for row in out.indices], gt)
    say(f"  TorchVS(index_type='flat') over {n:,} x {emb.shape[1]}: with ids = every row, one query a call: "
        f"recall@{K} {ids_recall!r} vs exact f32 ({len(outside)} ids outside the oracle's top {K}, as (query, id, "
        f"gap over its sqrt(d) bound): {outside!r}; {untied} of them not a summation tie); without ids, "
        f"scan='pallas' (K2 at d {emb.shape[1]}), "
        f"{nq} queries "
        f"at k {top}: recall@{K} {k2_recall!r}; K2 launches {launches}; mean pairwise cosine {mean_cosine(emb)!r} "
        f"[{GPU}]")
    assert bool(np.isfinite(emb).all()) and emb.shape == (n, width), f"{label} embeddings"
    assert untied == 0, f"{label} with ids: recall@10 {ids_recall}, {untied} ids outside the exact top 10 untied"
    assert launches > 0, f"the {label} scan='pallas' store did not launch K2"
    assert k2_recall >= 0.98, f"{label} through K2: recall@10 {k2_recall} below 0.98"
    (err, ms, plain_ms), args = k2_store_compare(f"{label} from text", k2, qv, top)[0]
    xq, xb = args[0], args[1]
    b_, n_, d_ = xq.shape[0], int(args[2]), xb.shape[1]
    need = n_ * d_ * xb.element_size() + b_ * d_ * xq.element_size() + b_ * 256 * 8
    t_bytes, t_ops = need / HBM_BYTES_PER_S, 2.0 * b_ * n_ * d_ / BF16_OPS_PER_S
    bound = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    say(f"  K2 at d {d_} ({b_} x {n_:,} x {d_}, {xb.dtype} rows): {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}), K2 at {100 * bound[0] / ms:.1f}% of it [{GPU}]")
    shutil.rmtree(index_dir, ignore_errors=True)
    return launches, (err, ms, plain_ms, *bound)


def roberta_large_phase(dev, vocab: list[str], dirs: dict, n: int = 10_000, nq: int = 256,
                        top: int = 100) -> tuple[int, tuple]:
    """Phase 27c, RoBERTa at all-roberta-large-v1 widths: config 1's ``n``
    passages (150-300 words) through ``TorchSentenceEncoderRM`` in bf16, a
    Flat store over the 1024-d embeddings; ``nq`` queries with ids = every
    row, one a call (recall@10 1.0 against exact f32: an id outside the
    oracle's top 10 must be a summation tie, ``summation_ties``) and without ids
    under ``scan="pallas"`` (K2 at d 1024: recall@10 at least 0.98), K2 held
    to its plain version on the call's own inputs and timed beside its bound.
    Returns K2's launches and its (max_abs_err, ms, plain ms, bound ms,
    bound_by) at d 1024."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 50, per_topic=K)
    queries = [" ".join(np.random.default_rng(51 + i).choice(passages[j].split()[:40], 12))
               for i, j in enumerate(np.random.default_rng(52).integers(0, n, nq))]
    say(f"  {n:,} passages of 150-300 words, {nq} queries of 12 words from a passage's first 40; made in "
        f"{time.perf_counter() - t0:.2f} s")
    seq = FAMILY_MODELS["all-roberta-large-v1"]["max_seq_length"]
    rm = TorchSentenceEncoderRM(model=dirs["all-roberta-large-v1"], max_seq_length=seq, dtype=torch.bfloat16,
                                device=dev)
    emb, fig = encode_split(rm, passages)
    print_split(f"all-roberta-large-v1 (RoBERTa) bf16, max_batch_size 64, max_seq_length {seq}", n, fig,
                BF16_OPS_PER_S, "989 TFLOP/s bf16")
    print_tokenizer("byte-level BPE", passages, fig)
    return flat_text_store(dev, "RoBERTa-large", rm, passages, emb, queries, top,
                           FAMILY_MODELS["all-roberta-large-v1"]["hidden_size"])


def families_phases(dev, vocab: list[str]) -> tuple[int, int, tuple]:
    """Phase 27: the checkpoints written, card against CPU, XLM-R through
    K1, RoBERTa-large through K2; the files deleted.  Returns K1's and K2's
    launches and K2's figures at d 1024."""
    with Phase("the encoder families at published widths (seeded weights): card against CPU, bf16 against f32"):
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        shutil.rmtree(FAMILY_DIR, ignore_errors=True)
        dirs = write_family_models(vocab, dev)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(FAMILY_DIR) for f in fs)
        say(f"  {len(dirs)} checkpoints ({size / 1e9:.3f} GB: model.safetensors, config.json, tokenizer.json) written "
            f"in {time.perf_counter() - t0:.2f} s under {os.path.relpath(FAMILY_DIR, REPO)}")
        families_phase(dev, vocab, dirs)
    with Phase("XLM-R (multilingual-e5-base widths) from text: IVF int8, K1; bge-reranker-base widths"):
        k1 = xlmr_phase(dev, vocab, dirs)
    with Phase("RoBERTa (all-roberta-large-v1 widths) from text: Flat, K2 at d 1024"):
        k2, k2_d1024 = roberta_large_phase(dev, vocab, dirs)
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    say(f"  phase 27: {time.perf_counter() - t_phase:.1f} s wall [{GPU}]")
    return k1, k2, k2_d1024


# ---------------------------------------------------------------------------
# Phase 28: the last encoder families the Flax auto classes load, from text
# ---------------------------------------------------------------------------

LATE_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_late_families")
# Each model's published config.json widths, with seeded weights, written as a
# 1-label sequence classifier: the RM reads its encoder, the reranker all of
# it.  max_seq_length is the reference's default (flax_rm.py:48), but 4096
# for BigBird, its length.  RoFormer's tokenizer is WordPiece over a
# 50,000-entry vocabulary: its own class cuts with jieba, which the port
# refuses.
LATE_MODELS = {
    "paraphrase-albert-small-v2": dict(model_type="albert", num_hidden_layers=6, num_hidden_groups=1,
                                       inner_group_num=1, hidden_size=768, embedding_size=128,
                                       num_attention_heads=12, intermediate_size=3072, vocab_size=30_000,
                                       max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
                                       hidden_act="gelu_new", tokenizer="albert", num_labels=1, max_seq_length=512),
    "roformer_chinese_base": dict(model_type="roformer", num_hidden_layers=CHECK_DEPTH, hidden_size=768,
                                  num_attention_heads=12, intermediate_size=3072, vocab_size=50_000,
                                  max_position_embeddings=1536,
                                  type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu", rotary_value=False,
                                  tokenizer="wordpiece-50k", num_labels=1, max_seq_length=512),
    "bigbird-roberta-base": dict(model_type="big_bird", num_hidden_layers=12, hidden_size=768, num_attention_heads=12,
                                 intermediate_size=3072, vocab_size=50_358, max_position_embeddings=4096,
                                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu_new",
                                 attention_type="block_sparse", block_size=64, num_random_blocks=3, pad_token_id=0,
                                 tokenizer="spm", num_labels=1, max_seq_length=4096),
    "efficient_mlm_m0.40": dict(model_type="roberta-prelayernorm", num_hidden_layers=CHECK_DEPTH, hidden_size=1024,
                                num_attention_heads=16, intermediate_size=4096, vocab_size=50_265,
                                max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                                tokenizer="bpe", num_labels=1, max_seq_length=512),
}
BIGBIRD_BATCH = 16  # BigBird's max_batch_size at 4096 tokens


def check_rm(dev, name: str, model_type: str, kw: dict, docs: list[str], width: int, tol: float = 1e-4,
             min_cos: float = 0.99) -> list[int]:
    """``TorchSentenceEncoderRM(**kw)`` on the card against the CPU in f32
    (within ``tol``) and bf16 against f32 on the card (smallest cosine at
    least ``min_cos``) over ``docs``.  Returns the sequence buckets the docs
    took."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM
    from lotus_tpu_torch.models.torch_rm import bucketed_batches

    t0 = time.perf_counter()
    card_rm = TorchSentenceEncoderRM(device=dev, **kw)
    got = card_rm(docs)
    want = TorchSentenceEncoderRM(device="cpu", **kw)(docs)
    bf16 = TorchSentenceEncoderRM(device=dev, dtype=torch.bfloat16, **kw)(docs)
    err = float(np.abs(got - want).max())
    cos = float(np.sum(bf16 * got, axis=1).min())
    seq = kw["max_seq_length"]
    buckets = sorted({a.shape[1] for _, a, _ in bucketed_batches(card_rm.tokenizer, docs, None, kw["max_batch_size"],
                                                                 seq, "cpu")})
    say(f"  {name} ({model_type}, TorchSentenceEncoderRM, f32, buckets {buckets}): {got.shape} "
        f"embeddings on the card vs the CPU: max abs err {err!r} (tol {tol:g}) -> {'OK' if err <= tol else 'MISMATCH'}"
        f"; bf16 on the card vs f32 on the card: smallest cosine {cos!r} (must reach {min_cos:g}); "
        f"{time.perf_counter() - t0:.2f} s [{GPU}]")
    assert got.shape == (len(docs), width) and bool(np.isfinite(got).all())
    assert err <= tol, f"{name}: the card's embeddings differ from the CPU's"
    assert cos >= min_cos, f"{name}: bf16 embeddings drift from f32 (cosine {cos})"
    return buckets


def check_reranker(dev, name: str, model_type: str, kw: dict, queries: list[str], docs: list[str]) -> None:
    """``TorchCrossEncoderReranker(**kw)`` (1 label) on the card against the
    CPU in f32, each query over its share of ``docs``: scores within
    1e-4 * (1 + |s|)."""
    import numpy as np

    from lotus_tpu_torch.models import TorchCrossEncoderReranker

    t0 = time.perf_counter()
    share = len(docs) // len(queries)
    card_rr, cpu_rr = TorchCrossEncoderReranker(device=dev, **kw), TorchCrossEncoderReranker(device="cpu", **kw)
    got, want = (np.concatenate([rr.score_pairs(q, docs[i * share : (i + 1) * share]) for i, q in enumerate(queries)])
                 for rr in (card_rr, cpu_rr))
    err = float(np.abs(got - want).max())
    ok = bool((np.abs(got - want) <= 1e-4 * (1 + np.abs(want))).all())
    say(f"  {name} ({model_type}, TorchCrossEncoderReranker, 1 label, f32): {len(got)} pair scores on "
        f"the card vs the CPU: max abs err {err!r} (tol 1e-4*(1+|s|)) -> {'OK' if ok else 'MISMATCH'}; scores "
        f"{float(want.min())!r}..{float(want.max())!r}; {time.perf_counter() - t0:.2f} s [{GPU}]")
    assert ok and bool(np.isfinite(got).all()), f"{name}: the card's scores differ from the CPU's"


def late_families_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 32, n_large: int = 16) -> None:
    """Phase 28a: each model as an RM and as a 1-label reranker through its
    entry points on the card and on the CPU in f32 (``n_docs`` docs of mixed
    length in four sequence buckets, ``n_large`` for the 24-layer
    RoBERTa-PreLayerNorm; BigBird's in the 256- and 512-token buckets only,
    where its block-sparse attention runs): embeddings within 1e-4, scores
    within 1e-4 * (1 + |s|); bf16 against f32 on the card for the RMs:
    smallest cosine at least 0.99 (``check_rm``, ``check_reranker``)."""
    for name, d in dirs.items():
        shape = LATE_MODELS[name]
        n = n_large if shape["num_hidden_layers"] > 12 else n_docs
        quarter = n // 4
        # BigBird's texts fill the 256- and 512-token buckets (1.4 tokens a word).
        sparse = shape["model_type"] == "big_bird"
        spans = ((100, 160), (100, 160), (220, 320), (220, 320)) if sparse else ((3, 10), (11, 24), (25, 50), (51, 100))
        docs = [t for i, (lo, hi) in enumerate(spans) for t in synth_texts(vocab, quarter, lo, hi, 180 + i)]
        kw = dict(model=d, max_batch_size=16, max_seq_length=shape["max_seq_length"])
        buckets = check_rm(dev, name, shape["model_type"], kw, docs, shape["hidden_size"])
        assert not sparse or buckets == [256, 512], f"BigBird's buckets {buckets}"
        check_reranker(dev, name, shape["model_type"], kw, synth_texts(vocab, 4, 3, 9, 186), docs)


def albert_phase(dev, vocab: list[str], dirs: dict, n: int = 65_536, nq: int = 1000, nlist: int = 128) -> int:
    """Phase 28b, ALBERT at paraphrase-albert-small-v2 widths: ``n`` of
    config 2's docs (8-48 words, 5% of the words non-ASCII, so ``NFKD``,
    ``StripAccents`` and the charsmap have work) through
    ``TorchSentenceEncoderRM`` in bf16 at max_batch_size 64, into an int8 IVF
    store (nlist 128, block-aligned: K1) through ``ivf_text_store``.
    Returns K1's launches."""
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    k = 5
    t0 = time.perf_counter()
    right = multilingual(synth_texts(vocab, n, 8, 48, 71, per_topic=k), 72, share=0.05)
    left = multilingual(synth_texts(vocab, n, 8, 48, 70, per_topic=k)[:nq], 73, share=0.05)
    say(f"  {n:,} docs + {nq:,} queries of 8-48 words (5% of words non-ASCII) made in "
        f"{time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=dirs["paraphrase-albert-small-v2"], max_batch_size=CONFIG2_BATCH,
                                dtype=torch.bfloat16, device=dev)
    right_emb, fig = encode_split(rm, right)
    print_split(f"paraphrase-albert-small-v2 (ALBERT) bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    print_tokenizer("Unigram + NFKD + charsmap", right, fig)
    launches, _, index_dir = ivf_text_store(dev, "ALBERT", right, right_emb, rm(left), k, nlist,
                                            LATE_MODELS["paraphrase-albert-small-v2"]["hidden_size"])
    shutil.rmtree(index_dir, ignore_errors=True)
    return launches


def bigbird_phase(dev, vocab: list[str], dirs: dict, n: int = 1024, nq: int = 256, top: int = 100,
                  words: tuple[int, int] = (2000, 3000)) -> tuple[int, tuple]:
    """Phase 28c, BigBird at bigbird-roberta-base widths at its real use:
    ``n`` long documents (``words`` words, each past 2048 tokens, so every
    batch of BIGBIRD_BATCH lands in the 4096-token bucket and block-sparse
    attention runs at full length) through ``TorchSentenceEncoderRM`` in
    bf16, into a Flat store through ``flat_text_store`` (K2 at d 768).  The
    queries are 200 words drawn from a document's first 400: the reference's
    block-sparse attention fails below 256 tokens, so a short query cannot be
    embedded at all.  Returns K2's launches and figures."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, *words, 90, per_topic=K)
    queries = [" ".join(np.random.default_rng(91 + i).choice(passages[j].split()[:400], 200))
               for i, j in enumerate(np.random.default_rng(92).integers(0, n, nq))]
    say(f"  {n:,} documents of {words[0]:,}-{words[1]:,} words, {nq} queries of 200 words from a document's "
        f"first 400; made in {time.perf_counter() - t0:.2f} s")
    seq = LATE_MODELS["bigbird-roberta-base"]["max_seq_length"]
    rm = TorchSentenceEncoderRM(model=dirs["bigbird-roberta-base"], max_batch_size=BIGBIRD_BATCH, max_seq_length=seq,
                                dtype=torch.bfloat16, device=dev)
    emb, fig = encode_split(rm, passages)
    print_split(f"bigbird-roberta-base (BigBird, block_sparse) bf16, max_batch_size {BIGBIRD_BATCH}, "
                f"max_seq_length {seq}", n, fig, BF16_OPS_PER_S, "989 TFLOP/s bf16")
    print_tokenizer("sentencepiece Unigram", passages, fig)
    batches = -(-n // BIGBIRD_BATCH)
    assert fig["padded"] == batches * BIGBIRD_BATCH * seq, f"a BigBird batch missed the {seq}-token bucket"
    return flat_text_store(dev, "BigBird", rm, passages, emb, queries, top,
                           LATE_MODELS["bigbird-roberta-base"]["hidden_size"])


def late_phases(dev, vocab: list[str]) -> tuple[int, int]:
    """Phase 28: the checkpoints written, card against CPU, ALBERT through
    K1, BigBird at 4096 tokens through K2; the files deleted.  Returns K1's
    and K2's launches."""
    with Phase("the last encoder families (ALBERT, RoFormer, BigBird, RoBERTa-PreLayerNorm) at published widths "
               "(seeded weights): card against CPU, bf16 against f32"):
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        shutil.rmtree(LATE_DIR, ignore_errors=True)
        dirs = write_family_models(vocab, dev, seed=20, models=LATE_MODELS, root=LATE_DIR)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(LATE_DIR) for f in fs)
        say(f"  {len(dirs)} checkpoints ({size / 1e9:.3f} GB: model.safetensors, config.json, tokenizer.json) written "
            f"in {time.perf_counter() - t0:.2f} s under {os.path.relpath(LATE_DIR, REPO)}")
        late_families_phase(dev, vocab, dirs)
    with Phase("ALBERT (paraphrase-albert-small-v2 widths) from text: IVF int8, K1"):
        k1 = albert_phase(dev, vocab, dirs)
    with Phase("BigBird (bigbird-roberta-base widths, block_sparse at 4096 tokens) from text: Flat, K2"):
        k2, _ = bigbird_phase(dev, vocab, dirs)
    shutil.rmtree(LATE_DIR, ignore_errors=True)
    say(f"  phase 28: {time.perf_counter() - t_phase:.1f} s wall [{GPU}]")
    return k1, k2


# ---------------------------------------------------------------------------
# Phase 29: the encoder-decoder families the Flax auto classes load, from text
# ---------------------------------------------------------------------------

SEQ2SEQ_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_seq2seq")


def _seq2seq(model_type: str, d: int, layers: tuple[int, int], heads: int, ffn: int, vocab: int, positions: int,
             ids: tuple, **kw) -> dict:
    return dict(model_type=model_type, d_model=d, encoder_layers=layers[0], decoder_layers=layers[1],
                encoder_attention_heads=heads, decoder_attention_heads=heads, encoder_ffn_dim=ffn,
                decoder_ffn_dim=ffn, vocab_size=vocab, max_position_embeddings=positions,
                **dict(zip(("pad_token_id", "bos_token_id", "eos_token_id", "decoder_start_token_id"), ids)),
                **{"activation_function": "gelu", "scale_embedding": True, "max_seq_length": 512, **kw})


# Each model's published config.json widths, layout flags and special ids,
# with seeded weights; those with num_labels are written as a 1-label
# sequence classifier, which serves as RM (its encoder-decoder) and as
# reranker.  max_seq_length is the reference's default (flax_rm.py:48), but
# Blenderbot's 128 positions, past which the reference fails.
SEQ2SEQ_MODELS = {
    "bart-base": _seq2seq("bart", 768, (6, 6), 12, 3072, 50_265, 1024, (1, 0, 2, 2), scale_embedding=False,
                          tokenizer="bpe"),
    "bart-large": _seq2seq("bart", 1024, (12, 12), 16, 4096, 50_265, 1024, (1, 0, 2, 2), scale_embedding=False,
                           tokenizer="bpe", num_labels=1),
    "mbart-large-cc25": _seq2seq("mbart", 1024, (12, 12), 16, 4096, 250_027, 1024, (1, 0, 2), tokenizer="mbart",
                                 num_labels=1),
    "pegasus-large": _seq2seq("pegasus", 1024, (CHECK_DEPTH, CHECK_DEPTH), 16, 4096, 96_103, 1024,
                              (0, None, 1, 0), activation_function="relu", tokenizer="pegasus"),
    "blenderbot-400M-distill": _seq2seq("blenderbot", 1280, (2, CHECK_DEPTH), 32, 5120, 8008, 128, (0, 1, 2, 1),
                                        tokenizer="blenderbot", max_seq_length=128),
    "blenderbot_small-90M": _seq2seq("blenderbot-small", 512, (CHECK_DEPTH, CHECK_DEPTH), 16, 2048, 54_944, 512,
                                     (0, 1, 2, 1), tokenizer="blenderbot-small"),
}
SEQ2SEQ_RERANK_PAIRS = (16, 100)  # queries x candidates each reranker scores in 29b and 29c


def blenderbot_small_files(path: str, words: list[str], size: int) -> None:
    """Blenderbot-Small's ``vocab.json`` / ``merges.txt`` (no
    ``tokenizer.json``: its tokenizer is the slow one) with ``size``
    entries: ``__null__ __start__ __end__ __unk__ __newln__``, every
    character alone and ``@@``-continued, then for each word the merges
    that build it left to right (its last character marked ``</w>``), each
    merge's result in the slow tokenizer's form (``@@`` while the word goes
    on, bare where it ends), until the vocabulary is full."""
    import string

    vocab = {t: i for i, t in enumerate(("__null__", "__start__", "__end__", "__unk__", "__newln__"))}
    for c in string.ascii_lowercase + string.digits + string.punctuation:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "@@", len(vocab))
    merges, seen = [], set()
    for w in (w.lower() for w in words):
        if len(vocab) >= size:
            break
        symbols = [*w[:-1], w[-1] + "</w>"]
        cur = symbols[0]
        for nxt in symbols[1:]:
            if (cur, nxt) not in seen:
                seen.add((cur, nxt))
                merges.append((cur, nxt))
            cur += nxt
            vocab.setdefault(cur[:-4] if cur.endswith("</w>") else cur + "@@", len(vocab))
    while len(vocab) < size:
        vocab[f"__filler{len(vocab)}__"] = len(vocab)
    vocab = dict(list(vocab.items())[:size])
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_seq2seq_models(vocab: list[str], dev, seed: int = 30, models: dict | None = None,
                         root: str = SEQ2SEQ_DIR) -> dict[str, str]:
    """One checkpoint directory per ``models`` entry (SEQ2SEQ_MODELS by
    default) under ``root``: ``config.json``, the tokenizer (generated here:
    ``tokenizer.json`` of BART's byte-level BPE over the words of phase 23's
    vocabulary, Blenderbot's (``bpe_spec``'s ``blenderbot`` flavor), mBART's
    and Pegasus's seeded Unigram in their converters' layouts
    (``unigram_spec``); Blenderbot-Small's ``vocab.json`` / ``merges.txt``,
    ``blenderbot_small_files``), ``tokenizer_config.json`` (mBART's names
    its class and ``src_lang`` en_XX) and ``model.safetensors`` with
    weights drawn by ``write_seeded_weights`` (``shared`` alone holds the
    tied token embeddings), made on ``dev``.  Returns the directories."""
    words = [w for w in vocab if not w.startswith("[")]
    alpha = [w for w in words if w.isalpha()]
    dirs = {}
    for i, (name, shape) in enumerate((models or SEQ2SEQ_MODELS).items()):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        config = {k: v for k, v in shape.items()
                  if k not in ("tokenizer", "max_seq_length", "num_labels") and v is not None}
        if "num_labels" in shape:
            config["id2label"] = {str(j): f"LABEL_{j}" for j in range(shape["num_labels"])}
        kind, size = shape["tokenizer"], shape["vocab_size"]
        files = {"config.json": config}
        if kind == "blenderbot-small":
            blenderbot_small_files(d, alpha, size)
            files["tokenizer_config.json"] = {}  # no class: AutoTokenizer builds the type's slow one
        else:
            files["tokenizer.json"] = {"bpe": lambda: bpe_spec(alpha, size),
                                       "blenderbot": lambda: bpe_spec(alpha, size, "blenderbot"),
                                       "mbart": lambda: unigram_spec(words, size, seed, "mbart"),
                                       "pegasus": lambda: unigram_spec(words, size, seed, "pegasus")}[kind]()
            files["tokenizer_config.json"] = ({"pad_token": "<pad>", "src_lang": "en_XX",
                                               "tokenizer_class": "MBartTokenizer"} if kind == "mbart"
                                              else {"pad_token": "<pad>"})
        for fname, obj in files.items():
            with open(os.path.join(d, fname), "w", encoding="utf-8") as f:
                json.dump(obj, f)
        write_seeded_weights(d, config, "num_labels" in shape, dev, seed + i)
        dirs[name] = d
    return dirs


def seq2seq_check_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 32, n_large: int = 16) -> None:
    """Phase 29a: each model as an RM (and, with a classifier, as a 1-label
    reranker) through its entry points on the card and on the CPU in f32
    (``n_docs`` docs of mixed length in four sequence buckets, ``n_large``
    for the models of 24 layers or more): embeddings within 1e-4, scores
    within 1e-4 * (1 + |s|); bf16 against f32 on the card for the RMs:
    smallest cosine at least 0.99.  Blenderbot runs at its 128 positions;
    then one call at the RM's default 512 tokens, whose first bucket passes
    128, must raise ``ValueError`` before any layer of the model runs."""
    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    for name, d in dirs.items():
        shape = SEQ2SEQ_MODELS[name]
        n = n_large if shape["encoder_layers"] + shape["decoder_layers"] >= 24 else n_docs
        quarter = n // 4
        docs = [t for i, (lo, hi) in enumerate(((3, 10), (11, 24), (25, 50), (51, 100)))
                for t in synth_texts(vocab, quarter, lo, hi, 280 + i)]
        if shape["model_type"] == "mbart":
            docs = multilingual(docs, 285)
        kw = dict(model=d, max_batch_size=16, max_seq_length=shape["max_seq_length"])
        buckets = check_rm(dev, name, shape["model_type"], kw, docs, shape["d_model"])
        assert max(buckets) <= shape["max_position_embeddings"], f"{name}'s buckets {buckets}"
        if shape["max_position_embeddings"] < 512:
            long_rm = TorchSentenceEncoderRM(device=dev, model=d, max_batch_size=16)
            ran = []
            hook = long_rm.encoder.encoder.register_forward_pre_hook(lambda *_: ran.append(1))
            try:
                long_rm(synth_texts(vocab, 16, 150, 200, 287))  # past 128 tokens each
                raised = None
            except ValueError as e:
                raised = str(e)
            finally:
                hook.remove()
            say(f"  {name} at max_seq_length 512 over 16 docs of 150-200 words: {raised!r}; encoder layers run "
                f"{len(ran)}")
            assert raised is not None and not ran, f"{name}: a bucket past its positions did not raise before the forward"
        if "num_labels" in shape:
            check_reranker(dev, name, shape["model_type"], kw, synth_texts(vocab, 4, 3, 9, 286), docs)


def rerank_rate(dev, label: str, model_dir: str, queries: list[str], texts: list[str], cands) -> None:
    """The ``model_dir`` reranker in bf16 (max_batch_size 64) over each
    query's candidates: pairs/s on the host clock, after a warm call."""
    import torch

    from lotus_tpu_torch.models import TorchCrossEncoderReranker

    rr = TorchCrossEncoderReranker(model=model_dir, dtype=torch.bfloat16, device=dev)
    rr(queries[0], [texts[i] for i in cands[0]], K)  # warm
    sync(dev)
    t0 = time.perf_counter()
    orders = [rr(q, [texts[i] for i in c], K).indices for q, c in zip(queries, cands)]
    sync(dev)
    rr_s = time.perf_counter() - t0
    pairs = sum(len(c) for c in cands)
    say(f"  {label} reranker (1 label) bf16, max_batch_size 64, over the top {len(cands[0])} of {len(queries)} "
        f"queries: {pairs:,} pairs in {rr_s:.3f} s = {pairs / rr_s:,.1f} pairs/s (host clock) [{GPU}]")
    assert all(len(o) == K and len(set(o)) == K for o in orders), f"the {label} reranker's orders"


def bart_phase(dev, vocab: list[str], dirs: dict, n: int = 65_536, nq: int = 1000, nlist: int = 128) -> int:
    """Phase 29b, BART at bart-base widths: ``n`` of config 2's docs (8-48
    words) through ``TorchSentenceEncoderRM`` in bf16 at max_batch_size 64,
    into an int8 IVF store (nlist 128, block-aligned: K1) through
    ``ivf_text_store`` (recall@5 at least 0.95 over ``nq`` queries, K1 held
    to its plain version on the call's own inputs); then the bart-large
    reranker over SEQ2SEQ_RERANK_PAIRS.  Returns K1's launches."""
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    k = 5
    t0 = time.perf_counter()
    right = synth_texts(vocab, n, 8, 48, 291, per_topic=k)
    left = synth_texts(vocab, n, 8, 48, 290, per_topic=k)[:nq]
    say(f"  {n:,} docs + {nq:,} queries of 8-48 words made in {time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=dirs["bart-base"], max_batch_size=CONFIG2_BATCH, dtype=torch.bfloat16,
                                device=dev)
    right_emb, fig = encode_split(rm, right)
    print_split(f"bart-base (BART) bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S, "989 TFLOP/s bf16")
    print_tokenizer("byte-level BPE", right, fig)
    left_emb = rm(left)
    del rm
    launches, vs, index_dir = ivf_text_store(dev, "BART-base", right, right_emb, left_emb, k, nlist,
                                             SEQ2SEQ_MODELS["bart-base"]["d_model"])
    nq_rr, top = SEQ2SEQ_RERANK_PAIRS
    rerank_rate(dev, "bart-large (BART)", dirs["bart-large"], left[:nq_rr], right,
                vs(left_emb[:nq_rr], top).indices)
    shutil.rmtree(index_dir, ignore_errors=True)
    return launches


def mbart_phase(dev, vocab: list[str], dirs: dict, n: int = 4096, nq: int = 256, top: int = 100) -> tuple[int, tuple]:
    """Phase 29c, mBART at mbart-large-cc25 widths: ``n`` of config 1's
    passages (150-300 words, the 512-token bucket) through
    ``TorchSentenceEncoderRM`` in bf16, into a Flat store through
    ``flat_text_store`` (recall@10 1.0 through ids, at least 0.98 through K2
    at d 1024, K2 held to its plain version on the call's own inputs and
    timed beside its bound); then the mBART reranker over
    SEQ2SEQ_RERANK_PAIRS.  Returns K2's launches and figures."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 50, per_topic=K)
    queries = [" ".join(np.random.default_rng(51 + i).choice(passages[j].split()[:40], 12))
               for i, j in enumerate(np.random.default_rng(52).integers(0, n, nq))]
    say(f"  {n:,} passages of 150-300 words, {nq} queries of 12 words from a passage's first 40; made in "
        f"{time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=dirs["mbart-large-cc25"], max_batch_size=CONFIG2_BATCH, dtype=torch.bfloat16,
                                device=dev)
    emb, fig = encode_split(rm, passages)
    print_split(f"mbart-large-cc25 (mBART) bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    print_tokenizer("Unigram + charsmap", passages, fig)
    assert fig["padded"] == -(-n // CONFIG2_BATCH) * CONFIG2_BATCH * 512, "an mBART batch missed the 512-token bucket"
    width = SEQ2SEQ_MODELS["mbart-large-cc25"]["d_model"]
    launches, figures = flat_text_store(dev, "mBART", rm, passages, emb, queries, top, width)
    nq_rr, top_rr = SEQ2SEQ_RERANK_PAIRS
    qv = torch.from_numpy(rm(queries[:nq_rr])).to(dev)
    del rm
    cands = exact_topk(qv, torch.from_numpy(emb).to(dev), top_rr).tolist()
    rerank_rate(dev, "mbart-large-cc25 (mBART)", dirs["mbart-large-cc25"], queries[:nq_rr], passages, cands)
    return launches, figures


def seq2seq_phases(dev, vocab: list[str]) -> tuple[int, int]:
    """Phase 29: the checkpoints written, card against CPU, BART-base
    through K1, mBART through K2 at d 1024; the files deleted.  Returns K1's
    and K2's launches."""
    with Phase("the encoder-decoder families (BART, mBART, Pegasus, Blenderbot, Blenderbot-Small) at published "
               "widths (seeded weights): card against CPU, bf16 against f32"):
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        shutil.rmtree(SEQ2SEQ_DIR, ignore_errors=True)
        dirs = write_seq2seq_models(vocab, dev)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(SEQ2SEQ_DIR) for f in fs)
        say(f"  {len(dirs)} checkpoints ({size / 1e9:.3f} GB: model.safetensors, config.json, tokenizer files) "
            f"written in {time.perf_counter() - t0:.2f} s under {os.path.relpath(SEQ2SEQ_DIR, REPO)}")
        seq2seq_check_phase(dev, vocab, dirs)
    with Phase("BART (bart-base widths) from text: IVF int8, K1; bart-large reranker"):
        k1 = bart_phase(dev, vocab, dirs)
    with Phase("mBART (mbart-large-cc25 widths) from text: Flat, K2 at d 1024; mBART reranker"):
        k2, _ = mbart_phase(dev, vocab, dirs)
    shutil.rmtree(SEQ2SEQ_DIR, ignore_errors=True)
    say(f"  phase 29: {time.perf_counter() - t_phase:.1f} s wall [{GPU}]")
    return k1, k2


# ---------------------------------------------------------------------------
# Phase 30: the decoder-only RMs the Flax auto class loads, from text
# ---------------------------------------------------------------------------

DECODER_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_decoders")
# Each model's published config.json widths (2 layers deep in 30a), with
# seeded weights written in bf16; max_seq_length is the reference's default
# (flax_rm.py:48).  Each tokenizer is seeded in its converter's layout.
DECODER_MODELS = {
    "gpt2": dict(model_type="gpt2", n_embd=768, n_layer=2, n_head=12, n_positions=1024, vocab_size=50_257,
                 activation_function="gelu_new", layer_norm_epsilon=1e-5, tokenizer="gpt2"),
    "gpt-neo-1.3B": dict(model_type="gpt_neo", hidden_size=2048, num_layers=2, num_heads=16,
                         attention_types=[[["global", "local"], 1]], window_size=256, max_position_embeddings=2048,
                         vocab_size=50_257, activation_function="gelu_new", layer_norm_epsilon=1e-5, tokenizer="gpt2"),
    "gpt-j-6B": dict(model_type="gptj", n_embd=4096, n_layer=2, n_head=16, rotary_dim=64, n_positions=2048,
                     vocab_size=50_400, activation_function="gelu_new", layer_norm_epsilon=1e-5, tokenizer="gpt2"),
    "Llama-2-7b": dict(model_type="llama", hidden_size=4096, num_hidden_layers=2, num_attention_heads=32,
                       num_key_value_heads=32, intermediate_size=11_008, max_position_embeddings=4096,
                       rms_norm_eps=1e-5, vocab_size=32_000, hidden_act="silu", tokenizer="llama"),
    "Mistral-7B-v0.1": dict(model_type="mistral", hidden_size=4096, num_hidden_layers=2, num_attention_heads=32,
                            num_key_value_heads=8, intermediate_size=14_336, max_position_embeddings=32_768,
                            rms_norm_eps=1e-5, sliding_window=4096, rope_theta=10_000.0, vocab_size=32_000,
                            hidden_act="silu", tokenizer="llama"),
    "gemma-2b": dict(model_type="gemma", hidden_size=2048, num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=1, head_dim=256, intermediate_size=16_384, max_position_embeddings=8192,
                     rms_norm_eps=1e-6, vocab_size=256_000, hidden_act="gelu", hidden_activation=None,
                     tokenizer="gemma"),
}
MISTRAL_LAYERS = 32  # Mistral-7B-v0.1's depth, phase 30b's
GPT2_LAYERS = 12  # gpt2-base's depth, phase 30c's
SHARD_BYTES = 5 << 30  # save_pretrained's default max_shard_size ("5GB")


def write_bf16_safetensors(path: str, tensors: dict) -> None:
    """``tensors`` (on any device) as a bf16 ``.safetensors`` file, one
    tensor at a time through the host (header padded to 8 bytes)."""
    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [offset, offset + 2 * t.numel()]}
        offset += 2 * t.numel()
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().to(torch.bfloat16).contiguous().view(torch.int16).cpu().numpy().data)


def write_sharded(path: str, tensors: dict, shard_bytes: int = SHARD_BYTES) -> list[str]:
    """``tensors`` as bf16 shards of at most ``shard_bytes`` (one tensor may
    pass it alone), ``model-0000k-of-0000n.safetensors``, and the
    ``model.safetensors.index.json`` that names them, as ``save_pretrained``
    writes a large model.  Returns the shard names."""
    groups, size = [[]], 0
    for name, t in tensors.items():
        if groups[-1] and size + 2 * t.numel() > shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += 2 * t.numel()
    names = [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors" for i in range(len(groups))]
    for shard, group in zip(names, groups):
        write_bf16_safetensors(os.path.join(path, shard), {n: tensors[n] for n in group})
    index = {"metadata": {"total_size": sum(2 * t.numel() for t in tensors.values())},
             "weight_map": {n: shard for shard, group in zip(names, groups) for n in group}}
    with open(os.path.join(path, "model.safetensors.index.json"), "w", encoding="utf-8") as f:
        json.dump(index, f)
    return names


def sp_bpe_spec(words: list[str], size: int, flavor: str = "llama") -> dict:
    """A sentencepiece BPE ``tokenizer.json`` with byte fallback and ``size``
    tokens, in ``LlamaConverter``'s layout (``<unk> <s> </s>``, the 256
    ``<0xXX>`` tokens, then the pieces; ``Prepend("▁")`` and ``Replace(" ",
    "▁")``, no pre-tokenizer) or, for ``gemma``, ``GemmaConverter``'s
    (``<pad> <eos> <bos> <unk>``; ``Replace`` and ``Split(" ",
    merged_with_previous)``): the letters, digits, punctuation and ``▁``,
    then the merges that build ``▁`` + each word left to right until the
    vocabulary is full (Gemma's past the words filled with ``<unusedN>``);
    other characters fall back to bytes.  ``<unk>`` fused."""
    import string

    specials = ["<pad>", "<eos>", "<bos>", "<unk>"] if flavor == "gemma" else ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in "▁" + string.ascii_letters + string.digits + string.punctuation:
        vocab.setdefault(c, len(vocab))
    merges = []
    for form in ["▁" + w for w in words]:
        for k in range(1, len(form)):
            if len(vocab) >= size:
                break
            if form[: k + 1] not in vocab:
                merges.append([form[:k], form[k]])
                vocab[form[: k + 1]] = len(vocab)
    while len(vocab) < size:
        vocab[f"<unused{len(vocab)}>"] = len(vocab)
    added = _added([(t, vocab[t]) for t in specials])
    if flavor == "gemma":
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
        pre = {"type": "Split", "pattern": {"String": " "}, "behavior": "MergedWithPrevious", "invert": False}
    else:
        normalizer = {"type": "Sequence", "normalizers": [{"type": "Prepend", "prepend": "▁"},
                                                           {"type": "Replace", "pattern": {"String": " "},
                                                            "content": "▁"}]}
        pre = None
    bos = specials[2] if flavor == "gemma" else "<s>"

    def part(kind: str, name: str, type_id: int) -> dict:
        return {kind: {"id": name, "type_id": type_id}}

    single = [part("SpecialToken", bos, 0), part("Sequence", "A", 0)]
    post = {"type": "TemplateProcessing", "single": single,
            "pair": [*single, part("SpecialToken", bos, 1), part("Sequence", "B", 1)],
            "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]], "tokens": [bos]}}}
    return {
        "version": "1.0", "added_tokens": added, "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": post,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def decoder_tokenizer_files(words: list[str], kind: str, size: int) -> dict:
    """``tokenizer.json`` and ``tokenizer_config.json`` of a decoder's
    seeded tokenizer: GPT-2's byte-level BPE (``bpe_spec``'s ``gpt2``
    flavor, ``<|endoftext|>`` also the pad token, as embedders set it),
    ``LlamaTokenizerFast``'s (pad ``</s>``, left padding by the class),
    ``GemmaTokenizerFast``'s (its own ``<pad>``), BLOOM's (``bpe_spec``'s
    ``bloom`` flavor, ``<pad>``, left padding as its files say) or XGLM's
    (``unigram_spec``'s ``xglm`` flavor, ``<pad>``)."""
    if kind == "gpt2":
        return {"tokenizer.json": bpe_spec(words, size, "gpt2"),
                "tokenizer_config.json": {"tokenizer_class": "GPT2Tokenizer", "pad_token": "<|endoftext|>"}}
    if kind == "bloom":
        return {"tokenizer.json": bpe_spec(words, size, "bloom"),
                "tokenizer_config.json": {"tokenizer_class": "BloomTokenizerFast", "pad_token": "<pad>",
                                          "padding_side": "left", "add_prefix_space": False, "unk_token": "<unk>",
                                          "bos_token": "<s>", "eos_token": "</s>"}}
    if kind == "xglm":
        return {"tokenizer.json": unigram_spec(words, size, 31, "xglm"),
                "tokenizer_config.json": {"tokenizer_class": "XGLMTokenizer", "pad_token": "<pad>"}}
    if kind == "gemma":
        return {"tokenizer.json": sp_bpe_spec(words, size, "gemma"),
                "tokenizer_config.json": {"tokenizer_class": "GemmaTokenizer", "pad_token": "<pad>",
                                          "bos_token": "<bos>", "eos_token": "<eos>", "add_bos_token": True}}
    return {"tokenizer.json": sp_bpe_spec(words, size),
            "tokenizer_config.json": {"tokenizer_class": "LlamaTokenizer", "pad_token": "</s>", "add_bos_token": True,
                                      "add_eos_token": False}}


def write_decoder(path: str, shape: dict, words: list[str], dev, seed: int, shard_bytes: int | None = None) -> int:
    """A decoder (or Marian) checkpoint directory: ``config.json``, the
    seeded tokenizer's files (``decoder_tokenizer_files``, or
    ``spm_tokenizer_files`` for GPT-SW3 and Marian) and the weights, drawn on
    ``dev`` in bf16 as the initialiser draws them (N(0, 0.02); each norm's weight 1, Gemma's 0;
    biases 0) and written in bf16: ``model.safetensors``, or shards of at
    most ``shard_bytes`` with their index.  Returns the parameters written."""
    import torch

    from lotus_tpu_torch.models.checkpoint import encoder_config, new_module

    os.makedirs(path, exist_ok=True)
    config = {k: v for k, v in shape.items() if k != "tokenizer"}
    kind = shape["tokenizer"]
    files = {"config.json": config, **(spm_tokenizer_files(words, kind, shape["vocab_size"]) if kind in SPM_KINDS
                                       else decoder_tokenizer_files(words, kind, shape["vocab_size"]))}
    for fname, obj in files.items():
        if isinstance(obj, bytes):
            with open(os.path.join(path, fname), "wb") as f:
                f.write(obj)
            continue
        with open(os.path.join(path, fname), "w", encoding="utf-8") as f:
            json.dump(obj, f)
    with torch.device("meta"):
        module = new_module(encoder_config(config)).to(torch.bfloat16)
    module = module.to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for pname, p in module.named_parameters():
            if "norm" in pname or "ln_" in pname:
                p.fill_(0.0 if pname.endswith("bias") or shape["model_type"] == "gemma" else 1.0)
            elif pname.endswith("bias"):
                p.zero_()
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    state = module.state_dict()
    if shard_bytes is None:
        write_bf16_safetensors(os.path.join(path, "model.safetensors"), state)
    else:
        write_sharded(path, state, shard_bytes)
    return sum(t.numel() for t in state.values())


def param_count(shape: dict) -> int:
    """The parameters of the decoder ``shape`` describes (built on the meta
    device)."""
    import torch

    from lotus_tpu_torch.models.checkpoint import encoder_config, new_module

    with torch.device("meta"):
        return sum(p.numel() for p in new_module(encoder_config(shape)).parameters())


def host_rss() -> int:
    """The process's resident bytes now (``VmRSS``)."""
    with open("/proc/self/status", encoding="utf-8") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS"))


def host_peak_during(fn):
    """``fn()`` and the most resident bytes the process held while it ran,
    sampled every 10 ms (the card machine refuses to reset ``VmHWM``).
    Returns (its result, the peak)."""
    import threading

    peak, done = [host_rss()], threading.Event()

    def sample():
        while not done.wait(0.01):
            peak.append(host_rss())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, max(peak + [host_rss()])


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def decoders_check_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 16, models: dict | None = None,
                         tol: float = 1e-5, min_cos: float = 0.99) -> None:
    """Phase 30a (31a with ``models`` ALIBI_MODELS): each decoder as an RM
    through its entry point on the card and on the CPU in f32 (``n_docs``
    docs of mixed length, 4 a batch, in four sequence buckets): embeddings
    within ``tol``; bf16 against f32 on the card: smallest cosine at least
    ``min_cos`` (``check_rm``).  Then the same RM
    with its tokenizer read without a pad token (as GPT-2's, Llama-2's and
    Mistral's are published) must raise ``ValueError`` when it pads, as
    ``padding=True`` does in the reference."""
    from lotus_tpu_torch.models import TorchSentenceEncoderRM
    from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer, read_tokenizer_config

    quarter = n_docs // 4
    docs = [t for i, (lo, hi) in enumerate(((3, 10), (11, 24), (25, 50), (51, 100)))
            for t in synth_texts(vocab, quarter, lo, hi, 300 + i)]
    docs = multilingual(docs, 305)  # characters the seeded vocabularies lack: byte fallback
    for name, d in dirs.items():
        shape = (models or DECODER_MODELS)[name]
        kw = dict(model=d, max_batch_size=4, max_seq_length=512)
        width = next(shape[k] for k in ("hidden_size", "n_embd", "n_embed", "d_model") if k in shape)
        check_rm(dev, name, shape["model_type"], kw, docs, width, tol=tol, min_cos=min_cos)
        rm = TorchSentenceEncoderRM(device=dev, **kw)
        with open(os.path.join(d, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {k: v for k, v in read_tokenizer_config(d).items() if k != "pad_token"}
        rm.tokenizer = JsonTokenizer(spec, config)
        try:
            rm(docs[:2])
            raised = None
        except ValueError as e:
            raised = str(e)
        say(f"    {name} without a pad token ({config['tokenizer_class']}, padding side "
            f"{rm.tokenizer.padding_side}): {raised!r}")
        assert raised is not None and "no padding token" in raised, f"{name}: no ValueError without a pad token"
        del rm


def sharded_decoder_phase(dev, vocab: list[str], name: str, shape: dict, *, seed: int, doc_seed: int,
                          marker: str, tokenizer_label: str, n: int, nq: int, nlist: int, root: str,
                          padding_side: str = "left") -> int:
    """A decoder checkpoint of ``shape`` at full width and depth in bf16: the
    checkpoint written on the card in bf16 as shards of at most 5 GiB with
    ``model.safetensors.index.json`` (the free disk and host memory printed
    first), loaded by ``TorchSentenceEncoderRM(dtype=bf16)`` tensor by tensor
    onto the card (seconds, the host's resident bytes before and at their
    peak during the load); ``n`` of config 2's docs (8-48 words, drawn from
    the words the seeded vocabulary holds whole: ``marker`` + the word is a
    piece) at max_batch_size 64 and max_seq_length 512, padded on
    ``padding_side`` (left for Mistral's and BLOOM's tokenizers), into an
    int8 IVF store (nlist ``nlist``, block-aligned: K1) through
    ``ivf_text_store``: recall@5 at least 0.95 over ``nq`` queries, K1 held
    to its plain version on the call's own inputs.  The checkpoint is
    deleted after.  Returns K1's launches."""
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    disk = shutil.disk_usage(path)
    with open("/proc/meminfo", encoding="utf-8") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    say(f"  before the checkpoint: disk free {disk.free / 1e9:.1f} GB of {disk.total / 1e9:.1f}; host memory "
        f"available {mem['MemAvailable'] / 1e9:.1f} GB of {mem['MemTotal'] / 1e9:.1f}; card free "
        f"{torch.cuda.mem_get_info()[0] / 1e9:.1f} GB")
    need = 2 * param_count(shape)
    assert disk.free > 2 * need, f"{disk.free / 1e9:.1f} GB of free disk for a {need / 1e9:.1f} GB checkpoint"
    words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
    layers = next(shape[k] for k in ("num_hidden_layers", "n_layer") if k in shape)
    t0 = time.perf_counter()
    written = write_decoder(path, shape, words, dev, seed=seed, shard_bytes=SHARD_BYTES)
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    say(f"  {name} ({layers} layers, {written:,} parameters) written in bf16 in "
        f"{time.perf_counter() - t0:.2f} s: {dir_bytes(path) / 1e9:.3f} GB in {len(shards)} shards {shards} + "
        f"model.safetensors.index.json")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rss0 = host_rss()
    t0 = time.perf_counter()
    rm, rss1 = host_peak_during(lambda: TorchSentenceEncoderRM(model=path, max_batch_size=CONFIG2_BATCH,
                                                               max_seq_length=512, dtype=torch.bfloat16, device=dev))
    sync(dev)
    load_s = time.perf_counter() - t0
    params = sum(p.numel() for p in rm.encoder.parameters())
    dtypes = {p.dtype for p in rm.encoder.parameters()}
    say(f"  loaded in {load_s:.2f} s: {params:,} parameters, {dtypes}, on {next(rm.encoder.parameters()).device}; "
        f"card allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}); "
        f"host resident {rss0 / 1e9:.3f} GB before the load, its peak during the load {rss1 / 1e9:.3f} GB [{GPU}]")
    assert dtypes == {torch.bfloat16} and params == written and len(shards) > 1, f"{name} did not load whole in bf16"
    assert rm.tokenizer.padding_side == padding_side
    k = 5
    t0 = time.perf_counter()
    pieces = rm.tokenizer.vocab
    whole = [w for w in words if marker + w in pieces]  # the seeded vocabulary holds these words whole
    right = synth_texts(whole, n, 8, 48, doc_seed + 1, per_topic=k)
    left = synth_texts(whole, n, 8, 48, doc_seed, per_topic=k)[:nq]
    say(f"  {n:,} docs + {nq:,} queries of 8-48 words, drawn from the {len(whole):,} words the seeded vocabulary "
        f"holds whole (as a real one holds common words), made in {time.perf_counter() - t0:.2f} s")
    right_emb, fig = encode_split(rm, right)
    print_split(f"{name} ({layers} layers) bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S,
                "989 TFLOP/s bf16")
    print_tokenizer(tokenizer_label, right, fig)
    left_emb = rm(left)
    say(f"    card peak during the ingest {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    width = rm.encoder.config.hidden_size
    del rm
    torch.cuda.empty_cache()
    launches, _, index_dir = ivf_text_store(dev, name, right, right_emb, left_emb, k, nlist, width)
    shutil.rmtree(index_dir, ignore_errors=True)
    shutil.rmtree(path, ignore_errors=True)
    return launches


def mistral_phase(dev, vocab: list[str], n: int = 4096, nq: int = 512, nlist: int = 8, layers: int = MISTRAL_LAYERS,
                  root: str = DECODER_DIR) -> int:
    """Phase 30b, Mistral-7B-v0.1 at full width and ``layers`` deep (32, its
    own) in bf16 through ``sharded_decoder_phase``, its docs drawn from the
    words the seeded 32,000-piece vocabulary holds whole, left-padded by the
    seeded ``LlamaTokenizerFast`` layout.  Returns K1's launches."""
    return sharded_decoder_phase(dev, vocab, "Mistral-7B-v0.1",
                                 dict(DECODER_MODELS["Mistral-7B-v0.1"], num_hidden_layers=layers), seed=60,
                                 doc_seed=310, marker="▁", tokenizer_label="sentencepiece BPE (byte fallback)", n=n,
                                 nq=nq, nlist=nlist, root=root)


def gpt2_phase(dev, vocab: list[str], n: int = 4096, nq: int = 256, layers: int = GPT2_LAYERS,
               root: str = DECODER_DIR) -> int:
    """Phase 30c, GPT-2 at gpt2-base widths and depth (``layers``, 12) in
    f32, ``<|endoftext|>`` its pad token: ``n`` of config 1's passages
    (150-300 words, the 512-token bucket) into a Flat store through
    ``flat_text_store`` (recall@10 1.0 through ids, at least 0.98 through
    K2 at d 768, K2 held to its plain version on the call's own inputs and
    timed beside its bound).  Returns K2's launches."""
    import numpy as np

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    path = os.path.join(root, "gpt2-base")
    shutil.rmtree(path, ignore_errors=True)
    words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
    write_decoder(path, dict(DECODER_MODELS["gpt2"], n_layer=layers), words, dev, seed=61)
    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 50, per_topic=K)
    queries = [" ".join(np.random.default_rng(51 + i).choice(passages[j].split()[:40], 12))
               for i, j in enumerate(np.random.default_rng(52).integers(0, n, nq))]
    say(f"  {n:,} passages of 150-300 words, {nq} queries of 12 words from a passage's first 40; made in "
        f"{time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=path, max_batch_size=CONFIG2_BATCH, max_seq_length=512, device=dev)
    emb, fig = encode_split(rm, passages)
    print_split(f"gpt2-base f32, max_batch_size {CONFIG2_BATCH}", n, fig, F32_OPS_PER_S, "67 TFLOP/s f32")
    print_tokenizer("byte-level BPE", passages, fig)
    launches, _ = flat_text_store(dev, "GPT-2", rm, passages, emb, queries, 100, DECODER_MODELS["gpt2"]["n_embd"])
    shutil.rmtree(path, ignore_errors=True)
    return launches


def decoder_phases(dev, vocab: list[str]) -> tuple[int, int]:
    """Phase 30: the six decoders at published widths 2 layers deep, card
    against CPU; Mistral-7B at full width and depth through K1; GPT-2 at
    gpt2-base through K2; the files deleted.  Returns K1's and K2's
    launches."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with Phase("the decoder-only RMs (GPT-2, GPT-Neo, GPT-J, Llama, Mistral, Gemma) at published widths, 2 layers "
               "(seeded weights): card against CPU, bf16 against f32, no pad token"):
        t0 = time.perf_counter()
        shutil.rmtree(DECODER_DIR, ignore_errors=True)
        words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
        dirs = {}
        for i, (name, shape) in enumerate(DECODER_MODELS.items()):
            dirs[name] = os.path.join(DECODER_DIR, name)
            write_decoder(dirs[name], shape, words, dev, seed=50 + i)
        say(f"  {len(dirs)} checkpoints ({dir_bytes(DECODER_DIR) / 1e9:.3f} GB: bf16 model.safetensors, config.json, "
            f"tokenizer files) written in {time.perf_counter() - t0:.2f} s under {os.path.relpath(DECODER_DIR, REPO)}")
        decoders_check_phase(dev, vocab, dirs)
        shutil.rmtree(DECODER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    with Phase("Mistral-7B-v0.1 at full width and depth in bf16 from a sharded checkpoint: IVF int8, K1"):
        k1 = mistral_phase(dev, vocab)
    torch.cuda.empty_cache()
    with Phase("GPT-2 (gpt2-base) in f32 from text: Flat, K2 at d 768"):
        k2 = gpt2_phase(dev, vocab)
    shutil.rmtree(DECODER_DIR, ignore_errors=True)
    say(f"  phase 30: {time.perf_counter() - t_phase:.1f} s wall; card peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{GPU}]")
    return k1, k2


# ---------------------------------------------------------------------------
# Phase 31: BLOOM and XGLM, from text
# ---------------------------------------------------------------------------

ALIBI_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_alibi")
# Each model's published config.json (bigscience/bloom-560m, bigscience/bloom-7b1
# with its n_embed and num_attention_heads, facebook/xglm-564M, facebook/xglm-7.5B),
# CHECK_DEPTH layers deep in 31a, with seeded weights written in bf16.
ALIBI_MODELS = {
    "bloom-560m": dict(model_type="bloom", hidden_size=1024, n_layer=CHECK_DEPTH, n_head=16, vocab_size=250_880,
                       layer_norm_epsilon=1e-5, apply_residual_connection_post_layernorm=False, tokenizer="bloom"),
    "bloom-7b1": dict(model_type="bloom", n_embed=4096, n_layer=CHECK_DEPTH, num_attention_heads=32,
                      vocab_size=250_880, layer_norm_epsilon=1e-5, apply_residual_connection_post_layernorm=False,
                      tokenizer="bloom"),
    "xglm-564M": dict(model_type="xglm", d_model=1024, num_layers=CHECK_DEPTH, attention_heads=16, ffn_dim=4096,
                      vocab_size=256_008, max_position_embeddings=2048, scale_embedding=True,
                      activation_function="gelu", tokenizer="xglm"),
    "xglm-7.5B": dict(model_type="xglm", d_model=4096, num_layers=CHECK_DEPTH, attention_heads=32, ffn_dim=16_384,
                      vocab_size=256_008, max_position_embeddings=2048, scale_embedding=True,
                      activation_function="gelu", tokenizer="xglm"),
}
BLOOM_LAYERS = 30  # bloom-7b1's depth, phase 31b's
XGLM_LAYERS = 24  # xglm-564M's depth, phase 31c's


def bloom_phase(dev, vocab: list[str], n: int = 4096, nq: int = 512, nlist: int = 8, layers: int = BLOOM_LAYERS,
                root: str = ALIBI_DIR) -> int:
    """Phase 31b, BLOOM-7b1 at full width and ``layers`` deep (30, its own)
    in bf16 through ``sharded_decoder_phase``, its docs drawn from the words
    the seeded 250,880-token byte-level BPE holds whole (``Ġ`` + the word),
    left-padded as BLOOM's files say.  Returns K1's launches."""
    return sharded_decoder_phase(dev, vocab, "bloom-7b1", dict(ALIBI_MODELS["bloom-7b1"], n_layer=layers), seed=70,
                                 doc_seed=320, marker="Ġ", tokenizer_label="byte-level BPE behind a Regex Split",
                                 n=n, nq=nq, nlist=nlist, root=root)


def xglm_phase(dev, vocab: list[str], n: int = 4096, nq: int = 256, layers: int = XGLM_LAYERS,
               root: str = ALIBI_DIR) -> int:
    """Phase 31c, XGLM at xglm-564M's widths and depth (``layers``, 24) in
    bf16: ``n`` of config 1's passages (150-300 words, the 512-token bucket)
    into a Flat store through ``flat_text_store`` (recall@10 1.0 through
    ids, at least 0.98 through K2 at d 1024, K2 held to its plain version
    on the call's own inputs and timed beside its bound).  Returns K2's
    launches."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    path = os.path.join(root, "xglm-564M")
    shutil.rmtree(path, ignore_errors=True)
    words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
    written = write_decoder(path, dict(ALIBI_MODELS["xglm-564M"], num_layers=layers), words, dev, seed=71)
    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 53, per_topic=K)
    queries = [" ".join(np.random.default_rng(54 + i).choice(passages[j].split()[:40], 12))
               for i, j in enumerate(np.random.default_rng(55).integers(0, n, nq))]
    say(f"  xglm-564M ({layers} layers, {written:,} parameters); {n:,} passages of 150-300 words, {nq} queries of 12 "
        f"words from a passage's first 40; made in {time.perf_counter() - t0:.2f} s")
    rm = TorchSentenceEncoderRM(model=path, max_batch_size=CONFIG2_BATCH, max_seq_length=512, dtype=torch.bfloat16,
                                device=dev)
    emb, fig = encode_split(rm, passages)
    print_split(f"xglm-564M bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S, "989 TFLOP/s bf16")
    print_tokenizer("Unigram + charsmap", passages, fig)
    launches, _ = flat_text_store(dev, "XGLM", rm, passages, emb, queries, 100, ALIBI_MODELS["xglm-564M"]["d_model"])
    shutil.rmtree(path, ignore_errors=True)
    return launches


def alibi_phases(dev, vocab: list[str]) -> tuple[int, int]:
    """Phase 31: BLOOM and XGLM at published widths 2 layers deep, card
    against CPU; BLOOM-7b1 at full width and depth through K1; XGLM-564M
    through K2; the files deleted.  Returns K1's and K2's launches."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with Phase("BLOOM and XGLM at published widths, 2 layers (seeded weights): card against CPU, bf16 against f32, "
               "no pad token"):
        t0 = time.perf_counter()
        shutil.rmtree(ALIBI_DIR, ignore_errors=True)
        words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
        dirs = {}
        for i, (name, shape) in enumerate(ALIBI_MODELS.items()):
            dirs[name] = os.path.join(ALIBI_DIR, name)
            write_decoder(dirs[name], shape, words, dev, seed=65 + i)
        say(f"  {len(dirs)} checkpoints ({dir_bytes(ALIBI_DIR) / 1e9:.3f} GB: bf16 model.safetensors, config.json, "
            f"tokenizer files) written in {time.perf_counter() - t0:.2f} s under {os.path.relpath(ALIBI_DIR, REPO)}")
        decoders_check_phase(dev, vocab, dirs, models=ALIBI_MODELS, tol=2e-6, min_cos=0.999)
        shutil.rmtree(ALIBI_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    with Phase("BLOOM-7b1 at full width and depth in bf16 from a sharded checkpoint: IVF int8, K1"):
        k1 = bloom_phase(dev, vocab)
    torch.cuda.empty_cache()
    with Phase("XGLM (xglm-564M) in bf16 from text: Flat, K2 at d 1024"):
        k2 = xglm_phase(dev, vocab)
    shutil.rmtree(ALIBI_DIR, ignore_errors=True)
    say(f"  phase 31: {time.perf_counter() - t_phase:.1f} s wall; card peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{GPU}]")
    return k1, k2


# ---------------------------------------------------------------------------
# Phase 32: GPT-SW3 and Marian, behind sentencepiece .model files
# ---------------------------------------------------------------------------

SPM_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_spm")
SPM_KINDS = ("gpt-sw3", "marian")
# Each model's published config.json (AI-Sweden-Models/gpt-sw3-126m and
# gpt-sw3-6.7b-v2: model_type gpt2, exact GELU, 2,048 positions, a 64,000-piece
# spiece.model; Helsinki-NLP/opus-mt-en-de: 6 + 6 layers, swish,
# scale_embedding, pad and decoder start 58,100, eos 0), CHECK_DEPTH layers deep
# in 32a, with seeded weights written in bf16.  gpt-sw3-126m is written as
# model_type gpt-sw3, the type AutoConfig maps to GPT2Config, to run both.
SPM_MODELS = {
    "gpt-sw3-126m": dict(model_type="gpt-sw3", n_embd=768, n_layer=CHECK_DEPTH, n_head=12, n_inner=3072,
                         n_positions=2048, vocab_size=64_000, activation_function="gelu", layer_norm_epsilon=1e-5,
                         tokenizer="gpt-sw3"),
    "gpt-sw3-6.7b-v2": dict(model_type="gpt2", n_embd=4096, n_layer=CHECK_DEPTH, n_head=32, n_inner=16_384,
                            n_positions=2048, vocab_size=64_000, activation_function="gelu", layer_norm_epsilon=1e-5,
                            tokenizer="gpt-sw3"),
    "opus-mt-en-de": dict(model_type="marian", d_model=512, encoder_layers=CHECK_DEPTH, decoder_layers=CHECK_DEPTH,
                          encoder_attention_heads=8, decoder_attention_heads=8, encoder_ffn_dim=2048,
                          decoder_ffn_dim=2048, vocab_size=58_101, max_position_embeddings=512,
                          activation_function="swish", scale_embedding=True, pad_token_id=58_100,
                          decoder_start_token_id=58_100, eos_token_id=0, tokenizer="marian"),
}
GPT_SW3_LAYERS = 32  # gpt-sw3-6.7b-v2's depth, phase 32b's
MARIAN_LAYERS = 6  # opus-mt-en-de's depth, each stack, phase 32c's
WHOLE_SHARE = 0.7  # the share of words a seeded .model holds whole; the rest it holds as two halves


def _pb_varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # a negative int32 is its 64-bit two's complement, ten bytes
    out = bytearray()
    while True:
        if v < 0x80:
            return bytes(out + bytes([v]))
        out.append(v & 0x7F | 0x80)
        v >>= 7


def _pb_field(number: int, value) -> bytes:
    """One protobuf field: an int or bool as a varint, a float as fixed32,
    a str or bytes length-delimited."""
    import struct

    if isinstance(value, float):
        return _pb_varint(number << 3 | 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return _pb_varint(number << 3) + _pb_varint(int(value))
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    return _pb_varint(number << 3 | 2) + _pb_varint(len(raw)) + raw


def spm_model_bytes(pieces: list[tuple[str, float, int]], *, model_type: int = 1, byte_fallback: bool = False,
                    unk_id: int = 0, bos_id: int = 1, eos_id: int = 2, pad_id: int = -1, charsmap: bytes = b"",
                    name: str = "identity", add_dummy_prefix: bool = True, remove_extra_whitespaces: bool = True,
                    escape_whitespaces: bool = True) -> bytes:
    """A sentencepiece ``.model`` file (a serialized ``ModelProto``; the card
    machine has no protobuf): ``pieces`` (piece, score, type) as field 1
    (piece 1, score 2, type 3), ``trainer_spec`` 2 (model_type 3,
    byte_fallback 35, unk_id 40, bos_id 41, eos_id 42, pad_id 43) and
    ``normalizer_spec`` 3 (name 1, precompiled_charsmap 2, add_dummy_prefix
    3, remove_extra_whitespaces 4, escape_whitespaces 5)."""
    out = bytearray()
    for piece, score, kind in pieces:
        out += _pb_field(1, _pb_field(1, piece) + _pb_field(2, float(score)) + _pb_field(3, int(kind)))
    trainer = b"".join(_pb_field(n, v) for n, v in ((3, model_type), (35, byte_fallback), (40, unk_id),
                                                      (41, bos_id), (42, eos_id), (43, pad_id)))
    normalizer = _pb_field(1, name) + (_pb_field(2, charsmap) if charsmap else b"") + b"".join(
        _pb_field(n, v) for n, v in ((3, add_dummy_prefix), (4, remove_extra_whitespaces), (5, escape_whitespaces)))
    return bytes(out + _pb_field(2, trainer) + _pb_field(3, normalizer))


def spm_pieces(words: list[str], size: int, seed: int, head: list[tuple[str, int]],
               byte_fallback: bool = False) -> list[tuple[str, float, int]]:
    """A seeded Unigram vocabulary of ``size`` pieces: ``head`` (piece,
    type), the 256 ``<0xNN>`` BYTE pieces under ``byte_fallback``, then
    ``▁`` + each word for a WHOLE_SHARE of the words and ``▁`` + its first
    half and its second half for the rest (each piece scored -8 to -12, so
    a whole word beats any two pieces and a split one takes its two
    halves), single characters (-12 to -16), seeded fillers (-10 to -15)
    until ``size``; cut to ``size`` keeping every character."""
    import string

    import numpy as np

    rng = np.random.default_rng(seed)
    out = [(p, 0.0, kind) for p, kind in head] + ([(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
                                                 if byte_fallback else [])
    pieces: dict[str, float] = {}
    for w in words:
        if len(w) < 4 or rng.random() < WHOLE_SHARE:
            pieces.setdefault("▁" + w, -float(rng.uniform(8, 12)))
        else:
            half = len(w) // 2
            pieces.setdefault("▁" + w[:half], -float(rng.uniform(8, 12)))
            pieces.setdefault(w[half:], -float(rng.uniform(8, 12)))
    chars = {c: -float(rng.uniform(12, 16)) for c in string.ascii_letters + string.digits + string.punctuation
             + "▁éïüßÜ日本語中文株式会社" if c not in pieces}
    room = size - len(out) - len(chars)
    pieces = dict(list(pieces.items())[:room])
    letters = np.array(list(string.ascii_lowercase))
    while len(pieces) < room:
        filler = ("▁" if rng.random() < 0.5 else "") + "".join(rng.choice(letters, int(rng.integers(2, 8))))
        if filler not in chars:
            pieces.setdefault(filler, -float(rng.uniform(10, 15)))
    out += [(p, sc, 1) for p, sc in {**pieces, **chars}.items()]
    assert len(out) == size and len({p for p, _, _ in out}) == size
    return out


def spm_tokenizer_files(words: list[str], kind: str, size: int) -> dict:
    """The tokenizer files of a seeded GPT-SW3 or Marian checkpoint:
    GPT-SW3's ``spiece.model`` (``<unk> <pad> <s> <|endoftext|>``, the byte
    pieces, a Unigram with byte fallback, the identity normalizer keeping
    every space) and ``tokenizer_config.json`` naming ``GPTSw3Tokenizer``;
    or Marian's ``source.spm`` and ``target.spm`` (``<unk> <s> </s>``, a
    Unigram behind the seeded charsmap), ``vocab.json`` in opus-mt's layout
    (``</s>`` 0, ``<unk>`` 1, the pieces, ``<pad>`` last, ``size``
    entries) and ``tokenizer_config.json`` naming ``MarianTokenizer``."""
    from lotus_tpu_torch.models.charsmap import build_charsmap

    if kind == "gpt-sw3":
        head = [("<unk>", 2), ("<pad>", 3), ("<s>", 3), ("<|endoftext|>", 3)]
        model = spm_model_bytes(spm_pieces(words, size, 80, head, byte_fallback=True), byte_fallback=True,
                                pad_id=1, bos_id=2, eos_id=3, remove_extra_whitespaces=False)
        return {"spiece.model": model,
                "tokenizer_config.json": {"tokenizer_class": "GPTSw3Tokenizer", "do_lower_case": False,
                                          "remove_space": False, "keep_accents": True, "bos_token": "<s>",
                                          "eos_token": "<|endoftext|>", "unk_token": "<unk>", "pad_token": "<pad>"}}
    pieces = spm_pieces(words, size, 81, [("<unk>", 2), ("<s>", 3), ("</s>", 3)])
    model = spm_model_bytes(pieces, charsmap=build_charsmap(SMOKE_CHARSMAP), name="nmt_nfkc")
    vocab = {"</s>": 0, "<unk>": 1}
    for p, _, _ in pieces:
        if p != "<s>":
            vocab.setdefault(p, len(vocab))
    vocab["<pad>"] = len(vocab)
    assert len(vocab) == size
    return {"source.spm": model, "target.spm": model, "vocab.json": vocab,
            "tokenizer_config.json": {"tokenizer_class": "MarianTokenizer", "source_lang": "en", "target_lang": "de"}}


def spm_check_phase(dev, vocab: list[str], dirs: dict, n_docs: int = 16) -> None:
    """Phase 32a: each model as an RM through its entry point on the card and
    on the CPU in f32 (``n_docs`` docs of mixed length with characters the
    seeded vocabularies lack, 4 a batch): within 2e-6, bf16 against f32
    smallest cosine at least 0.999 (``check_rm``), and each one's tokens a
    word.  Then where the reference fails the port must raise
    ``ValueError``: GPT-SW3 with a pad token its ``spiece.model`` lacks
    (the slow class adds it past the 64,000 pieces, where the reference's
    embeddings are NaN), Marian on a bucket past its 512 positions."""
    import numpy as np

    from lotus_tpu_torch.models import GPTSw3Tokenizer, TorchSentenceEncoderRM

    quarter = n_docs // 4
    docs = [t for i, (lo, hi) in enumerate(((3, 10), (11, 24), (25, 50), (51, 100)))
            for t in synth_texts(vocab, quarter, lo, hi, 330 + i)]
    docs = multilingual(docs, 335)
    for name, d in dirs.items():
        shape = SPM_MODELS[name]
        kw = dict(model=d, max_batch_size=4, max_seq_length=512)
        width = shape.get("n_embd", shape.get("d_model"))
        check_rm(dev, name, shape["model_type"], kw, docs, width, tol=2e-6, min_cos=0.999)
        rm = TorchSentenceEncoderRM(device=dev, **kw)
        tokens = sum(map(len, rm.tokenizer.encode(docs)))
        say(f"    {name} tokenizer ({type(rm.tokenizer).__name__}): {tokens / sum(len(t.split()) for t in docs):.3f} "
            f"tokens a word over the check docs")
        if shape["tokenizer"] == "gpt-sw3":
            rm.tokenizer = GPTSw3Tokenizer(rm.tokenizer.sp, {"pad_token": "<pad-absent>"}, name_or_path=d)
            label, docs_in = f"pad id {rm.tokenizer.pad_id} past the {len(rm.tokenizer.sp):,} pieces", docs[:2]
            want = "outside the model's"
        else:
            rm = TorchSentenceEncoderRM(device=dev, **{**kw, "max_seq_length": 1024})
            long_doc = " ".join(np.random.default_rng(336).choice(vocab[1000:], 900))
            label, docs_in, want = "a 1024-token bucket", [docs[0], long_doc], "longer than max_position_embeddings"
        try:
            rm(docs_in)
            raised = None
        except ValueError as e:
            raised = str(e)
        say(f"    {name} with {label}: {raised!r}")
        assert raised is not None and want in raised, f"{name}: no ValueError where the reference fails"
        del rm


def gpt_sw3_phase(dev, vocab: list[str], n: int = 4096, nq: int = 512, nlist: int = 8,
                  layers: int = GPT_SW3_LAYERS, root: str = SPM_DIR) -> int:
    """Phase 32b, GPT-SW3 6.7B (gpt-sw3-6.7b-v2) at full width and ``layers``
    deep (32, its own) in bf16 through ``sharded_decoder_phase``, its docs
    drawn from the words the seeded 64,000-piece ``spiece.model`` holds
    whole (``▁`` + the word), padded on the right as the slow class pads.
    Returns K1's launches."""
    return sharded_decoder_phase(dev, vocab, "gpt-sw3-6.7b-v2", dict(SPM_MODELS["gpt-sw3-6.7b-v2"], n_layer=layers),
                                 seed=82, doc_seed=340, marker="▁",
                                 tokenizer_label="sentencepiece Unigram (spiece.model, byte fallback)", n=n, nq=nq,
                                 nlist=nlist, root=root, padding_side="right")


def marian_phase(dev, vocab: list[str], n: int = 4096, nq: int = 256, layers: int = MARIAN_LAYERS,
                 root: str = SPM_DIR) -> int:
    """Phase 32c, Marian at opus-mt-en-de's widths and depth (``layers``, 6
    a stack) in bf16, its tokenizer ``source.spm`` with ``vocab.json``:
    ``n`` of config 1's passages (150-300 words, the 512-token bucket) into
    a Flat store through ``flat_text_store`` (recall@10 1.0 through ids, at
    least 0.98 through K2 at d 512, K2 held to its plain version on the
    call's own inputs and timed beside its bound).  Returns K2's launches."""
    import numpy as np
    import torch

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    path = os.path.join(root, "opus-mt-en-de")
    shutil.rmtree(path, ignore_errors=True)
    words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
    shape = dict(SPM_MODELS["opus-mt-en-de"], encoder_layers=layers, decoder_layers=layers)
    written = write_decoder(path, shape, words, dev, seed=83)
    t0 = time.perf_counter()
    passages = synth_texts(vocab, n, 150, 300, 56, per_topic=K)
    queries = [" ".join(np.random.default_rng(57 + i).choice(passages[j].split()[:40], 12))
               for i, j in enumerate(np.random.default_rng(58).integers(0, n, nq))]
    say(f"  opus-mt-en-de ({layers} + {layers} layers, {written:,} parameters); {n:,} passages of 150-300 words, {nq} "
        f"queries of 12 words from a passage's first 40; made in {time.perf_counter() - t0:.2f} s")
    rss0 = host_rss()
    t0 = time.perf_counter()
    rm, rss1 = host_peak_during(lambda: TorchSentenceEncoderRM(model=path, max_batch_size=CONFIG2_BATCH,
                                                               max_seq_length=512, dtype=torch.bfloat16, device=dev))
    sync(dev)
    say(f"  loaded in {time.perf_counter() - t0:.2f} s; host resident {rss0 / 1e9:.3f} GB before the load, its peak "
        f"during the load {rss1 / 1e9:.3f} GB [{GPU}]")
    emb, fig = encode_split(rm, passages)
    print_split(f"opus-mt-en-de bf16, max_batch_size {CONFIG2_BATCH}", n, fig, BF16_OPS_PER_S, "989 TFLOP/s bf16")
    print_tokenizer("sentencepiece Unigram + charsmap (source.spm, vocab.json ids)", passages, fig)
    launches, _ = flat_text_store(dev, "Marian", rm, passages, emb, queries, 100, SPM_MODELS["opus-mt-en-de"]["d_model"])
    shutil.rmtree(path, ignore_errors=True)
    return launches


def spm_phases(dev, vocab: list[str]) -> tuple[int, int]:
    """Phase 32: GPT-SW3 and Marian at published widths 2 layers deep, card
    against CPU, and where the reference fails; GPT-SW3 6.7B at full width
    and depth through K1; opus-mt-en-de through K2 at d 512; the files
    deleted.  Returns K1's and K2's launches."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with Phase("GPT-SW3 and Marian (sentencepiece .model files) at published widths, 2 layers (seeded weights): card "
               "against CPU, bf16 against f32, where the reference fails"):
        t0 = time.perf_counter()
        shutil.rmtree(SPM_DIR, ignore_errors=True)
        words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
        dirs = {}
        for i, (name, shape) in enumerate(SPM_MODELS.items()):
            dirs[name] = os.path.join(SPM_DIR, name)
            write_decoder(dirs[name], shape, words, dev, seed=75 + i)
        say(f"  {len(dirs)} checkpoints ({dir_bytes(SPM_DIR) / 1e9:.3f} GB: bf16 model.safetensors, config.json, "
            f"spiece.model or source.spm + vocab.json) written in {time.perf_counter() - t0:.2f} s under "
            f"{os.path.relpath(SPM_DIR, REPO)}")
        spm_check_phase(dev, vocab, dirs)
        shutil.rmtree(SPM_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    with Phase("GPT-SW3 6.7B (gpt-sw3-6.7b-v2) at full width and depth in bf16 from a sharded checkpoint: IVF int8, "
               "K1"):
        k1 = gpt_sw3_phase(dev, vocab)
    torch.cuda.empty_cache()
    with Phase("Marian (opus-mt-en-de) in bf16 from text: Flat, K2 at d 512"):
        k2 = marian_phase(dev, vocab)
    shutil.rmtree(SPM_DIR, ignore_errors=True)
    say(f"  phase 32: {time.perf_counter() - t_phase:.1f} s wall; card peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{GPU}]")
    return k1, k2


# ---------------------------------------------------------------------------
# Phase 33: the serving tier on the card (lotus_tpu_torch.serving, .native)
# ---------------------------------------------------------------------------

SERVE_DIR = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_serving")
QUARTERS = 4  # 33a's shard servers: one child process a quarter of config 4, all on this card
# Config 4's per-list shape (2,560 rows a list) over a quarter of its rows:
# nlist cut by 4.  nprobe stays config 4's 208: at 52, the same share of the
# lists, the quarters' merged recall@10 falls below the 0.95 gate
# (``quarter_stores`` prints both); their quantizer is coarser against the
# corpus's 65,536 synthetic clusters (64 a list, not 16).
QUARTER = dict(CONFIG4, n=CONFIG4["n"] // QUARTERS, nlist=CONFIG4["nlist"] // QUARTERS)
QUARTER_STORE = dict(index_type="ivf", device_dtype="int8", int8_refine=True, nprobe=NPROBE, rescore=RESCORE,
                     int8_queries=True, query_chunk=QUERY_CHUNK)
FLAT_SHARD_STORE = dict(index_type="flat", device_dtype="bfloat16", scan="pallas")  # 33b's halves
SERVE_BATCHES = 5  # timed B-query batches through the front end, after the one whose recall is taken
SINGLE_REQUESTS = 200  # single-query requests, each timed on the front end's clock
SERVE_TIMEOUT = 300  # seconds the shard servers may take to load, or to stop, before they are killed


def write_record(path: str, record: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)  # a reader never sees a partial record


class TimedStore:
    """A store as ``vs_search_fn`` calls it, keeping the seconds of each
    ``__call__`` in order (``seconds``) and its last batch of several
    queries (``last``)."""

    def __init__(self, vs):
        self.vs, self.seconds, self.last = vs, [], None

    def __call__(self, xq, k):
        t0 = time.perf_counter()
        out = self.vs(xq, k)
        self.seconds.append(time.perf_counter() - t0)
        if len(xq) > 1:
            self.last = xq
        return out


def timed_search_fn(store: TimedStore, id_offset: int):
    """``vs_search_fn`` over ``store``, keeping the seconds of each request
    (the store's call and the ``RMOutput`` lists' way back to arrays) in
    its ``seconds``."""
    from lotus_tpu_torch.serving import vs_search_fn

    inner = vs_search_fn(store, id_offset)

    def search(xq, k):
        t0 = time.perf_counter()
        out = inner(xq, k)
        search.seconds.append(time.perf_counter() - t0)
        return out

    search.seconds = []
    return search


def serve_main(index_dir: str, id_offset: int) -> int:
    """One shard server of phase 33a (``chip_smoke.py --serve <index_dir>
    <id_offset>``), started by ``shard_servers``: loads its quarter into a
    ``TorchVS`` on the card, serves it through ``ShardServer`` until its
    standard input closes, then writes its exit record (K1's launches over
    the requests it served, each request's seconds, its counters) after
    holding K1 to its plain version on the inputs its store's call gives it
    (``k1_store_compare``; those launches are not counted)."""
    import torch

    if not torch.cuda.is_available():
        print("serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.ivf_probe import probe_fold
    from lotus_tpu_torch.serving import ShardServer

    global GPU
    GPU = card()
    t0 = time.perf_counter()
    vs = TorchVS(**QUARTER_STORE)
    vs.load_index(index_dir)
    vs._materialize()  # the quarter onto the card before the first request
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    store = TimedStore(vs)
    search = timed_search_fn(store, id_offset)
    probe_fold.launches = 0  # count only what the requests launch
    server = ShardServer(search).start()
    write_record(os.path.join(index_dir, "serve_ready.json"),
                 dict(port=server.address[1], load_s=load_s, resident=torch.cuda.memory_allocated()))
    sys.stdin.read()  # the parent closes it to stop the server
    server.stop()
    record = dict(launches=probe_fold.launches, stats=server.stats, routes=dict(vs.stats["routes"]), load_s=load_s,
                  store_s=store.seconds, fn_s=search.seconds, peak=torch.cuda.max_memory_allocated())
    assert store.last is not None, "the server saw no batch"
    record["k1"] = k1_store_compare(f"shard at id offset {id_offset:,}", vs, store.last[:QUERY_CHUNK], K)
    write_record(os.path.join(index_dir, "serve_exit.json"), record)
    return 0


def quarter_stores(dev, gt, root: str = SERVE_DIR, cfg: dict = QUARTER, quarters: int = QUARTERS) -> list:
    """33a's stores: config 4's seeded corpus cut into ``quarters``
    contiguous row ranges, each built on the card with config 4's per-list
    shape (``synth_ivf_device_build(first_chunk=...)``) and written as a
    ``TorchVS`` index directory as built (``save_ivf_state``).  Beside it,
    each built quarter is searched in this process for the first
    ``len(gt)`` queries at nprobe 52 (config 4's share of the lists) and at
    the served nprobe, and the merged recall of each against ``gt`` is
    printed: what chose 33a's nprobe.  Returns (directory, id offset) for
    each."""
    import numpy as np
    import torch

    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build
    from lotus_tpu_torch.ops.ivf import save_ivf_state
    from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    say(f"  free disk {shutil.disk_usage(root).free / 2**30:.1f} GiB at {os.path.relpath(root, REPO)}")
    stores = []
    probes = sorted({max(1, NPROBE * cfg["nlist"] // CONFIG4["nlist"]), QUARTER_STORE["nprobe"]})
    found = {p: [] for p in probes}
    for q in range(quarters):
        built = synth_ivf_device_build(**cfg, first_chunk=q * (cfg["n"] // cfg["chunk"]), device=dev)
        for p in probes:
            d, i = ivf_search_grouped_probe(built["state"], built["queries"][: len(gt)], K, nprobe=p, metric="ip",
                                            rescore=RESCORE, int8_queries=True)
            found[p].append((d.cpu().numpy(), i.cpu().numpy() + q * cfg["n"]))
        path = os.path.join(root, f"quarter{q}")
        t0 = time.perf_counter()
        save_ivf_state(path, built["state"])
        meta = built["state"]["meta"]
        say(f"  quarter {q} (rows {q * cfg['n']:,}..{(q + 1) * cfg['n'] - 1:,}): built in "
            f"{built['build_seconds']:.3f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in built["timings"].items())
            + f"), nlist {meta['nlist']}, window {meta['probe_window']}; {dir_bytes(path) / 1e9:.3f} GB written in "
            f"{time.perf_counter() - t0:.2f} s [{GPU}]")
        stores.append((path, q * cfg["n"]))
        del built
        torch.cuda.empty_cache()
    for p in probes:
        s, i = (np.concatenate([f[j] for f in found[p]], 1) for j in (0, 1))
        merged = np.take_along_axis(i, np.argsort(-s, axis=1, kind="stable")[:, :K], 1)
        say(f"  the {quarters} quarters at nprobe {p} of {cfg['nlist']}, searched here and merged: recall@{K} "
            f"{recall_at(merged, gt)!r} over {len(gt)} queries")
    return stores


def shard_servers(stores: list, timeout: float = SERVE_TIMEOUT):
    """Start one ``chip_smoke.py --serve`` child a store and wait until each
    listens.  Returns the processes and their ready records; a child that
    fails or does not start in ``timeout`` seconds stops them all."""
    procs = []
    for path, offset in stores:
        with open(os.path.join(path, "serve.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve", path, str(offset)],
                                          stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT))
    ready_files = [os.path.join(path, "serve_ready.json") for path, _ in stores]
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(f) for f in ready_files):
        if any(p.poll() is not None for p in procs) or time.monotonic() > deadline:
            stop_shard_servers(procs, stores, timeout=0)
            raise AssertionError("a shard server did not start")
        time.sleep(0.2)
    ready = []
    for f in ready_files:
        with open(f) as fh:
            ready.append(json.load(fh))
    return procs, ready


def stop_shard_servers(procs, stores: list, timeout: float = SERVE_TIMEOUT) -> list[dict]:
    """Close each child's standard input (its signal to stop), wait for it
    (killing it after ``timeout`` seconds) and return the exit records; a
    child that failed has the end of its log printed and fails the phase."""
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for (path, _), code in zip(stores, codes):
            with open(os.path.join(path, "serve.log")) as f:
                say(f"  shard server {os.path.basename(path)} exited {code}; the end of its log:\n" + f.read()[-3000:])
        raise AssertionError(f"shard servers exited {codes}")
    records = []
    for path, _ in stores:
        with open(os.path.join(path, "serve_exit.json")) as f:
            records.append(json.load(f))
    return records


def outside_share(walls: list[float], store_s: list[list[float]]) -> float:
    """The share of the front end's wall, over requests with these walls,
    that lies outside the stores' calls: each request's wall less its
    slowest shard's ``__call__`` (the shards run side by side)."""
    inside = [max(s[i] for s in store_s) for i in range(len(walls))]
    return 1.0 - sum(inside) / sum(walls)


def serving_config4_phase(stores: list, xq, gt, whole_recall: float):
    """33a: config 4's quarters behind ``QUARTERS`` shard-server processes and
    one ``SearchFrontEnd`` over loopback.  Returns K1's launches (the
    children's), the candidate pools of one B-query batch ((B, QUARTERS, K)
    scores and global ids, as each shard answered) and the front end's
    merged ids of the same batch."""
    import numpy as np

    from lotus_tpu_torch import native
    from lotus_tpu_torch.serving import SearchFrontEnd

    native.lib()  # built here: the front end merges through it from its first request
    t0 = time.perf_counter()
    procs, ready = shard_servers(stores)
    say(f"  {len(procs)} shard servers listening after {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"quarter {q} loaded in {r['load_s']:.2f} s, {r['resident'] / 2**30:.3f} GiB resident"
        for q, r in enumerate(ready)) + f" [{GPU}]")
    try:
        fe = SearchFrontEnd([("127.0.0.1", r["port"]) for r in ready])
        t0 = time.perf_counter()
        dists, ids = fe.search(xq, K)
        first_s = time.perf_counter() - t0
        recall = recall_at(ids, gt)
        finite = (bool(np.isfinite(dists).all()) and ids.shape == (len(xq), K) and int(ids.min()) >= 0
                  and int(ids.max()) < QUARTERS * QUARTER["n"])
        walls = []
        for _ in range(SERVE_BATCHES):
            t0 = time.perf_counter()
            fe.search(xq, K)
            walls.append(time.perf_counter() - t0)
        singles = []
        for i in range(SINGLE_REQUESTS):
            t0 = time.perf_counter()
            fe.search(xq[i], K)
            singles.append(time.perf_counter() - t0)
        pools = [c.search(xq, K) for c in fe.clients]  # one more batch a shard: 33c's candidate pools
        stats = fe.stats()
        fe.close()
    except BaseException:
        stop_shard_servers(procs, stores, timeout=0)
        raise
    records = stop_shard_servers(procs, stores)
    launches = sum(r["launches"] for r in records)
    batch_store = [r["store_s"][1 : 1 + SERVE_BATCHES] for r in records]
    batch_fn = [r["fn_s"][1 : 1 + SERVE_BATCHES] for r in records]
    single_store = [r["store_s"][1 + SERVE_BATCHES : 1 + SERVE_BATCHES + SINGLE_REQUESTS] for r in records]
    lat = np.asarray(singles) * 1e3
    say(f"  recall@{K} vs exact f32 over the whole corpus = {recall!r} over {len(gt)} queries (the whole store, "
        f"phase 5: {whole_recall!r}; gate 0.95, BASELINE's bar 0.99: {'met' if recall >= 0.99 else 'missed'}); "
        f"finite {finite}; first batch {first_s:.3f} s")
    say(f"  front end: QPS {len(xq) * SERVE_BATCHES / sum(walls):,.1f} at B {len(xq)}, k {K} ({1e3 * min(walls):.2f}"
        f"..{1e3 * max(walls):.2f} ms a batch); single requests p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms over {SINGLE_REQUESTS} [{GPU}]")
    say(f"  outside the {QUARTERS} stores' __call__ (frames, loopback, vs_search_fn's list round trip, the merge): "
        f"{100 * outside_share(walls, batch_store):.1f}% of the batches' wall, "
        f"{100 * outside_share(singles, single_store):.1f}% of the single requests'; the stores' calls "
        f"{1e3 * np.mean(batch_store):.2f} ms a batch on average (slowest shard "
        f"{1e3 * np.mean(np.max(batch_store, axis=0)):.2f}), vs_search_fn's lists to arrays "
        f"{1e3 * (np.mean(batch_fn) - np.mean(batch_store)):.2f} ms a batch [{GPU}]")
    say(f"  OP_STATS over the front end: {stats['searches']} searches, {stats['queries']:,} queries")
    for q, r in enumerate(records):
        err, ms, plain_ms, bound, by = r["k1"][0]
        say(f"  shard server {q}: K1 launches {r['launches']} over {r['stats']['searches']} requests, routes "
            f"{r['routes']}; K1 against its plain version on its store call's inputs: max_abs_err {err!r}, "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}); peak {r['peak'] / 2**30:.2f} "
            f"GiB [{GPU}]")
    say(f"  K1 launches of this path: {launches} (the {QUARTERS} children's)")
    assert finite, "the front end's output is not finite, has the wrong shape or ids out of range"
    assert recall >= 0.95, f"served recall@10 {recall} below 0.95"
    assert all(r["launches"] > 0 for r in records), "a shard server did not launch K1"
    pool_s = np.stack([p[0] for p in pools], 1)
    pool_i = np.stack([p[1] for p in pools], 1)
    return launches, pool_s, pool_i, ids


def serving_flat_phase(dev, single_recall: float, root: str = SERVE_DIR, halves: int = 2) -> int:
    """33b: the flat-scan corpus in ``halves`` row shards, each a
    ``TorchVS(**FLAT_SHARD_STORE)`` (bf16 rows, K2) behind a ``ShardServer``
    thread of this process, one front end over loopback.  Returns K2's
    launches over the front end's requests."""
    import numpy as np
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.flat_scan import scan_fold
    from lotus_tpu_torch.serving import SearchFrontEnd, ShardServer

    corpus, fq, flat_gt, _ = flat_corpus(dev)
    emb, q_np = corpus.cpu().numpy(), fq.cpu().numpy()
    del corpus, fq
    n = emb.shape[0] // halves
    shutil.rmtree(root, ignore_errors=True)
    stores, fns, servers = [], [], []
    try:
        for h in range(halves):
            vs = TorchVS(**FLAT_SHARD_STORE)
            t0 = time.perf_counter()
            vs.index([], emb[h * n : (h + 1) * n], os.path.join(root, f"half{h}"))
            say(f"  half {h} (rows {h * n:,}..{(h + 1) * n - 1:,}): index() {time.perf_counter() - t0:.2f} s")
            stores.append(TimedStore(vs))
            fns.append(timed_search_fn(stores[-1], h * n))
            servers.append(ShardServer(fns[-1]).start())
        del emb
        scan_fold.launches = 0  # count only the front end's requests
        with SearchFrontEnd([s.address for s in servers]) as fe:
            t0 = time.perf_counter()
            _, ids = fe.search(q_np, K)
            first_s = time.perf_counter() - t0
            walls = []
            for _ in range(SERVE_BATCHES):
                t0 = time.perf_counter()
                fe.search(q_np, K)
                walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = scan_fold.launches
    finally:
        for s in servers:
            s.stop()
    recall = recall_at(ids, flat_gt)
    store_s = [s.seconds[1 : 1 + SERVE_BATCHES] for s in stores]
    fn_s = [f.seconds[1 : 1 + SERVE_BATCHES] for f in fns]
    say(f"  recall@{K} vs exact f32 = {recall!r} over {len(flat_gt)} queries (the single store, phase 21: "
        f"{single_recall!r}); first batch {first_s:.3f} s (loads each half onto the card); K2 launches {launches}")
    say(f"  front end: QPS {len(q_np) * SERVE_BATCHES / sum(walls):,.1f} at B {len(q_np)}, k {K} "
        f"({1e3 * min(walls):.2f}..{1e3 * max(walls):.2f} ms a batch); outside the stores' __call__: "
        f"{100 * outside_share(walls, store_s):.1f}% of the wall (the stores' calls {1e3 * np.mean(store_s):.2f} ms "
        f"a batch, the slower {1e3 * np.mean(np.max(store_s, axis=0)):.2f}; their calls run one at a time on this "
        f"process's stream; vs_search_fn's lists to arrays {1e3 * (np.mean(fn_s) - np.mean(store_s)):.2f} ms) [{GPU}]")
    k2_store_compare(f"33b, half 0 of {halves}", stores[0].vs, q_np, K)
    shutil.rmtree(root, ignore_errors=True)
    assert launches > 0, "the Flat shards did not launch K2"
    assert recall >= single_recall - 0.001, f"served recall@10 {recall} below the single store's {single_recall}"
    return launches


def merge_phase(pool_s, pool_i, served_ids) -> None:
    """33c: ``native.topk_merge_batch`` against its plain version on 33a's
    (B, QUARTERS, K) candidate pools: scores bit for bit, ids equal except
    where two candidates of a query's pool hold the same score, whose order
    the library takes from its heap and the plain version from a stable
    sort (the reference's own two merges differ so; ROADMAP Queue 3)."""
    import numpy as np

    from lotus_tpu_torch import native

    got_s, got_i = native.topk_merge_batch(pool_s, pool_i, K)
    ref_s, ref_i = native.topk_merge_batch_reference(pool_s, pool_i, K)
    scores_same = np.array_equal(got_s.view(np.int32), ref_s.view(np.int32))
    moved = list(zip(*np.nonzero(got_i != ref_i)))
    untied = [(q, j) for q, j in moved if np.count_nonzero(pool_s[q] == got_s[q, j]) < 2]
    descending = bool((np.diff(pool_s, axis=-1) <= 0).all())
    lib_ms = host_ms(lambda: native.topk_merge_batch(pool_s, pool_i, K), reps=5)
    plain_ms = host_ms(lambda: native.topk_merge_batch_reference(pool_s, pool_i, K), reps=1)
    say(f"  {pool_s.shape} pools (33a's shards' own answers; every list descending {descending}, ids -1 "
        f"{int((pool_i < 0).sum())}): scores {'bitwise equal' if scores_same else 'DIFFER'}; ids equal but at "
        f"{len(moved)} places in {len({q for q, _ in moved})} queries, {len(moved) - len(untied)} of them on a "
        f"score two candidates of the pool share; the library {lib_ms:.3f} ms vs the plain version "
        f"{plain_ms:.3f} ms (host clock); the merge equals the front end's answer to the same batch: "
        f"{np.array_equal(got_i, served_ids)}")
    assert scores_same and not untied, "native.topk_merge_batch differs from its plain version"


def serving_phases(dev, xq, gt, whole_recall: float, flat_recall: float) -> tuple[int, int]:
    """Phase 33.  Returns K1's and K2's launches on its two paths."""
    import torch

    with Phase(f"33a: config 4 in {QUARTERS} row shards, each a TorchVS behind a shard-server process, one "
               f"front end over loopback: K1"):
        stores = quarter_stores(dev, gt)
        k1, pool_s, pool_i, served = serving_config4_phase(stores, xq, gt, whole_recall)
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    with Phase("33b: the flat-scan corpus in 2 row shards behind shard-server threads: K2"):
        k2 = serving_flat_phase(dev, flat_recall)
    torch.cuda.empty_cache()
    with Phase("33c: the front end's merge (native.topk_merge_batch) against its plain version"):
        merge_phase(pool_s, pool_i, served)
    return k1, k2


def text_phases(dev) -> tuple[int, int, int, tuple]:
    """Phases 23-32 (the models, configs 1-2 from text, profiling, the
    families past BERT, the encoder-decoders, the decoders, BLOOM and
    XGLM, GPT-SW3 and Marian).  Returns K1's and K2's launches on their main
    paths, phase 27's K2 launches and K2's figures at d 1024."""
    with Phase("models at published widths (seeded weights): card against CPU, bf16 against f32"):
        t0 = time.perf_counter()
        vocab = smoke_vocab()
        shutil.rmtree(MODELS_DIR, ignore_errors=True)
        dirs = write_models(vocab, dev)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(MODELS_DIR) for f in fs)
        say(f"  {len(vocab):,}-entry vocabulary and {len(dirs)} checkpoints ({size / 1e9:.3f} GB of "
            f"model.safetensors and vocab.txt) written in {time.perf_counter() - t0:.2f} s under "
            f"{os.path.relpath(MODELS_DIR, REPO)}")
        models_phase(dev, vocab, dirs)
    with Phase("BASELINE config 1 from text (MiniLM 384-d, Flat, K2, rerank)"):
        k2 = config1_text_phase(dev, vocab, dirs)
    with Phase("BASELINE config 2's encoder (e5-base-v2 768-d bf16, IVF int8, K1)"):
        k1 = config2_text_phase(dev, vocab, dirs)
    with Phase("profiling (profiling.trace in a child process)"):
        profiling_phase()
    shutil.rmtree(MODELS_DIR, ignore_errors=True)
    fam_k1, fam_k2, k2_d1024 = families_phases(dev, vocab)
    late_k1, late_k2 = late_phases(dev, vocab)
    s2s_k1, s2s_k2 = seq2seq_phases(dev, vocab)
    dec_k1, dec_k2 = decoder_phases(dev, vocab)
    alibi_k1, alibi_k2 = alibi_phases(dev, vocab)
    spm_k1, spm_k2 = spm_phases(dev, vocab)
    shutil.rmtree(TEXT_INDEX_DIR, ignore_errors=True)
    return (k1 + fam_k1 + late_k1 + s2s_k1 + dec_k1 + alibi_k1 + spm_k1,
            k2 + fam_k2 + late_k2 + s2s_k2 + dec_k2 + alibi_k2 + spm_k2, fam_k2, k2_d1024)


def config4_paths(dev) -> dict:
    """Phases 3-10 and the ids path over config 4's store.  The store lives
    only in this function's frame, so it is freed when the function returns
    (the spilled build must not coexist with it).  Returns K1's main-variant
    figures and launches, K3's and its launches, K2's launches on the residual scan, the new
    variants' figures and the unspilled run's build and search figures."""
    import torch

    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk, synth_ivf_device_build
    from lotus_tpu_torch.ops.flat import flat_search
    from lotus_tpu_torch.ops.flat_scan import ivf_residual_scan, residual_scan_inputs, scan_fold
    from lotus_tpu_torch.ops.ivf_probe import (
        LOCAL_BITS, ivf_search_grouped_probe, pool_select, probe_fold, probe_fold_reference, probe_layout,
    )
    from lotus_tpu_torch.ops.quant import quantize_rows

    with Phase("config 4 build"):
        torch.cuda.reset_peak_memory_stats()
        built = synth_ivf_device_build(**CONFIG4, device=dev, log=say)
        state, xq, gt = built["state"], built["queries"], built["gt"]
        meta = state["meta"]
        unspilled = dict(build_s=built["build_seconds"], vecs_s=built["build_vecs_per_s"], timings=built["timings"],
                         peak=torch.cuda.max_memory_allocated())
        say(f"  build {built['build_seconds']:.2f} s = {built['build_vecs_per_s']:,.0f} vecs/s; phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in built["timings"].items())
            + f"; window {meta['probe_window']}; peak {unspilled['peak'] / 2**30:.2f} GiB [{GPU}]")

    with Phase("K1 vs plain version"):
        bl = int(meta["block_align"])
        vecs, scales = state["ivf_vectors"], state["ivf_row_scales"]
        starts, sizes = state["ivf_list_start"], state["ivf_list_size"]
        q = xq[:QUERY_CHUNK]
        _, lists = flat_search(state["centroids"], q, NPROBE, metric="ip")
        packed_main = int(meta["probe_window"]) <= (1 << LOCAL_BITS)
        units, chunk_list, _, _ = probe_layout(lists.to(torch.int32), quantize_rows(q)[0], sizes, bl)
        main_args = (units, vecs, scales, None, chunk_list, starts, sizes)
        main_err, main_ms, main_plain_ms = compare(
            f"int8-dot {'packed' if packed_main else 'unpacked'} (config 4, {QUERY_CHUNK} queries)",
            main_args, bl=bl, int8_dot=True, l2=False, packed=packed_main, exact=True, reps=10,
        )
        main_bound, main_by, n_live, macs, streamed = k1_bound(
            units, vecs, chunk_list, sizes, int8_dot=True, packed=packed_main)
        say(f"  K1 work: {macs:.4e} int8 MACs in {n_live} live chunks -> "
            f"{2 * macs / (main_ms * 1e-3) / 1e12:.1f} TOP/s; bound {main_bound:.3f} ms ({main_by}; each probed "
            f"list read once), K1 at {100 * main_bound / main_ms:.1f}% of it; the live chunks stream "
            f"{streamed / 1e9:.3f} GB ({1e3 * streamed / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s) [{GPU}]")
        units_bf, _, _, _ = probe_layout(lists.to(torch.int32), q.to(torch.bfloat16), sizes, bl)
        _, bf_ms, bf_plain_ms = compare(
            "int8 store, bf16 queries (dequant), config 4",
            (units_bf, vecs, scales, None, chunk_list, starts, sizes), bl=bl, int8_dot=False,
            l2=False, packed=packed_main, exact=False, tol=2e-3, reps=5)
        bf_bound, bf_by, _, _, _ = k1_bound(units_bf, vecs, chunk_list, sizes, int8_dot=False, packed=packed_main)
        say(f"  bf16-query K1 {bf_ms:.3f} ms; bound {bf_bound:.3f} ms ({bf_by}), K1 at "
            f"{100 * bf_bound / bf_ms:.1f}% of it [{GPU}]")
        # The top-1 fold at the config-4 shape: packed, bit for bit.
        compare("top-1 fold, int8-dot packed (config 4)", main_args, bl=bl, int8_dot=True, l2=False,
                packed=packed_main, exact=True, top1=True)
        # The rescored top-k through the plain version equals K1's.
        kw = dict(nprobe=NPROBE, metric="ip", int8_queries=False, rescore=RESCORE)
        _, i_k1 = ivf_search_grouped_probe(state, xq[:256], K, **kw)
        _, i_pl = ivf_search_grouped_probe(state, xq[:256], K, fold=probe_fold_reference, **kw)
        same_sets = all(set(a) == set(b) for a, b in zip(i_k1.tolist(), i_pl.tolist()))
        say(f"  rescored top-{K} sets, K1 vs plain (bf16 queries, 256 queries): "
            f"{'equal' if same_sets else 'DIFFER'}")
        assert same_sets, "rescored top-k sets differ between K1 and its plain version"

        # Float stores at full width over the first 512 lists.
        nl = 512
        rows = int(starts[nl])
        xf = vecs[:rows].float() * scales[:rows, None]
        g = torch.Generator(device=dev).manual_seed(5)
        sub_lists = torch.argsort(torch.rand((512, nl), generator=g, device=dev), dim=1)[:, :26].to(torch.int32)
        sub = (starts[:nl].contiguous(), sizes[:nl].contiguous())
        new_variants = {}  # the variants this slice added, for the kernels line
        for name, xs, qdt, l2, packed in (
            ("bf16 store, packed", xf.to(torch.bfloat16), torch.bfloat16, False, True),
            ("f32 store, unpacked", xf, torch.float32, False, False),
            ("bf16 store, l2, unpacked", xf.to(torch.bfloat16), torch.bfloat16, True, False),
            ("f16 store, f32 queries, unpacked", xf.to(torch.float16), torch.float32, False, False),
            ("f16 store, f32 queries, packed", xf.to(torch.float16), torch.float32, False, True),
        ):
            units_s, cl_s, _, _ = probe_layout(sub_lists, xq[:512].to(qdt), sub[1], bl)
            norms = (xs.float() ** 2).sum(1) if l2 else None
            f16 = xs.dtype == torch.float16 and not packed
            out = compare(name, (units_s, xs, None, norms, cl_s, *sub), bl=bl, int8_dot=False, l2=l2,
                          packed=packed, exact=False, tol=1e-4 if not packed else 2e-3, reps=3 if f16 else 0)
            if f16:
                new_variants["K1 f16"] = (*out, *k1_bound(units_s, xs, cl_s, sub[1], int8_dot=False, packed=False,
                                                          rate=F32_OPS_PER_S)[:2])
        del xf
        # The int8 dot at depths that are not whole 32-bit words (d 770 and
        # 66), packed and unpacked, bit for bit: config 4's rows of these
        # lists widened or cut.
        x8, q8 = vecs[:rows], quantize_rows(xq[:512])[0]
        for dd in (770, 66):
            xs = (torch.cat([x8, x8[:, : dd - 768]], 1) if dd > 768 else x8[:, :dd]).contiguous()
            qs = (torch.cat([q8, q8[:, : dd - 768]], 1) if dd > 768 else q8[:, :dd]).contiguous()
            units_r, cl_r, _, _ = probe_layout(sub_lists, qs, sub[1], bl)
            for packed in (True, False):
                timed = dd == 770 and packed
                out = compare(f"int8-dot at d {dd}, {'packed' if packed else 'unpacked'}",
                              (units_r, xs, scales[:rows], None, cl_r, *sub), bl=bl, int8_dot=True, l2=False,
                              packed=packed, exact=True, reps=3 if timed else 0)
                if timed:
                    new_variants["K1 int8 d770"] = (*out, *k1_bound(units_r, xs, cl_r, sub[1], int8_dot=True,
                                                                    packed=True)[:2])
        del x8, xs

        # A window past 8192 rows: lists of 12 blocks (unpacked, ids compared).
        span = 12 * bl
        nwin = 10
        w_starts = torch.arange(0, nwin * span, span, dtype=torch.int32, device=dev)
        w_sizes = (span - torch.tensor([0, 5, 100, 1023, 1024, 3000, 7, 0, 64, 65],
                                       dtype=torch.int32, device=dev)).contiguous()
        w_lists = torch.argsort(torch.rand((256, nwin), generator=g, device=dev), dim=1)[:, :4].to(torch.int32)
        units_w, cl_w, _, _ = probe_layout(w_lists, quantize_rows(xq[:256])[0], w_sizes, bl)
        for top1 in (False, True):
            compare(f"int8-dot, window 12288 rows (unpacked{', top-1 fold' if top1 else ''})",
                    (units_w, vecs, scales, None, cl_w, w_starts, w_sizes), bl=bl, int8_dot=True, l2=False,
                    packed=False, exact=True, top1=top1)

    with Phase("K3 vs plain version"):
        k3 = k3_compare(state, xq[:QUERY_CHUNK])

    probe_fold.launches = 0  # count only the main path's launches from here
    pool_select.launches = 0
    with Phase("config 4 search"):
        def search(queries):
            return ivf_search_grouped_probe(
                state, queries, K, nprobe=NPROBE, metric="ip", rescore=RESCORE, int8_queries=True,
                query_chunk=QUERY_CHUNK,
            )

        dists, ids = search(xq)
        torch.cuda.synchronize()
        launches_search = probe_fold.launches
        k3_search = pool_select.launches
        recall = recall_at(ids.cpu().numpy(), gt)
        finite = bool(torch.isfinite(dists).all()) and tuple(ids.shape) == (B, K)
        qps, batch_ms = chained_qps(lambda: search(xq), B)
        say(f"  recall@{K} vs exact f32 = {recall!r} over {gt.shape[0]} queries; finite {finite}; "
            f"K1 launches {launches_search}; K3 launches {k3_search} ({-(-B // QUERY_CHUNK)} slices)")
        say(f"  QPS {qps:,.1f} (B={B}, nprobe={NPROBE}, rescore={RESCORE}, int8 queries, "
            f"query_chunk={QUERY_CHUNK}; {batch_ms:.2f} ms per batch) "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{GPU}]")
        assert finite, "search output is not finite or has the wrong shape"
        assert recall >= 0.99, f"recall@10 {recall} below the 0.99 target"
        assert launches_search > 0, "the main path did not launch K1"
        assert k3_search == -(-B // QUERY_CHUNK), "the main path did not launch K3 once a slice"
        unspilled.update(recall=recall, qps=qps, k1_ms=main_ms)
        capacity_report("unspilled", state, CONFIG4["n"], unspilled["peak"])

    with Phase("window probe over config 4 (ivf_search)"):
        window_probe_runs(state, xq, gt, NPROBE, RESCORE, min_recall=0.99, grouped=True, split_budget=1 << 30)

    with Phase("store entry point (TorchVS)"):
        from lotus_tpu_torch.ops.io import read_meta

        n_store = 262_144
        centers = corpus_centers(7, 4096, 768, dev)
        emb_t = gen_chunk(7, 0, centers, n_store, 2.5)
        emb = emb_t.cpu().numpy()
        index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_index")
        shutil.rmtree(index_dir, ignore_errors=True)
        store_kw = dict(index_type="ivf", device_dtype="int8", int8_refine=True, rescore=RESCORE, nlist=256)
        vs = TorchVS(**store_kw)
        t0 = time.perf_counter()
        vs.index([], emb, index_dir)
        say(f"  index() {time.perf_counter() - t0:.2f} s; block_align {read_meta(index_dir)['block_align']}")
        g = torch.Generator(device=dev).manual_seed(11)
        qs = emb_t[:256] + 0.05 * torch.randn((256, 768), generator=g, device=dev)
        qs = (qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True))
        qs_np = qs.cpu().numpy()
        store_gt = torch.topk(qs @ emb_t.T, K, dim=1).indices.tolist()
        before = probe_fold.launches
        out = vs(qs_np, K)
        store_launches = probe_fold.launches - before
        store_recall = recall_at(out.indices, store_gt)
        allowed = sorted(torch.randperm(n_store, generator=torch.Generator().manual_seed(3))[:1000].tolist())
        sub_out = vs(qs_np[:4], K, ids=allowed)
        allowed_set = set(allowed)
        only_allowed = all(i in allowed_set or i == -1 for row in sub_out.indices for i in row)
        say(f"  search without ids: recall@{K} vs exact f32 = {store_recall!r}, K1 launches {store_launches}; "
            f"with ids: only allowed ids {only_allowed}; stats {vs.stats}")
        assert store_launches > 0, "TorchVS did not reach K1"
        assert only_allowed, "ids-restricted search returned an id outside ids"

    with Phase("calibration through K1 (TorchVS.calibrate_nprobe)"):
        calibration_phase(vs, index_dir, store_kw, qs_np, store_gt)
        shutil.rmtree(index_dir, ignore_errors=True)
        del vs, emb, emb_t

    launches = probe_fold.launches  # the main path's launches: search, QPS, window phase, store, calibration
    k3_launches = pool_select.launches
    say(f"  K1 launches of the main path {launches}, K3 {k3_launches}")

    with Phase("config 4 with ids (TorchVS._ivf_subset_search)"):
        ivf_ids_phase(state, xq)

    with Phase("IVF exhaustive scan (ivf_residual_scan, K2)"):
        args, blk, _ = residual_scan_inputs(state, xq[:256])
        k2_compare(f"int8 store, bf16 queries, q.c bias + row mask, blk {blk} (ivf_residual_scan's inputs, "
                   f"B 256 x {args[2]:,} rows)", args, blk=blk, exact=False, reps=3)
        del args
        scan_fold.launches = 0  # K2's second caller, on its own
        _, rids = ivf_residual_scan(state, xq[:256], K, rescore=64)
        torch.cuda.synchronize()
        resid_first = scan_fold.launches
        resid_recall = recall_at(rids.cpu().numpy(), gt)
        resid_ms = cuda_ms(lambda: ivf_residual_scan(state, xq[:256], K, rescore=64), 3)
        say(f"  B=256 over all {state['ivf_vectors'].shape[0]:,} storage rows (bf16 queries, q.c bias, "
            f"row mask), rescore 64: recall@{K} vs exact f32 = {resid_recall!r}; {resid_ms:.3f} ms "
            f"per call; K2 launches {resid_first} [{GPU}]")
        assert resid_recall >= 0.99, f"ivf_residual_scan recall@10 {resid_recall} below 0.99"
        assert resid_first > 0, "ivf_residual_scan did not launch K2"
        resid_launches = scan_fold.launches
        say(f"  K2 launches of this path: {resid_launches} (the first call, then 1 + 3 timed)")

    with Phase("stage breakdown"):
        stage_breakdown(state, xq)

    with Phase("config 5's shards of config 4's store (save_ivf_shards), the same shards in one process"):
        write_config5_shards(state, xq, gt)
        emulated = emulate_config5(state, xq)
        config5 = dict(recall=unspilled["recall"], no_refine=recall_at(emulated["no_refine_ids"], gt))
        say(f"  one process over the same {SHARDS} shards: recall@{K} {recall_at(emulated['emulated'], gt)!r}; the "
            f"single device without the int4 refinement {config5['no_refine']!r} (with it {unspilled['recall']!r}) "
            f"[{GPU}]")
    return dict(config5=config5, k1=(main_err, main_ms, main_plain_ms, main_bound, main_by), k1_launches=launches,
                k3=k3, k3_launches=k3_launches, k2_launches=resid_launches, new_variants=new_variants,
                unspilled=unspilled, queries=xq.cpu().numpy(), gt=gt)


def flat_corpus(dev):
    """The flat-scan setting's seeded corpus (2**20 x 768 f32, normalised),
    its B queries, the exact f32 top-K of the first 256, and the generator
    that drew the queries."""
    import torch

    from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk

    centers = corpus_centers(FLAT_SEED, 4096, 768, dev)
    corpus = gen_chunk(FLAT_SEED, 0, centers, FLAT_N, 2.5)
    g = torch.Generator(device=dev).manual_seed(FLAT_SEED)
    fq = corpus[torch.randint(0, FLAT_N, (B,), generator=g, device=dev)]
    fq = fq + 0.05 * torch.randn((B, 768), generator=g, device=dev)
    fq = fq / torch.linalg.vector_norm(fq, dim=1, keepdim=True)
    flat_gt = torch.topk(fq[:256] @ corpus.T, K, dim=1).indices.tolist()
    return corpus, fq, flat_gt, g


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "lotus_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lotus_tpu_torch import TorchVS
    from lotus_tpu_torch.ops import _kernels
    from lotus_tpu_torch.ops.flat_scan import _pool_topk, flat_search_pallas, scan_fold, scan_fold_reference
    from lotus_tpu_torch.ops.quant import quantize_rows

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    global GPU
    GPU = card()
    with Phase("device"):
        say(f"  {GPU}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    with Phase("build kernels (nvcc)"):
        _kernels.lib()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _kernels.build_log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _kernels.build_log)]
        say(f"  nvcc {_kernels.build_seconds:.2f} s -> {os.path.relpath(_kernels.build(), REPO)}; "
            f"ptxas: {len(regs)} kernels, <= {max(regs, default=0)} registers, "
            f"spill stores {min(spills, default=0)}..{max(spills, default=0)} bytes")
        kernel_report()

    c4 = config4_paths(dev)
    torch.cuda.empty_cache()

    with Phase(f"config 5 on {SHARDS} gloo ranks sharing the card (config 4's shards, TorchVS(mesh), k-means)"):
        c5_launches = config5_phase(c4["config5"])
        shutil.rmtree(CONFIG5_DIR, ignore_errors=True)  # about 15 GB of shards; a failed phase keeps them
    torch.cuda.empty_cache()

    with Phase("config 4 with spill_frac 0.05 (the unspilled store freed)"):
        spill_launches, spill_k3 = spill_phase(dev, c4["unspilled"])
    torch.cuda.empty_cache()

    with Phase("window-regime store (200,000 x 768, nlist 512)"):
        window_store_phase(dev)
    torch.cuda.empty_cache()

    with Phase("Queue 3 stores through TorchVS (f16 IVF, int8 IVF at d 770, f16 Flat)"):
        q3 = queue3_stores_phase(dev)
    torch.cuda.empty_cache()

    with Phase("config 3: k-means 1M x 768 k 1024, the sem_dedup self-join"):
        config3_phase(dev)
    torch.cuda.empty_cache()

    with Phase("the ids path at config 1's and config 2's shapes"):
        ids_path_phase(dev)
    torch.cuda.empty_cache()

    with Phase("flat corpus"):
        corpus, fq, flat_gt, g = flat_corpus(dev)
        xb16 = corpus.to(torch.bfloat16)
        x8, s8 = quantize_rows(corpus)
        q8, _ = quantize_rows(fq)
        qb = fq.to(torch.bfloat16)
        say(f"  {FLAT_N:,} x 768 rows (bf16 store {xb16.numel() * 2 / 2**30:.2f} GiB), {B} queries")

    with Phase("K2 vs plain version"):
        shape = f"B {B} x {FLAT_N:,} rows x 768"
        k2_int8 = k2_compare(f"int8 store, int8 queries ({shape})", (q8, x8, FLAT_N, s8), exact=True, reps=5)
        k2_main = k2_compare(f"bf16 store ({shape})", (qb, xb16, FLAT_N), exact=False, reps=5)
        k2_compare("int8 store, bf16 queries", (qb, x8, FLAT_N, s8), exact=False)
        k2_compare("f32 store (rounded to bf16)", (qb, corpus, FLAT_N), exact=False)
        k2_f16 = k2_compare(f"f16 store (rounded to bf16; {shape})", (qb, corpus.to(torch.float16), FLAT_N),
                            exact=False, reps=3)
        n_odd = FLAT_N - 1077
        k2_compare(f"int8, n_valid {n_odd:,} (not whole 1024 blocks)", (q8, x8, n_odd, s8), exact=True)
        mask = (torch.rand(FLAT_N, generator=g, device=dev) > 0.1).to(torch.int8)
        for blk in (512, 1024):
            bias = 0.1 * torch.randn((FLAT_N // blk, B), generator=g, device=dev)
            k2_compare(f"int8, bias + row mask, blk {blk}", (q8, x8, FLAT_N, s8, bias, mask),
                       blk=blk, exact=True)
            k2_compare(f"int8 store, bf16 queries, bias + row mask, blk {blk}",
                       (qb, x8, FLAT_N, s8, bias, mask), blk=blk, exact=False)
        del mask, bias
        # A deeper store (d 1536, text-embedding-3-small's width): the query
        # tile no longer fits beside the ring and streams with the stages.
        deep = torch.randn((DEEP_N, 1536), generator=g, device=dev)
        dq = torch.randn((B, 1536), generator=g, device=dev).to(torch.bfloat16)
        k2_compare(f"bf16 store, d 1536 (B {B} x {DEEP_N:,} rows)", (dq, deep.to(torch.bfloat16), DEEP_N),
                   exact=False, reps=3)
        d8, ds8 = quantize_rows(deep)
        k2_compare("int8 store, bf16 queries, d 1536", (dq, d8, DEEP_N, ds8), exact=False)
        k2_compare("int8 store, int8 queries, d 1536", (quantize_rows(dq.float())[0], d8, DEEP_N, ds8), exact=True)
        del deep, dq, d8, ds8
        macs = float(B) * FLAT_N * 768
        say(f"  K2 work: {macs:.4e} MACs per batch -> bf16 {macs / (k2_main[1] * 1e-3) / 1e12:.2f} T FMA/s, "
            f"int8 {2 * macs / (k2_int8[1] * 1e-3) / 1e12:.2f} TOP/s [{GPU}]")
        # K2's bound: the store, the queries and the (B, 256) pool of scores
        # and ids moved once, against 2 * B * N * d operations.
        k2_bounds = {}
        for name, esize, rate, ms in (("bf16", 2, BF16_OPS_PER_S, k2_main[1]),
                                      ("int8", 1, INT8_OPS_PER_S, k2_int8[1]),
                                      ("f16", 2, BF16_OPS_PER_S, k2_f16[1])):
            need = FLAT_N * (768 * esize + (4 if esize == 1 else 0)) + B * 768 * esize + B * 256 * 8
            t_bytes, t_ops = need / HBM_BYTES_PER_S, 2 * macs / rate
            k2_bounds[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            say(f"  K2 {name}: bound {k2_bounds[name][0]:.3f} ms ({k2_bounds[name][1]}), K2 {ms:.3f} ms at "
                f"{100 * k2_bounds[name][0] / ms:.1f}% of it [{GPU}]")

    scan_fold.launches = 0  # count only the flat main path's launches from here
    with Phase("flat main path (flat_search_pallas)"):
        s_flat, i_flat = flat_search_pallas(xb16, fq, K)
        torch.cuda.synchronize()
        flat_first = scan_fold.launches
        flat_recall = recall_at(i_flat.tolist(), flat_gt)
        finite = (bool(torch.isfinite(s_flat).all()) and tuple(i_flat.shape) == (B, K)
                  and int(i_flat.min()) >= 0 and int(i_flat.max()) < FLAT_N)
        qps, batch_ms = chained_qps(lambda: flat_search_pallas(xb16, fq, K), B)
        plain_qps, plain_batch_ms = chained_qps(
            lambda: _pool_topk(scan_fold_reference(fq.to(torch.bfloat16), xb16, FLAT_N), None, K), B)
        _, i8 = flat_search_pallas(x8, fq, K, xb_scales=s8)
        int8_recall = recall_at(i8.tolist(), flat_gt)
        int8_qps, int8_ms = chained_qps(lambda: flat_search_pallas(x8, fq, K, xb_scales=s8), B)
        say(f"  bf16 store: recall@{K} vs exact f32 = {flat_recall!r} over 256 queries; finite {finite}; "
            f"K2 launches {flat_first}")
        say(f"  QPS {qps:,.1f} through K2 ({batch_ms:.2f} ms per {B}-query batch) vs {plain_qps:,.1f} "
            f"through the plain version ({plain_batch_ms:.2f} ms) [{GPU}]")
        say(f"  int8 store, int8 queries (no rescore): recall@{K} {int8_recall!r}; QPS {int8_qps:,.1f} "
            f"({int8_ms:.2f} ms per batch) [{GPU}]")
        assert finite, "flat search output is not finite, has the wrong shape or ids out of range"
        assert flat_recall >= 0.98, f"flat recall@10 {flat_recall} below 0.98"
        assert flat_first > 0, "flat_search_pallas did not launch K2"
        path_launches = scan_fold.launches
        say(f"  K2 launches of this path: {path_launches} (bf16 and int8: the first call, then 9 timed each)")

    with Phase("Flat store entry point (TorchVS)"):
        emb = corpus.cpu().numpy()
        qs_np = fq.cpu().numpy()
        index_dir = os.path.join(REPO, "build", "lotus_tpu_torch", "smoke_flat_index")
        flat_store_recall = None
        for kw in (dict(device_dtype="bfloat16", approx=True), dict(device_dtype="int8", scan="pallas")):
            shutil.rmtree(index_dir, ignore_errors=True)
            vs = TorchVS(index_type="flat", **kw)
            t0 = time.perf_counter()
            vs.index([], emb, index_dir)
            t_index = time.perf_counter() - t0
            before = scan_fold.launches
            t0 = time.perf_counter()
            out = vs(qs_np, K)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            vs(qs_np, K)
            t_warm = time.perf_counter() - t0
            used = scan_fold.launches - before
            store_recall = recall_at(out.indices, flat_gt)
            flat_store_recall = flat_store_recall or store_recall  # the bf16 store's, which phase 33b serves
            say(f"  TorchVS(index_type='flat', {', '.join(f'{k}={v!r}' for k, v in kw.items())}): "
                f"index() {t_index:.2f} s; {B}-query search {t_first:.2f} s first (loads the store), "
                f"{t_warm:.3f} s warm; recall@{K} {store_recall!r}; "
                f"K2 launches {used} [{GPU}]")
            assert used > 0, f"TorchVS {kw} did not reach K2"
        allowed = sorted(torch.randperm(FLAT_N, generator=torch.Generator().manual_seed(3))[:1000].tolist())
        before = scan_fold.launches
        sub_out = vs(qs_np[:4], K, ids=allowed)
        allowed_set = set(allowed)
        only_allowed = all(i in allowed_set or i == -1 for row in sub_out.indices for i in row)
        ids_launches = scan_fold.launches - before
        say(f"  search with ids: K2 launches {ids_launches}; only allowed ids {only_allowed}; stats {vs.stats}")
        shutil.rmtree(index_dir, ignore_errors=True)
        assert ids_launches == 0, "an ids-restricted search launched K2"
        assert only_allowed, "ids-restricted search returned an id outside ids"

        say(f"  K2 launches of the two stores: {scan_fold.launches - path_launches}")
    flat_launches = scan_fold.launches  # the flat main path's launches: search, QPS runs, store

    with Phase("flat stage breakdown"):
        flat_stage_breakdown(xb16, fq)
    del corpus, xb16, x8, s8, q8, fq, qb, vs
    torch.cuda.empty_cache()

    text_k1, text_k2, d1024_k2, k2_d1024 = text_phases(dev)
    serve_k1, serve_k2 = serving_phases(dev, c4["queries"], c4["gt"], c4["unspilled"]["recall"], flat_store_recall)

    peak_all = max(PEAK_SEEN, torch.cuda.max_memory_allocated())
    say(f"total {time.perf_counter() - t_all:.1f} s; peak {peak_all / 2**30:.2f} GiB [{GPU}]")
    f16_ivf, d770_ivf, f16_flat = q3.values()
    variants = [  # the variants later slices added, each timed at its phase-4, -13 or -27 shape
        ("ivf_probe (K1), f16 rows under f32 queries", "ivf_probe.cu", "pallas_ivf.py:235", f16_ivf,
         c4["new_variants"]["K1 f16"]),
        ("ivf_probe (K1), int8 dot at d 770", "ivf_probe.cu", "pallas_ivf.py:235", d770_ivf,
         c4["new_variants"]["K1 int8 d770"]),
        ("flat_scan (K2), f16 rows", "flat_scan.cu", "pallas_flat.py:42", f16_flat, (*k2_f16, *k2_bounds["f16"])),
        ("flat_scan (K2), f32 rows at d 1024 (RoBERTa-large store, phase 27)", "flat_scan.cu", "pallas_flat.py:42",
         d1024_k2, k2_d1024),
    ]
    main_err, main_ms, main_plain_ms, main_bound, main_by = c4["k1"]
    print(json.dumps({"kernels": [
        {
            "name": "ivf_probe (K1)",
            "route": "cuda",
            "source": "lotus_tpu_torch/csrc/ivf_probe.cu",
            "replaces": "lotus_tpu/ops/pallas_ivf.py:235",
            "launches": c4["k1_launches"] + c5_launches + spill_launches + f16_ivf + d770_ivf + text_k1 + serve_k1,
            "max_abs_err": main_err,
            "ms": main_ms,
            "plain_ms": main_plain_ms,
            "bound_ms": main_bound,
            "bound_by": main_by,
            "library_ms": None,  # no single PyTorch call gathers a list per chunk and folds 64 lanes
        },
        {
            "name": "flat_scan (K2)",
            "route": "cuda",
            "source": "lotus_tpu_torch/csrc/flat_scan.cu",
            "replaces": "lotus_tpu/ops/pallas_flat.py:42",
            "launches": c4["k2_launches"] + flat_launches + f16_flat + text_k2 + serve_k2,
            "max_abs_err": k2_main[0],
            "ms": k2_main[1],
            "plain_ms": k2_main[2],
            "bound_ms": k2_bounds["bf16"][0],
            "bound_by": k2_bounds["bf16"][1],
            "library_ms": None,  # no single PyTorch call folds a top-2 per lane
        },
        {
            "name": "pool_select (K3)",
            "route": "cuda",
            "source": "lotus_tpu_torch/csrc/pool_select.cu",
            "replaces": "lotus_tpu/ops/pallas_ivf.py:558",  # the XLA ops after the probe kernel; no Pallas kernel
            "launches": c4["k3_launches"] + spill_k3,
            "max_abs_err": c4["k3"][0],
            "ms": c4["k3"][1],
            "plain_ms": c4["k3"][2],
            "bound_ms": c4["k3"][3],
            "bound_by": c4["k3"][4],
            "library_ms": None,  # no single PyTorch call reassembles the pairs and selects
        },
        *({
            "name": name, "route": "cuda", "source": f"lotus_tpu_torch/csrc/{src}",
            "replaces": f"lotus_tpu/ops/{tpu}", "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        } for name, src, tpu, n_launch, (err, ms, plain_ms, bound, by) in variants),
    ]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--profile"]:
        sys.exit(profile_main(sys.argv[2]))
    if sys.argv[1:2] == ["--serve"]:
        sys.exit(serve_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
