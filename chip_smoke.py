#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llmlb_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

`--serve-only` runs the device, build and serve phases alone, and
`--tree DIR` imports the port from another checkout (an older commit
unpacked with `git archive`), so that two trees' serving times can be taken
in one call on one card:

    python3 chip_smoke.py --serve-only --tree chip_tree/parent

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi), TF32 off.
2. build   — compile llmlb_tpu_torch/csrc/*.cu with nvcc for sm_90a, and
             the gateway's native library (llmlb_tpu_torch/native/*.cpp,
             g++), held against its Python twins: the router core on a
             seeded 400-step trace, the SSE scanner on fuzzed chunk
             boundaries, the chain hash and the constant-time compare.
             Every gateway the script starts must run on it (its process
             maps the library).
3. kernels — hold each kernel against its plain PyTorch version on the card,
             in bf16 and fp32 at the serving shapes of Llama-3-8B and in fp32
             at debug-tiny's widths, show that the limit rejects the plain
             version with a fault a kernel could have (a page or key tile
             left out; for the int8 kernels the wrong page's scales or K's
             scales for V; for the dense kernels the next slot's row; for
             the tensor-core prefill and extend a causal diagonal shifted by
             one key and a GQA head's output taken from its neighbour; for
             lora_delta the next adapter's rows, the last rank column or
             one cluster rank's partial left out; for the split-K decodes a
             lost partial, the keys of the second split left out), hold the
             three split-K decodes (flash_decode, paged_flash_decode,
             paged_flash_decode_quant) at kv_lens on the split edges and
             bit for bit across batch (a row alone and in the batch of 8)
             and sweep (4096 and 256 keys), hold lora_delta's two modes
             (the fp32 delta; the delta added into a projection output in
             place, bit for bit y + delta.to(dtype)), time the three decode
             kernels at the serving shape too (8 rows near 160 keys, window
             256), with torch.profiler's device time beside the events,
             hold the tensor-core prefill and extend in bf16 at
             head_dim 64 with GQA groups of 7 and 8 (Qwen2.5-0.5B,
             TinyLlama) and an extend start inside a key tile, hold the
             tensor-core paged extends (bf16 and int8 pools) on their tile
             and page edges (starts inside a tile, a chunk crossing a page
             inside a query tile, 3 rows with padding query tiles, pages of
             16..128 with shuffled tables, head_dim 64 with G = 7 and 8),
             reject a tile read from the next page-table entry and a page's
             second 64-key half read from its first, and hold them bit for
             bit: a row alone and in a batch, the int8 extend against the
             bf16 extend over the dequantized pools, the paged bf16 extend
             against flash_extend over the dense row of the same keys; time
             kernel / plain / library call with CUDA events, the attention
             kernels and their SDPA calls also with the L2 cache cold.
             The speculative verify's shape: paged_flash_extend,
             paged_flash_extend_quant and flash_extend over 8 rows of
             K+1 = 5 queries from ragged starts (chunks of 1..5, three
             across a page edge; row 1's keys past its edge left out, and
             its page after the edge read from the next table entry, are
             rejected; the dense extend gives the paged one's bits), and
             lora_delta over the 40 rows with mixed adapters; each timed
             at 8 full chunks near ctx 160 and 2048 beside its bound.
4. unembed — the 8B vocab projection: bf16 operands, fp32 logits.
5. model   — the model's serving entry points on the card (kernels)
             against the CPU (plain path) at debug size: the paged ones with
             model-dtype, int8, adapter-pool (mixed lora_idx) and int8 +
             adapter params; the dense-slot ones with and without adapters;
             then the eight Mixtral entry points at debug-moe-tiny in both
             MoE regimes (2 x 16 tokens: capacity dispatch; 1 x 16: exact;
             verify and decode exact) with fp32, int8 weights and pools,
             and attention adapters.
   checkpoint — the seed-0 random Llama-3-8B weights generated on the card
             and written as a 4-shard bf16 HF checkpoint (index and a
             config.json rendered from the preset) under the build
             directory, after a check that the disk holds 16.06 GB; the
             bf16 and int8 serve phases serve from it, and it is deleted
             after them. The server's own `--checkpoint` path cannot run
             here: its HFTokenizer needs `transformers`, which this machine
             lacks; the engines come from Engine.from_checkpoint with a
             ByteTokenizer, and the CPU tests cover `--checkpoint`.
6. serve   — the port's HTTP server in-process, Llama-3-8B at full width and
             depth with random bf16 weights from seed 0, loaded from the
             checkpoint (Engine.from_checkpoint: the config read back must
             be the preset, every leaf the generated tensor bit for bit;
             the load's seconds, GB/s and peak host RSS growth are logged),
             its prefix cache on (the default). First the prefix block, on the empty cache: a
             donor of a 1024-token head (8 pages) and a 100-token tail, then
             8 requests of the same head and tails of their own together,
             32 greedy tokens each; the hit, miss, cached-token, insertion
             and copy counters take the values the traffic implies (paged:
             8 hits over the donor's pages, no copy; dense: a copy a hit),
             each hit runs one suffix dispatch (the extend kernel's
             launches rise by 32 a dispatch), a second identical hit gives
             the same ids, and every hit's first-token logits are within
             the bf16 limit of a cold prefill's on an engine with
             prefix_cache=False over the same weights, which also gives the
             8 requests' mean TTFT with the cache off. Then concurrent chat
             requests (streaming and not), a ~1500-token prompt that takes
             the chunked path, a repeat whose text must match (dense, where
             a repeated chat hits: a second hit's text must match the
             first's), then token-level determinism, TTFT (the 124-token
             prompt; the ~1500-token one, whose chunks run the extend
             kernel, twice as a miss with a head of its own, then twice as a
             hit on the first, whose ids must agree and whose logits must be
             within the bf16 limit of the miss's, while the miss's ids must
             equal the cache-off engine's) and decode rate on the same
             core. Then the overload block, on the same core and counted
             with the main path: a priority park (SLOTS rows of 48 tokens,
             one of priority 2, seeded, the others greedy of priority 1;
             a priority-0 request arrives after its 16th token and parks
             it): its tokens must be its solo run's, its first resumed
             logits the solo run's bit for bit (one decode step over each
             run's KV rows, which must be equal; on a difference the first
             layer and position named), the counters +1 park and +1
             resume; the reference design's gap (prompt + committed as one
             prefill) and the resume latency are logged, and in bf16 the
             latency of adoptions of 16 and 128 committed tokens.
             In bf16 then the port's gateway, counted with the main path:
             `python -m llmlb_tpu_torch.gateway.server serve` as a
             subprocess (its own data dir, a known admin password) in
             front of this phase's server, its cloud providers and Hugging
             Face API a local mock (no request leaves the machine): the
             registration detects the engine as `tpu` and syncs
             llama-3-8b; a greedy 64-token chat streamed and not,
             /v1/responses and /v1/messages streamed and not through the
             gateway carry the direct path's ids, text and usage
             (/v1/messages: usage mapped, stop_reason max_tokens, one
             well-formed event stream, and its own launches of
             flash_prefill and paged_flash_decode); the same server,
             registered a second time under http://localhost:PORT, has a
             chat stream and then a /v1/messages stream cut by the
             `engine_abort` fault rule half-way and the gateway resumes
             each on the first registration to the uncut text and ids
             (two resumes in /metrics); an `openai:` and an `anthropic:`
             chat reach the mock and /api/metrics/cloud counts them; a
             model registered from the mock's repo serves its manifest;
             an invitation registers a user; the second registration is
             renamed and deleted; the audit log's chain verifies; the
             TTFT of 1-token streams through the gateway (the audit
             middleware on its path) against direct (median of 5). The
             dashboard, all through that gateway: /ws/dashboard, opened
             with the admin JWT before the first registration by a
             standard-library client of this script (its
             Sec-WebSocket-Accept checked, a masked close at the end),
             carries both EndpointRegistered, the EndpointRemoved, a
             TelemetryUpdated with the card's memory, MetricsUpdated,
             TpsUpdated and one TraceCompleted for each /v1/* request the
             gateway counted; a TPS benchmark (POST /api/benchmarks/tps,
             16 requests of 32 tokens at concurrency 4) completes with 16
             successes on the registration, launching flash_prefill and
             paged_flash_decode; /api/dashboard/overview counts the
             requests and the one online endpoint, model-tps has the
             chat key, /dashboard and its assets are the port's bytes,
             /api/dashboard/logs/lb tails the gateway's own log (its
             LLMLB_LOG_DIR in the block's data directory), and /metrics
             shows no dropped event. Then the multi-worker sub-block:
             `serve --workers 2` on a free fixed port (two forked workers
             on one SO_REUSEPORT port, gossiping over unix sockets in the
             sub-block's data directory), the engine registered through
             one worker until both list it online with llama-3-8b; six
             greedy 64-token chats of the block's content, three streamed
             and three not, each on a fresh connection, carry the direct
             path's ids (more if one worker served none, until each served
             one); the merged /metrics has request series under
             worker="0" and worker="1"; 12 lookups of one chat's trace on
             fresh connections all answer 200; both workers sent and
             received gossip and refused none; SIGTERM to the supervisor
             exits 0 and no worker outlives it (a `multi_worker` line).
             Then the update sub-block (`_update_block`): a gateway on a
             free fixed port P with updates from a local release stub
             (v9.9.9, a 4 MiB asset) and the tray on; `status` names it
             and a second `serve --port P` is refused by the instance
             lock; a greedy 64-token chat stream through it (paced on the
             engine so that it is live) runs through an update check, the
             tray's offer and a normal apply (/api/system `draining`, a
             new chat 503 with Retry-After) to the direct path's ids,
             text and usage; the gateway exits 0, app.bin swapped with
             its .bak and the marker, the lock gone; restarted on P with
             LLMLB_UVLOOP=1, its watch clears the marker; `assistant
             curl` chats through it as a direct chat does; `stop` ends
             it (an `update` line).
             Then speculative decoding, per request, on the same core and
             counted with the main path: 1 row, then 8, of 64 greedy ids
             with speculation off, on (the prompt-lookup drafter), under a
             stub drafter proposing the spec-off stream's next ids
             ("accept") and one proposing other ids ("reject"): the
             counters each run added (accept: every draft accepted where
             the streams agree; reject: none), the pool's free pages back
             at their baseline, and the parting rule: over scratch KV the
             spec-off streams' decode-path logits and full verify chunks'
             logits are recomputed, and every spec-on stream that parts
             from spec off must part at a position whose spec-off top-2
             margin is below the largest |verify − decode| logit
             difference; a speculating row parked after 16 ids resumes
             with its drafter (the same stub) under the same rule; steady
             tok/s of each run and each verify key's replay ms. The int8,
             LoRA and dense phases run one such request (32 ids, the
             accept stub; LoRA with adapter acme) on their verify key
             under the same rule, dense also a constrained pair on its
             "mask" key (fused decode is off there).
             Then KV shipping (bf16 and int8), the serving core's side
             counted with the main path: a second EngineCore over the same
             params tensors (its own KV pool) behind a server of its own;
             an armed stream on the serving core is parked after 16
             committed ids by POST /v1/kv/export {"park": true}, and
             /v1/resume with its kv_pages on the second server must give
             the uninterrupted run's ids with no prefill dispatch and no
             prefill or extend launch there, the adopted row's KV rows at
             the resume point the uninterrupted run's bit for bit (bf16:
             also after 128); the export, gather, land, bytes and the
             first new token's latency beside the replay's (the same resume
             without pages) are logged. The second engine's launches are
             taken out of the counts and logged on a line of their own.
             In bf16 then the rebalance sub-block: the port's gateway in
             this process in front of both servers, the second registered
             first and warmed (an SLO miss: goodput 0), then the serving
             one; a greedy 64-token chat stream through it starts on the
             serving core and, after 16 ids, the health checker probes
             and the planner ticks twice (bands 0.1 / 0.05): one hotspot
             directive, and the pump parks the stream, ships its pages
             and splices the second engine's continuation; the client's
             text and usage are the direct path's, the adopter's
             committed plus new ids the direct ids with no prefill
             dispatch and no prefill or extend launch there, /metrics
             counts hotspot/success 1 and no resume; then the second
             engine drains and a stream directed to it is refused and
             stays on its origin with the direct ids.
             After the counts, the offload tier on a small engine (6
             pages, 2 GiB of host budget): a prefix evicted under page
             pressure and asked for again restores from host RAM, its
             hit's first-token logits equal to the live hit's bit for bit,
             and the counters the traffic's.
             bf16, after the counts: observability on the serving core
             over its server: 8 rows decode 1100 greedy ids while
             /api/health is polled; their /api/steps decode records'
             phases sum to total_s, replays count one dispatch, each
             replayed record's device ms a step is within 10% of
             profile_step's graph row at the same shape (run here), and
             the perf block read with a window of these bursts only has
             mfu and hbm_bw_utilization in (0, 1]; the gpu block equals
             torch's total_memory and memory_allocated; a request's
             timeline runs admitted -> queued -> prefill_chunk -> ... ->
             finished in seq order; /metrics parses as Prometheus text,
             every family documented with the reference's; a speculating
             request writes verify records with a draft phase; 32 greedy
             ids are equal with the flight recorder on and off; POST
             /api/profile captures 0.5 s of 8-row decode, its zip's Chrome
             trace is searched for the paged decode's split and combine
             kernels inside the graph replays (their absence is printed
             as a finding); the dispatch check
             (engine/dispatch_check.py) passes on the card.
             bf16, after the counts: structured outputs, on an EngineCore
             of its own over the serving core's params (8 paged slots, the
             ByteTokenizer's EOS, the port's Engine and server; its
             launches and those of an eager core beside it logged apart):
             8 greedy rows together (4 of a bounded 85-state json_schema, 2
             of a 38-state one: 124 of the 64 MiB table's 130 rows at
             vocab 128256; 2 free rows): every constrained text parses and
             is accepted by the port's DFA with finish "stop" and no
             violation, every burst with a constrained row runs the
             grammar graph key (one eager burst, then replays), no
             fallback, the free rows give their solo tokens; 2 seeded
             constrained rows give an eager core's tokens; json_object
             (1734 states) is refused a table row, its bursts take the
             host-mask key (k = 1), the fallback counter rises, its text is
             a live prefix of its grammar, and the first 6 rows beside it
             give their fused tokens; a constrained row parked by a
             priority-0 arrival and one parked for a migration (its pages
             landed on the eager core through adopt_stream) give their
             fused tokens; over HTTP a streamed json_schema chat parses, a
             forced tool call streams the tool_calls deltas with
             finish_reason "tool_calls", /v1/models lists
             structured_outputs. Logged: compile and registration ms,
             table rows and bytes, the grammar key's capture s and nodes,
             the warm TTFT and decode rate alone (constrained, free,
             fallback).
             bf16, after the counts: each verify key's replay against its
             eager step (two cores over the same weights, 8 slots, EOS
             256, one capturing and one eager; the accept stub over the
             eager core's spec-off streams: 4 greedy free rows, 4 seeded,
             2 of a resident schema on the grammar key, the same 2 with
             fused decode off on the mask key): the replays give the
             eager steps' tokens, the constrained ids walk the DFA; and
             the prefill chunk budget (two cores of 9 slots, capacity
             2048, budget 128 and 0, warmed by a prompt of the same
             length): the 1503-token prompt beside 8 decoding rows of
             560-token prompts, the largest gap between a decoder's fetches while it
             prefills, its TTFT, and with the budget its prefix hit on the
             idle core, whose first-token logits must equal the cold
             run's bit for bit (C3).
             Paged: page exhaustion on an engine of 2 slots and 4 pages,
             two rows of 60 tokens: both their solo tokens and finish
             reasons after a park. /v1/resume over HTTP with the ids of an
             armed stream cut after 16: the uninterrupted 32 ids, each in a
             replay frame. bf16 only: /v1/completions and /v1/responses
             carry the chat's greedy ids; /v1/embeddings gives finite unit
             vectors, each the same bits alone as in a batch of 8. Last in
             each phase, on a server of its own: POST /api/drain (grace 0)
             with an armed stream decoding: its row parks and its socket
             closes without [DONE], a new chat gets 503 with Retry-After,
             /api/health says draining. The core's decode bursts are CUDA graph
             replays, one graph per (window bucket, seeded) key after one
             eager warm-up burst each: every other burst replays, and the
             capture time, the graphs' pool bytes, nodes and port kernels
             per replay are logged. Then an engine with
             decode_graphs=False on the same weights and card: greedy and
             seeded rows (with adapters, the mixed batch) give the same
             tokens as the replays, two identical unseeded requests at
             temperature 1 draw different tokens on the graph core
             whenever they do on the eager one, and its single-stream
             decode rate is logged beside the graph core's. A capture or
             replay failure fails the phase: there is no eager fallback.
             Each kernel of the path launches over this phase (a replay
             counts the launches its capture recorded); the int8
             kernels do not. Then batch_invariance (C1): on the same
             weights, the timed prompt's prefill logits alone and as row 0
             of groups of 2, 4 and 8 other prompts of its bucket, through
             the entry point the scheduler's group prefill calls, equal bit
             for bit (on a difference the first op whose row 0 differs is
             named); this runs after each serve phase below too.
7. serve int8 — the same, graphs and all, with quantize="all": the same
             seed-0 weights, streamed from the checkpoint and quantized
             layer by layer on the card (every int8 leaf and scale must
             equal quantize_params of a bf16 load of the checkpoint), int8
             KV pages, the 16-id migration and the offload block too; flash_prefill and the two
             int8 kernels launch, the bf16 paged kernels do not, and the
             greedy tokens that agree with the bf16 run are counted.
8. serve lora — the paged bf16 engine with a temporary adapter directory
             (two adapters written by the port's save_adapter): HTTP traffic
             mixing the base model, the `lora` field and `model:adapter`
             names; the adapter-free timed prompt's greedy ids equal the
             bf16 run's, an adapter's differ, a mixed batch's rows equal
             their solo runs for 32 of 32 tokens, lora_delta and the paged
             kernels launch, adapter refcounts drain to {}; batch
             invariance with mixed adapters.
9. serve dense — the bf16 traffic with kv_layout="dense": flash_prefill,
             flash_decode and flash_extend launch, no paged kernel does, and
             the timed prompt's 64 greedy tokens equal the paged bf16 run's
             (else the first op whose row 0 differs between the two
             layouts' entry points is named); how many of the long prompt's
             16 greedy tokens agree with the paged run's is reported. After
             the counts, the dense layout's constrained path (fused decode
             off, the reference's dense default: every constrained burst
             on the host-mask key) on a 2-slot dense core of its own: the
             structured block's first two constrained prompts give its
             fused ids.
10. serve mixtral — Mixtral-8x7B at full width and depth (32 layers, 8
             experts, top-2, vocab 32000) with int8 experts and
             projections (quantize="weights"; bf16 would be 93 GB), random
             from seed 0 and filled as int8 a matrix at a time, bf16 KV
             pages, engine defaults, two attention adapters, over HTTP: 4
             chats (base, `lora`, `model:adapter`), /v1/models without
             `embeddings`, /v1/embeddings answering 400; the 124-token
             prompt's TTFT and steady one-stream decode (ids after the
             first fetch) twice with equal ids, an adapter request whose
             ids differ; the 1503-token prompt's TTFT as a miss, then a
             cold run and its prefix hit with the dropped (token, choice)
             pairs counted by the plain routing on each dispatch's router
             logits (without drops the hit's logits must be within the
             bf16 limit of the cold run's); 8 x 64 tok/s; one 32-id
             speculative request under the accept stub against spec off
             (the parting rule); decode batch invariance (exact MoE: row
             0's decode logits equal bit for bit in the batch, with the
             others idle and with their tokens and adapters rotated);
             flash_prefill, paged_flash_decode, paged_flash_extend and
             lora_delta launch, no other kernel; the graphs' pools; graph
             = eager for 4 rows submitted together on the serving core and
             on a decode_graphs=False core. Logged: weights, KV and peak
             GiB, the init's seconds, each block's seconds.
11. mixtral bf16 — 8 layers of Mixtral-8x7B at full width in bf16 with
             int8 KV pools: a prefill group of 4 x 512 and an extend of 4 x
             128 (capacity dispatch, drops counted), then a decode step;
             every capacity dispatch bit for bit the one-hot plain
             version's on the same inputs (the card runs index copies and
             gathers), every flash_prefill, paged_flash_extend_quant and
             paged_flash_decode_quant call within the bf16 limit of its
             plain version on the same inputs.
12. multimodal — the three services of the port's server, random from seed
             0, in fp32 as the reference serves them (no Pallas kernel lies
             on this path: convolutions, products and FFTs are PyTorch
             calls). (a) Whisper-large-v3 at full width and depth (its
             published config.json through WhisperConfig.from_hf_config:
             d_model 1280, 32 + 32 layers, 20 heads, 128 mels, vocab 51866,
             1.55 B parameters): a 10 s chirp through
             transcribe_wav_bytes with max_tokens 64 (mel, encoder and
             per-token decoder ms, wall, real-time factor, weights and peak
             GiB logged); the greedy ids must be the argmax of one
             teacher-forced decoder_logits pass over them (the smallest
             top-2 margin logged); at full width and 2 layers the card's
             mel (over the chirp and three seeded tone mixes), encoder
             states and first-step logits within stated fp32 limits of the
             CPU's. (a), (c) and (d) start from PyTorch's own TF32
             switches (cuDNN's on), as a server process does, so the
             models' own fp32 guard is what the checks cover; the mel and
             the encoder states are also read under a TF32 control. (b) TTS at TtsConfig(): a 200-character
             text (mel ms, Griffin-Lim ms, seconds of audio a second); two
             card runs give the same WAV bytes; the mel and the vocoder's
             audio of the same mel within a stated limit of the CPU's. (c)
             DDIM at DiffusionConfig(), 20 steps with guidance: n = 1 and
             n = 4 (seconds an image); the starting noise within
             _threefry.normal's bound of the CPU's draw (the share of
             draws bit for bit logged); one UNet call on the same inputs
             within 1e-4 of its largest |eps| of the CPU's; n = 1 images
             at four seeds within a stated limit of the CPU's (the sampler
             amplifies a UNet's fp32 differences); the UNet call and one
             image also read under TF32 convolutions, the control. (d) Over HTTP: the port's server
             in-process with the three services beside the bf16
             Llama-3-8B serving core: /v1/models lists the three with
             their capabilities, speech answers a WAV, a multipart
             transcription JSON, images two PNGs; a server without the
             services answers 404; cuDNN's TF32, on when the requests
             began, is off after them. Then the port's gateway (a
             subprocess) in front of that server: the registration syncs
             its four models with their capabilities, speech through it
             gives the direct WAV bytes, the 2 s chirp's transcription the
             direct text, images two PNGs (compared by bytes with the
             direct ones where two direct calls repeat; the service draws
             a new seed per request, so they do not).
13. multi-device — one world of two ranks spawned from this script
             (`--md-rank`), joined through the port's LLMLB_COORDINATOR /
             LLMLB_NUM_HOSTS / LLMLB_HOST_ID: with one card both share it
             over gloo (NCCL refuses two ranks on one device; every
             collective then passes through host memory), with two or
             more one rank a card over NCCL. Rank 0 serves HTTP through
             the port's server, rank 1 is a follower. Six sub-phases, each
             a lockstep engine (4 slots, capacity 2048, eager bursts,
             greedy, random weights of seed 0): tp=2 over Llama-3-8B bf16
             paged at full width and MD_CUT_LAYERS of its 32 layers (16 q
             / 4 KV heads, ffn 7168 a rank), three chats over HTTP, then the three chats and the
             1503-token prompt (chunked) on the core; sp=2 over Llama-3-8B
             (dp and lora too at MD_CUT_LAYERS), the 1503-token prompt in one ring pass (CP bucket 2048), its
             KV read back from the pages; ep=2 over Mixtral at full width
             and MIX_BF16_LAYERS layers (4 of 8 experts a rank), a chat
             and a ~600-token prompt (capacity dispatch in prefill, exact
             MoE in decode); dp=2 over Llama-3-8B (each rank the whole
             model and its dp group's slots, the page pool replicated by
             the dp exchange), the tp sub-phase's traffic, then a prefix
             hit across dp groups (a fresh 1503-token prompt cold in
             group 0, then again in group 1, reading group 0's pages:
             ids and first logits bit for bit its cold run), the long
             prompt's pages on the rank that did not write them equal to
             the writer's bit for bit, and whether the ids, logits and KV
             are one card's bits (logged); moe_dp: dp=2 over Mixtral at
             full width and MIX_BF16_LAYERS layers (each rank the whole
             model, ~25 GB), MD_MOE_ROWS ~200-token prompts queued before
             the loop starts: one prefill group over both dp groups in the
             capacity regime (4 x 256 tokens), whose MoE layers gather the
             groups' hidden rows over dp and run the whole batch's
             dispatch on every rank; then the ep sub-phase's ~600-token
             prompt in a slot of each dp group and its chat (chunks: #3
             on both ranks); the group's capacity drops a layer
             (`_Drops`) more than zero, alike on both ranks and one card's
             for the same batch (the ep sub-phase's one-card engine serves
             the group queued at once after its own prompts, and the fp32
             computation prefills the group in one dispatch), and whether
             ids and logits are one card's bits (logged); lora: tp=2 over
             Llama-3-8B
             with the LoRA serve phase's two adapters (the pools sharded
             like their weights), a chat with an adapter over HTTP, then
             an adapter-free, an acme and a beta row, beta's loaded cold
             while the others decode; every rank the same pool rows, the
             adapter-free row the tp sub-phase's bit for bit. Before the
             ranks start, #1-#3 are held against their plain versions at
             a tp=2 rank's shapes, #6 at each target's tp=2 rank shapes,
             and a one-card engine of each model (and a one-card LoRA
             engine) serves the same prompts (first logits, 16 greedy
             ids, the one-card top-2 margins along each stream, the fp32
             computation of the same weights) and is freed. Every rank's
             ids must equal the leader's; the
             leader's greedy ids one card's up to the first position where
             the one-card margin is below the measured logit difference;
             its first logits (and the ring's KV, layer 0 also elementwise
             within the bf16 limit) as accurate as one card's: at most
             MD_ACCURACY x one card's RMS-relative distance from the fp32
             computation (the elementwise reading against one card's is
             logged); each kernel of a sub-phase's path launched on every
             rank, the launches added to the `kernels` line; the sub-phase
             seconds and the collectives' calls, bytes and host seconds
             logged. Then two sub-phases of the leader's actions (A18c),
             tp=2 over Llama-3-8B at full width and MD_CUT_LAYERS of its
             32 layers: leader (an offload tier of 512 MiB),
             over HTTP a streamed chat, its /v1/resume with 16 committed
             ids (the uninterrupted ids bit for bit), a migration of a
             ~600-token row (POST /v1/kv/export {"park": true}, then
             /v1/resume with its kv_pages landed: the uninterrupted ids,
             and each rank's landed pages its own pages at the park by
             sha256), a priority park spilled into the tier and restored
             from it (its solo run's ids; the tier's info alike on both
             ranks), /v1/embeddings of two inputs (as accurate as one
             card's, a one-card engine at the same depth, against the fp32
             computation, #1 launched on both ranks), and last /api/drain (both ranks park the same rows,
             the leader serves their exports); split (--role split, 2
             prefill and 2 decode slots): two chats decoding when the
             1503-token prompt arrives, every rank's ids the leader's and
             the leader sub-phase's combined engine's, no prefill dispatch
             on any rank's decode loop. `--multi-device-only` runs the
             device, build and this phase alone.

`--ids-only` serves the bf16 serve phase's timed prompts on a one-card
engine of the serve phases' configuration (random weights of seed 0,
graphs on) and prints their greedy ids as a JSON line: with `--tree` it
holds a one-rank engine of this tree to another tree's bit for bit.

The second-to-last line is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import queue
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Llama-3-8B serving shapes at the engine defaults.
H, KV, D = 32, 8, 128
SLOTS, CAPACITY, PAGE = 8, 4096, 128
# the decode steps of the serve phases: 8 rows near 160 keys, window 256
SERVE_LENS, SERVE_WINDOW = [156, 157, 158, 159, 160, 161, 162, 163], 256
# bf16: inputs, probabilities and outputs are rounded to bf16 (8 significant
# bits), and the kernel's online softmax rescales its sums in another order
# than the plain version's two passes. Allow two bf16 steps of the element and
# of its (query, head) row's RMS: |err| <= 2^-6 (|plain| + rms(plain row)).
# Attention outputs shrink with the context (RMS ~ sqrt(e / keys) for unit
# normal q, k, v: 0.026 at 4096 keys), so the limit follows each row's scale;
# phase_kernels shows that one dropped page or key tile fails it.
BF16_REL = 2.0**-6
FP32_ATOL = 1e-4  # fp32: the same math summed in another order
# lora_delta: an fp32 result of exact products (bf16 x bf16 fits fp32) summed
# in another order than the plain version's fp32 einsum: relative sum-order
# error ~ sqrt(IN) * 2^-24 ~ 1e-5 at IN 14336. Allow 1e-4 of the element and
# of its row's RMS; one rank column of 16 left out moves ~25% of the RMS.
LORA_REL = 1e-4
# fp32 logits of the 8B vocab projection: fp32 sums of 4096 exact bf16
# products in another order than the fp32 product's (logits ~ N(0, 1))
UNEMBED_ATOL = 1e-3
# kernel names torch.profiler reports for each split-K decode's launches
PAGED_DECODE_MARKS = ("paged_decode_kernel", "decode_combine_kernel")
QUANT_DECODE_MARKS = ("paged_decode_quant_kernel", "decode_combine_kernel")
DENSE_DECODE_MARKS = ("flash_decode_kernel", "decode_combine_kernel")
# ... and for the tensor-core paged extends (bf16)
PAGED_EXTEND_MARKS = ("paged_extend_tc_kernel",)
QUANT_EXTEND_MARKS = ("paged_extend_quant_tc_kernel",)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call (CUDA events on the current stream)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean device time of fn() with the L2 cache cold: before each call a
    128 MB buffer is read and written (outside the timed region), so fn()
    finds none of its inputs in the 50 MB L2, as a serving step whose
    other layers ran in between would. CUDA events around each call."""
    import torch

    flush = torch.zeros(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def profiled_ms(fn, reps: int, marks: tuple[str, ...]) -> float:
    """Device time per fn() call of the kernels whose names hold one of
    `marks`, as torch.profiler saw them (no host time between launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(m in e.name for m in marks))
    return us / reps / 1e3


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "kind": kind, "count": torch.cuda.device_count()}


def phase_build() -> None:
    from llmlb_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {build.BUILD_INFO.get('seconds', 0.0):.2f} s, "
        f"cached={build.BUILD_INFO.get('cached')})")
    for name, report in (build.BUILD_INFO.get("ptxas") or {}).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    _native_checks()


def _sse_fuzz_stream(rng) -> bytes:
    """A random SSE stream: content, usage (both dialects) and Responses
    deltas, three separators, comments and empty data lines, [DONE] or
    not (the reference's parity fuzz, tests/test_native.py)."""
    raw = b""
    for i in range(rng.randrange(1, 12)):
        roll = rng.random()
        if roll < 0.5:
            frame = {"choices": [{"delta": {
                "content": f"tok{i}" * rng.randrange(1, 4)}}]}
        elif roll < 0.65:
            frame = {"choices": [], "usage": {
                "prompt_tokens": rng.randrange(0, 500),
                "completion_tokens": rng.randrange(0, 500)}}
        elif roll < 0.75:
            frame = {"type": "response.output_text.delta",
                     "delta": "x" * rng.randrange(1, 30)}
        elif roll < 0.85:
            frame = {"choices": [{"delta": {}}], "usage": {
                "input_tokens": rng.randrange(0, 99),
                "output_tokens": rng.randrange(0, 99)}}
        else:
            frame = {"choices": [{"delta": {"content": 'q"u\\o✓te'}}]}
        raw += (rng.choice([b"data: ", b"data:", b"data:  "])
                + json.dumps(frame).encode()
                + rng.choice([b"\n\n", b"\r\n\r\n", b"\n"]))
        if rng.random() < 0.2:
            raw += rng.choice([b": keepalive\n", b"event: ping\n", b"\n",
                               b"data:\n"])
    if rng.random() < 0.8:
        raw += b"data: [DONE]\n\n"
    return raw


def _native_checks() -> None:
    """Build the gateway's native library from this checkout's sources
    (g++, into llmlb_tpu_torch/_build/) and hold it against its Python
    twins: the router core on the reference's seeded trace (400 steps of
    TPS samples, admissions under a cap of 3, lease ends and clears; every
    selection, active count and EMA), the SSE scanner on 50 streams split
    at random boundaries, the chain hash against hashlib and the
    constant-time compare against hmac."""
    import hashlib
    import hmac
    import random

    from llmlb_tpu_torch import native
    from llmlb_tpu_torch.gateway import balancer, config, types
    from llmlb_tpu_torch.gateway.token_accounting import (
        StreamingTokenAccumulator,
    )

    t0 = time.perf_counter()
    if not native.ensure_native_built() or native.load_native() is None:
        raise AssertionError(f"the native library did not build: "
                             f"{native.BUILD_INFO}")
    info = native.BUILD_INFO
    log(f"native build: {info.get('seconds', 0.0):.2f} s (g++ "
        f"{' '.join(native.CXXFLAGS)}, cached={info.get('cached')}), "
        f"{Path(info['path']).name}")
    qc = config.QueueConfig(max_active_per_endpoint=3)
    nat = balancer.LoadManager(qc, use_native=True)
    py = balancer.LoadManager(qc, use_native=False)
    if nat._rc is None:
        raise AssertionError("the native router core did not load")
    eps = [types.Endpoint(name=f"e{i}", base_url=f"http://e{i}:1",
                          id=f"ep{i}",
                          endpoint_type=types.EndpointType.OPENAI_COMPATIBLE,
                          status=types.EndpointStatus.ONLINE)
           for i in range(4)]
    chat = types.TpsApiKind.CHAT
    rng, leases, admits = random.Random(7), [], 0
    for step in range(400):
        op = rng.random()
        if op < 0.35:
            eid, model = f"ep{rng.randrange(4)}", rng.choice(["m0", "m1"])
            tokens, dur = rng.randrange(1, 500), rng.uniform(0.01, 3.0)
            for lm in (nat, py):
                lm.update_tps(eid, model, chat, tokens, dur)
        elif op < 0.7:
            model = rng.choice(["m0", "m1"])
            a, b = (lm.try_admit(eps, model, chat) for lm in (nat, py))
            if (a and a[0].id) != (b and b[0].id):
                raise AssertionError(f"router core: step {step} admitted "
                                     f"{a and a[0].id} against {b and b[0].id}")
            if a is not None:
                admits += 1
                leases.append((a[1], b[1]))
        elif op < 0.9:
            if leases:
                for lease in leases.pop(rng.randrange(len(leases))):
                    lease.complete()
        else:
            eid = f"ep{rng.randrange(4)}"
            for lm in (nat, py):
                lm.clear_tps_for_endpoint(eid)
        for ep in eps:
            got = [(lm.active_count(ep.id),
                    [lm.get_tps(ep.id, m, chat) for m in ("m0", "m1")])
                   for lm in (nat, py)]
            same = got[0][0] == got[1][0] and all(
                (x is None) == (y is None) and (x is None or abs(x - y)
                                                <= 1e-12 * abs(y))
                for x, y in zip(got[0][1], got[1][1]))
            if not same:
                raise AssertionError(f"router core: step {step} {ep.id} "
                                     f"{got[0]} against {got[1]}")
    frames = 0
    rng = random.Random(0xC0FFEE)
    for case in range(50):
        stream = _sse_fuzz_stream(rng)
        scanner, acc = native.NativeSseScanner(), StreamingTokenAccumulator()
        acc._native, acc._raw = None, None  # the Python splitter
        pos = 0
        while pos < len(stream):
            step = rng.randrange(1, 24)
            scanner.feed(stream[pos:pos + step])
            acc._feed_python(stream[pos:pos + step])
            pos += step
        usage_ok = (acc._usage in (None, (0, 0))
                    or scanner.usage() == acc._usage)
        if scanner.frames != acc._chunks_seen or not usage_ok:
            raise AssertionError(f"SSE scanner: case {case}: "
                                 f"{scanner.frames} frames, usage "
                                 f"{scanner.usage()} against "
                                 f"{acc._chunks_seen}, {acc._usage}")
        frames += scanner.frames
    prev = "0" * 64
    for entries in ([b'["a",1]', "unicode-é".encode()], [],
                    [b"x" * 100_000, b"y"]):
        want = hashlib.sha256(prev.encode() + b"".join(entries)).hexdigest()
        if native.native_chain_hash(prev, entries) != want:
            raise AssertionError("chain hash differs from hashlib")
    for a, b in ((b"", b""), (b"sk_" + b"x" * 43, b"sk_" + b"x" * 43),
                 (b"sk_" + b"x" * 43, b"sk_" + b"x" * 42 + b"y"),
                 (b"\x00\x01", b"\x00\x02"), (b"abc", b"abcd")):
        if native.native_ct_equal(a, b) is not hmac.compare_digest(a, b):
            raise AssertionError(f"ct_equal({a!r}, {b!r})")
    log(f"native core: the router core's 400-step trace ({admits} "
        f"admissions) equal to the Python core's, the SSE scanner's "
        f"{frames} frames over 50 fuzzed streams the Python splitter's, the "
        f"chain hash hashlib's, ct_equal hmac's; "
        f"{time.perf_counter() - t0:.2f} s with the build")


def _pool(torch, gen, pages, dtype, kv=KV, d=D, page=PAGE):
    shape = (pages, page, kv, d)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return k, v


def _pairs(got, want, rows):
    """(kernel, plain) pairs over the defined rows: all rows, or the first
    rows[b] of batch row b."""
    if rows is None:
        return [(got.float(), want.float())]
    return [(got[b, :n].float(), want[b, :n].float())
            for b, n in enumerate(rows) if n > 0]


def _within(got, want, atol, rel, rows) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within
    atol + rel * (|want| + rms of want's last-dim row)). NaN fails."""
    err, ok = 0.0, True
    for g, w in _pairs(got, want, rows):
        rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= atol + rel * (w.abs() + rms)).all())
    return err, ok


def _check(name, got, want, *, atol=0.0, rel=0.0, rows=None) -> float:
    """Max |kernel - plain| over the defined rows; raises if any element is
    outside the limit of `_within`."""
    err, ok = _within(got, want, atol, rel, rows)
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:g}, rel {rel:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err:.3e})")
    return err


def _must_fail(name, mutant, want, *, rel, rows=None) -> None:
    """The bf16 limit must reject `mutant`, the plain version with part of
    the work left out, as it would reject a kernel that skipped it."""
    err, ok = _within(mutant, want, 0.0, rel, rows)
    log(f"  {name}: max_abs_err {err:.3e} -> "
        f"{'REJECTED' if not ok else 'ACCEPTED (limit too loose)'}")
    if ok:
        raise AssertionError(f"{name}: the bf16 limit accepts a mutant")


def _plain(torch, q, k_cache, v_cache, mask, drop=None):
    """masked_attention with keys [lo, hi) of batch rows `rows` hidden, or
    the unchanged mask for drop=None; q [B, T, H, D], mask [B, T, S]."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    if drop is not None:
        lo, hi, rows = drop
        cols = torch.arange(mask.shape[-1], device=mask.device)
        hide = (cols >= lo) & (cols < hi)
        sel = torch.zeros(mask.shape[0], dtype=torch.bool, device=mask.device)
        sel[list(rows)] = True
        mask = mask & ~(hide[None, None, :] & sel[:, None, None])
    return ca.masked_attention(q, k_cache, v_cache, mask)


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- flash_prefill: a 512-token bucket, 8 ragged prompts -----------------
    b, t = SLOTS, 512
    q, k, v = randn((b, t, H, D), bf16), randn((b, t, KV, D), bf16), \
        randn((b, t, KV, D), bf16)
    plens_host = [512, 500, 384, 256, 200, 129, 64, 1]
    plens = torch.tensor(plens_host, dtype=torch.int32, device="cuda")
    got = ca.flash_prefill(q, k, v, plens)
    want = ca.flash_prefill_reference(q, k, v, plens)
    torch.cuda.synchronize()
    err = _check("flash_prefill bf16 [8,512,32,128]", got, want, rel=BF16_REL,
                 rows=plens_host)
    pos = torch.arange(t, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < plens[:, None, None]))
    if not torch.equal(_plain(torch, q, k, v, mask), want):
        raise AssertionError("flash_prefill: the mutants' mask is not the "
                             "plain version's")
    _must_fail("flash_prefill bf16, key tile [64, 128) of row 0 dropped",
               _plain(torch, q, k, v, mask, (64, 128, [0])), want,
               rel=BF16_REL, rows=plens_host)
    _tc_mutants(torch, "flash_prefill", q, k, v,
                (pos[None, :, None] + 1 >= pos[None, None, :])
                & (pos[None, None, :] < plens[:, None, None]), want, plens_host)
    # the yardstick call takes SDPA's [B, H, T, D] layout with the KV heads
    # repeated for the group, prepared outside the timed region
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              attn_mask=mask[:, None])

    # the function's work: the defined rows read q, k, v and write out once
    visible = sum(n * (n + 1) // 2 for n in plens_host)
    nbytes = (2 * H + 2 * KV) * D * 2 * sum(plens_host) + b * 4
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="flash_prefill", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_prefill.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:494",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_prefill(q, k, v, plens), 20),
        ms_cold=cuda_ms_cold(lambda: ca.flash_prefill(q, k, v, plens), 20),
        plain_ms=cuda_ms(lambda: ca.flash_prefill_reference(q, k, v, plens), 3),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(sdpa, 10),
        library_ms_cold=cuda_ms_cold(sdpa, 10)))
    del q, k, v, qt, kt, vt, got, want, mask
    _tc_head_dim_64(torch, gen)

    # -- paged_flash_decode: 8 rows up to 4096 tokens through block tables ---
    ppn = CAPACITY // PAGE
    pages_total = SLOTS * ppn + 1
    kp, vp = _pool(torch, gen, pages_total, bf16)
    perm = torch.randperm(pages_total - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(SLOTS, ppn).to(torch.int32).contiguous()
    lens_host = [4096, 3000, 2048, 1500, 1024, 513, 129, 1]
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    q = randn((SLOTS, H, D), bf16)
    got = ca.paged_flash_decode(q, kp, vp, tables, lens, pages=ppn)
    want = ca.paged_flash_decode_reference(q, kp, vp, tables, lens, pages=ppn)
    torch.cuda.synchronize()
    err = _check("paged_flash_decode bf16 [8,32,128] ctx<=4096", got, want,
                 rel=BF16_REL)
    kc, vc = ca.gather_kv_pages(kp, tables), ca.gather_kv_pages(vp, tables)
    cols = torch.arange(ppn * PAGE, device="cuda")
    mask = (cols[None, :] < lens[:, None])[:, None]
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("paged_flash_decode: the mutants' mask is not "
                             "the plain version's")
    sk = ca.DECODE_SPLIT_KEYS
    for what, drop in (("page 5", (5 * PAGE, 6 * PAGE, [0])),
                       ("last key tile", (4096 - 64, 4096, [0])),
                       (f"keys [{sk}, {2 * sk}) (a lost partial)",
                        (sk, 2 * sk, [0]))):
        _must_fail(f"paged_flash_decode bf16, {what} of the 4096-token row "
                   "dropped",
                   _plain(torch, q[:, None], kc, vc, mask, drop)[:, 0], want,
                   rel=BF16_REL)
    del kc, vc
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"paged_flash_decode bf16 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode(q, kp, vp, tables, edge, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, edge, pages=ppn),
           rel=BF16_REL)
    _bitwise(torch, "paged_flash_decode bf16",
             lambda rows_, sweep: ca.paged_flash_decode(
                 q[rows_].contiguous(), kp, vp, tables[rows_].contiguous(),
                 edge[rows_].contiguous(), pages=sweep // PAGE), edge_host)
    kv_cells = sum(lens_host)
    table_reads = sum(-(-n // PAGE) for n in lens_host)
    nbytes = (kv_cells * KV * D * 2 * 2 + 2 * q.numel() * 2
              + table_reads * 4 + SLOTS * 4)
    bms, by = bound_ms(nbytes, 4 * H * D * kv_cells, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="paged_flash_decode", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_decode.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:211",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_decode(q, kp, vp, tables, lens,
                                                 pages=ppn), 50),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_decode(
            q, kp, vp, tables, lens, pages=ppn), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_decode(
            q, kp, vp, tables, lens, pages=ppn), 20, PAGED_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_decode_reference(
            q, kp, vp, tables, lens, pages=ppn), 5),
        bound_ms=bms, bound_by=by, library_ms=None))
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    serve_pages = SERVE_WINDOW // PAGE
    _check(f"paged_flash_decode bf16 kv_lens {SERVE_LENS} pages {serve_pages}",
           ca.paged_flash_decode(q, kp, vp, tables, serve, pages=serve_pages),
           ca.paged_flash_decode_reference(q, kp, vp, tables, serve,
                                           pages=serve_pages), rel=BF16_REL)
    _serve_times(torch, "paged_flash_decode", lambda: ca.paged_flash_decode(
        q, kp, vp, tables, serve, pages=serve_pages), rows[-1],
        PAGED_DECODE_MARKS)

    # -- paged_flash_extend: the last 476-token chunk of a 1500-token prompt --
    t, start_host, chunk_host = 512, 1024, 476
    q = randn((1, t, H, D), bf16)
    tab1 = tables[:1].contiguous()
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend(q, kp, vp, tab1, start, chunk)
    want = ca.paged_flash_extend_reference(q, kp, vp, tab1, start, chunk)
    torch.cuda.synchronize()
    err = _check("paged_flash_extend bf16 [1,512,32,128] start 1024", got,
                 want, rel=BF16_REL, rows=[chunk_host])
    kc, vc = ca.gather_kv_pages(kp, tab1), ca.gather_kv_pages(vp, tab1)
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = (cols[None, None, :] <= q_pos[None, :, None])
    if not torch.equal(_plain(torch, q, kc, vc, mask), want):
        raise AssertionError("paged_flash_extend: the mutants' mask is not "
                             "the plain version's")
    _must_fail("paged_flash_extend bf16, page 5 (keys 640..767) dropped",
               _plain(torch, q, kc, vc, mask, (5 * PAGE, 6 * PAGE, [0])), want,
               rel=BF16_REL, rows=[chunk_host])
    for what, (kt, vt) in _tile_mutants(kc, vc):
        _must_fail(f"paged_flash_extend bf16, {what}",
                   _plain(torch, q, kt, vt, mask), want, rel=BF16_REL,
                   rows=[chunk_host])
    del kc, vc, mask
    # the function's work: the defined rows, and the keys they see
    keys = start_host + chunk_host
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = (keys * KV * D * 2 * 2 + 2 * chunk_host * H * D * 2
              + -(-keys // PAGE) * 4 + 8)
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    rows.append(dict(
        name="paged_flash_extend", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_extend.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:732",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_extend(q, kp, vp, tab1, start,
                                                 chunk), 20),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_extend(
            q, kp, vp, tab1, start, chunk), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_extend(
            q, kp, vp, tab1, start, chunk), 20, PAGED_EXTEND_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_extend_reference(
            q, kp, vp, tab1, start, chunk), 3),
        bound_ms=bms, bound_by=by, library_ms=None))
    del q, got, want
    _paged_extend_cases(torch, gen, kp, vp, tables)

    # -- the int8 kernels, on the same pages quantized -----------------------
    rows += _quant_kernels(torch, gen, kp, vp, tables, lens_host, tab1,
                           start_host, chunk_host)
    del kp, vp

    # -- the dense slot cache kernels and the LoRA bgmv ----------------------
    rows += _dense_kernels(torch, gen, lens_host, start_host, chunk_host)
    rows += _lora_kernel(torch, gen)
    # -- the speculative verify step's four kernels at its shape -----------
    _verify_kernels(torch, gen, rows)

    # -- fp32 at the serving shapes (D 128, pages of 128) --------------------
    q, k, v = randn((2, 128, H, D), f32), randn((2, 128, KV, D), f32), \
        randn((2, 128, KV, D), f32)
    pl = torch.tensor([128, 77], dtype=torch.int32, device="cuda")
    _check("flash_prefill fp32 [2,128,32,128]",
           ca.flash_prefill(q, k, v, pl),
           ca.flash_prefill_reference(q, k, v, pl), atol=FP32_ATOL,
           rows=[128, 77])
    kp, vp = _pool(torch, gen, pages_total, f32)
    q = randn((SLOTS, H, D), f32)
    _check("paged_flash_decode fp32 [8,32,128] ctx<=4096",
           ca.paged_flash_decode(q, kp, vp, tables, lens, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, lens, pages=ppn),
           atol=FP32_ATOL)
    _check(f"paged_flash_decode fp32 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode(q, kp, vp, tables, edge, pages=ppn),
           ca.paged_flash_decode_reference(q, kp, vp, tables, edge, pages=ppn),
           atol=FP32_ATOL)
    q = randn((1, t, H, D), f32)
    _check("paged_flash_extend fp32 [1,512,32,128] start 1024",
           ca.paged_flash_extend(q, kp, vp, tab1, start, chunk),
           ca.paged_flash_extend_reference(q, kp, vp, tab1, start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    del kp, vp, q, k, v

    # -- fp32 at debug-tiny's head_dim 16, pages of 16, the `pages` bound ----
    kp, vp = _pool(torch, gen, 13, f32, kv=4, d=16, page=16)
    tab = (torch.randperm(12, generator=gen, device="cuda") + 1).reshape(3, 4)
    tab = tab.to(torch.int32).contiguous()
    q = randn((3, 8, 16), f32)
    kl = torch.tensor([1, 16, 45], dtype=torch.int32, device="cuda")
    _check("paged_flash_decode fp32 [3,8,16] G=2 pages=3",
           ca.paged_flash_decode(q, kp, vp, tab, kl, pages=3),
           ca.paged_flash_decode_reference(q, kp, vp, tab, kl, pages=3),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    st = torch.tensor([0, 13, 40], dtype=torch.int32, device="cuda")
    ch = torch.tensor([16, 9, 3], dtype=torch.int32, device="cuda")
    _check("paged_flash_extend fp32 [3,16,8,16] G=2",
           ca.paged_flash_extend(q, kp, vp, tab, st, ch),
           ca.paged_flash_extend_reference(q, kp, vp, tab, st, ch),
           atol=FP32_ATOL, rows=[16, 9, 3])
    qk, qv = quantize_kv(kp), quantize_kv(vp)
    q = randn((3, 8, 16), f32)
    _check("paged_flash_decode_quant fp32 [3,8,16] G=2 pages=3",
           ca.paged_flash_decode_quant(q, *qk, *qv, tab, kl, pages=3),
           ca.paged_flash_decode_quant_reference(q, *qk, *qv, tab, kl, pages=3),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    _check("paged_flash_extend_quant fp32 [3,16,8,16] G=2",
           ca.paged_flash_extend_quant(q, *qk, *qv, tab, st, ch),
           ca.paged_flash_extend_quant_reference(q, *qk, *qv, tab, st, ch),
           atol=FP32_ATOL, rows=[16, 9, 3])
    for r in rows:
        lib = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms warm"
               + (f", {r['library_ms_cold']:.4f} ms L2 cold"
                  if "library_ms_cold" in r else ""))
        cold = (f", {r['ms_cold']:.4f} ms L2 cold" if "ms_cold" in r else "")
        cold += (f", device {r['dev_ms']:.4f} ms" if "dev_ms" in r else "")
        serve = (f"; serve shape {r['serve_ms']:.4f} ms warm, "
                 f"{r['serve_ms_cold']:.4f} ms L2 cold, device "
                 f"{r['serve_dev_ms']:.4f} ms" if "serve_ms" in r else "")
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms warm{cold}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}){serve}")
    return rows


def _sdpa_ms(torch, q, k, v, mask) -> tuple[float, float]:
    """The yardstick call for the dense kernels: SDPA with a boolean mask
    and the KV heads shared by their query group (enable_gqa), on the
    [B, heads, T, D] layout prepared outside the timed region. Timed only,
    warm and with the L2 cold; the port never calls it."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = mask[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m,
                                              enable_gqa=True)

    return cuda_ms(sdpa, 10), cuda_ms_cold(sdpa, 10)


def _tc_mutants(torch, name, q, k, v, shifted, want, rows) -> None:
    """Faults a fragment-layout error in the tensor-core body would make,
    which the bf16 limit must reject: the causal diagonal shifted by one
    (`shifted`: row t also sees key t + 1), and one head of a GQA group
    writing its neighbour's output (head 1 given head 0's rows)."""
    _must_fail(f"{name} bf16, causal diagonal shifted by one key",
               _plain(torch, q, k, v, shifted), want, rel=BF16_REL, rows=rows)
    swapped = want.clone()
    swapped[:, :, 1] = want[:, :, 0]
    _must_fail(f"{name} bf16, head 1 of the group given head 0's output",
               swapped, want, rel=BF16_REL, rows=rows)


def _tc_head_dim_64(torch, gen) -> None:
    """The tensor-core prefill and extend at head_dim 64 in bf16, with GQA
    groups that do not fill the 64 rows alike: Qwen2.5-0.5B (14 heads over
    2 KV heads, G = 7: 9 positions, 63 live rows) and TinyLlama-1.1B (32
    over 4, G = 8). Prompt lengths on the 64-key tile's edges; extend starts
    inside a tile, and one chunk whose second query tile is all padding."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for tag, h, kv in (("Qwen2.5-0.5B G=7", 14, 2), ("TinyLlama G=8", 32, 4)):
        lens_host = [1, 63, 64, 65, 127, 129]
        b, t, d = len(lens_host), 192, 64
        q, k, v = randn((b, t, h, d)), randn((b, t, kv, d)), randn((b, t, kv, d))
        plens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
        got = ca.flash_prefill(q, k, v, plens)
        want = ca.flash_prefill_reference(q, k, v, plens)
        torch.cuda.synchronize()
        _check(f"flash_prefill bf16 [{b},{t},{h},{d}] kv {kv} ({tag}) lens "
               f"{lens_host}", got, want, rel=BF16_REL, rows=lens_host)
        pos = torch.arange(t, device="cuda")
        shifted = ((pos[None, :, None] + 1 >= pos[None, None, :])
                   & (pos[None, None, :] < plens[:, None, None]))
        _tc_mutants(torch, f"flash_prefill ({tag})", q, k, v, shifted, want,
                    lens_host)
        s_len, t = 1024, 256
        q = randn((2, t, h, d))
        kc, vc = randn((2, s_len, kv, d)), randn((2, s_len, kv, d))
        start_host, chunk_host = [777, 37], [200, 50]
        start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
        chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
        got = ca.flash_extend(q, kc, vc, start, chunk)
        want = ca.flash_extend_reference(q, kc, vc, start, chunk)
        torch.cuda.synchronize()
        _check(f"flash_extend bf16 [2,{t},{h},{d}] rows [2,{s_len},{kv},{d}] "
               f"({tag}) start {start_host} chunk {chunk_host}", got, want,
               rel=BF16_REL, rows=chunk_host)


def _edge_lens(ca) -> list[int]:
    """kv_lens on the split-K decodes' split edges: one below, at and one
    above kSplitKeys, an empty row, the full 4096, one a few keys into the
    fourth split, one key, and two whole splits."""
    sk = ca.DECODE_SPLIT_KEYS
    return [sk - 1, sk, sk + 1, 0, CAPACITY, 3 * sk + 7, 1, 2 * sk]


def _bitwise(torch, name, run, lens_host) -> None:
    """A split-K decode's rows do not depend on the batch or the sweep:
    row 0 computed alone equals its row in the batch, bit for bit, and the
    rows with kv_len <= kSplitKeys (one split) give the same bits under a
    sweep of 4096 keys (split kernel + combine) as under 256 (one launch).
    `run(rows, sweep)` runs the kernel on the batch rows `rows` (a slice)
    with that sweep."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    full = run(slice(None), CAPACITY)
    alone = run(slice(0, 1), CAPACITY)
    torch.cuda.synchronize()
    if not torch.equal(alone[0], full[0]):
        raise AssertionError(f"{name}: row 0 alone differs from its row in "
                             "the batch")
    short = [i for i, n in enumerate(lens_host) if n <= ca.DECODE_SPLIT_KEYS]
    narrow = run(slice(None), SERVE_WINDOW)
    torch.cuda.synchronize()
    if not torch.equal(narrow[short], full[short]):
        raise AssertionError(f"{name}: rows {short} differ between sweeps "
                             f"{CAPACITY} and {SERVE_WINDOW}")
    log(f"  {name}: row 0 alone == its row in the batch of {len(lens_host)}, "
        f"bit for bit; rows {short} (kv_len <= {ca.DECODE_SPLIT_KEYS}) equal "
        f"under sweeps {CAPACITY} and {SERVE_WINDOW}, bit for bit")


def _serve_times(torch, name, call, row, marks) -> None:
    """Time `call` (the kernel at the serve phases' decode shape) warm, with
    the L2 cold and in device time (the kernels named by `marks`), into
    row["serve_ms"], row["serve_ms_cold"], row["serve_dev_ms"]."""
    row["serve_ms"] = cuda_ms(call, 50)
    row["serve_ms_cold"] = cuda_ms_cold(call, 20)
    row["serve_dev_ms"] = profiled_ms(call, 20, marks)
    log(f"  {name} at the serve shape (kv_lens {SERVE_LENS}, sweep "
        f"{SERVE_WINDOW}): kernel {row['serve_ms']:.4f} ms warm, "
        f"{row['serve_ms_cold']:.4f} ms L2 cold, device "
        f"{row['serve_dev_ms']:.4f} ms")


def _tile_mutants(kc, vc):
    """(name, (K, V)) for faults of a paged extend's per-tile table read, on
    gathered rows [B, N*PS, K, D] with pages of 128: the first 64-key tile
    of page entry 5 (keys 640..703) read from entry 6, and the second half
    of that page (keys 704..767) read from its first half."""
    t0 = 5 * PAGE
    for what, dst, src in (
            ("keys 640..703 read from the next page-table entry",
             (t0, t0 + 64), (t0 + PAGE, t0 + PAGE + 64)),
            ("keys 704..767 (the page's second 64-key half) read from its "
             "first half", (t0 + 64, t0 + PAGE), (t0, t0 + 64))):
        kt, vt = kc.clone(), vc.clone()
        kt[:, dst[0]:dst[1]] = kc[:, src[0]:src[1]]
        vt[:, dst[0]:dst[1]] = vc[:, src[0]:src[1]]
        yield what, (kt, vt)


def _repage(torch, gen, rows_k, rows_v, ps):
    """K and V pools of `ps`-token pages holding dense rows [B, S, K, D] in
    shuffled pages (page 0 unused, as the engine's trash page) and their
    block tables [B, S / ps]: the paged layout of the same keys."""
    b, s, kv, d = rows_k.shape
    n = s // ps
    perm = torch.randperm(b * n, generator=gen, device="cuda") + 1
    pools = []
    for rows in (rows_k, rows_v):
        pool = torch.zeros((b * n + 1, ps, kv, d), dtype=rows.dtype,
                           device="cuda")
        pool[perm] = rows.reshape(b * n, ps, kv, d)
        pools.append(pool)
    return (*pools, perm.reshape(b, n).to(torch.int32).contiguous())


def _extend_pair(torch, name, q, kp, vp, tables, start_host, chunk_host):
    """One paged extend case in bf16, both kernels: paged_flash_extend over
    the pools and paged_flash_extend_quant over them quantized, each against
    its plain version; the int8 kernel equal bit for bit to the bf16 kernel
    over the pools dequantized with dequantize_kv. Returns the bf16
    output."""
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import dequantize_kv, quantize_kv

    start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
    chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend(q, kp, vp, tables, start, chunk)
    _check(f"paged_flash_extend bf16 {name}", got,
           ca.paged_flash_extend_reference(q, kp, vp, tables, start, chunk),
           rel=BF16_REL, rows=chunk_host)
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    got8 = ca.paged_flash_extend_quant(q, kq, ks, vq, vs, tables, start, chunk)
    _check(f"paged_flash_extend_quant bf16 {name}", got8,
           ca.paged_flash_extend_quant_reference(q, kq, ks, vq, vs, tables,
                                                 start, chunk),
           rel=BF16_REL, rows=chunk_host)
    deq = ca.paged_flash_extend(q, dequantize_kv(kq, ks, torch.bfloat16),
                                dequantize_kv(vq, vs, torch.bfloat16), tables,
                                start, chunk)
    torch.cuda.synchronize()
    if not torch.equal(got8, deq):
        raise AssertionError(f"paged_flash_extend_quant {name}: not the bf16 "
                             "extend's bits over the dequantized pools")
    return got


def _paged_extend_cases(torch, gen, kp, vp, tables) -> None:
    """The tensor-core paged extends (bf16) on the edges of their 64-key
    tiles and per-tile table reads, each case for both kernels
    (_extend_pair): the table shape (476 queries at 1024) and a start
    inside a key tile (1000), both bit for bit against flash_extend over the
    dense row that holds the same keys; a chunk that crosses a page
    boundary inside a query tile; 3 rows with other starts and chunk_lens,
    whose padding query tiles read nothing, row 0 alone equal to its row in
    the batch; pages of 16, 32, 64 and 128 with shuffled tables, each equal
    to flash_extend over the dense row; head_dim 64 with GQA groups of 7
    and 8."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    bf16 = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def same_as_dense(name, got, q, kc, vc, start_host, chunk_host):
        start = torch.tensor(start_host, dtype=torch.int32, device="cuda")
        chunk = torch.tensor(chunk_host, dtype=torch.int32, device="cuda")
        dense = ca.flash_extend(q, kc, vc, start, chunk)
        torch.cuda.synchronize()
        if not torch.equal(got, dense):
            raise AssertionError(f"paged_flash_extend {name}: not "
                                 "flash_extend's bits over the dense row")
        log(f"  paged_flash_extend bf16 {name}: flash_extend's bits over the "
            "dense row holding the same keys")

    tab1 = tables[:1].contiguous()
    kc, vc = ca.gather_kv_pages(kp, tab1), ca.gather_kv_pages(vp, tab1)
    for start_host in (1024, 1000):
        q = randn((1, 512, H, D))
        name = f"[1,512,{H},{D}] start {start_host} chunk 476"
        got = _extend_pair(torch, name, q, kp, vp, tab1, [start_host], [476])
        same_as_dense(name, got, q, kc, vc, [start_host], [476])
    q = randn((1, 64, H, D))
    _extend_pair(torch, f"[1,64,{H},{D}] start 100 chunk 60 (crosses the "
                 "page edge at 128 inside query tile 1)", q, kp, vp, tab1,
                 [100], [60])
    # 3 rows: row 1's query tiles 1..3 and row 2's tile 3 are all padding
    starts, chunks = [1000, 0, 517], [64, 10, 33]
    q = randn((3, 64, H, D))
    tab3 = tables[:3].contiguous()
    got = _extend_pair(torch, f"[3,64,{H},{D}] starts {starts} chunk_lens "
                       f"{chunks}", q, kp, vp, tab3, starts, chunks)
    alone = ca.paged_flash_extend(
        q[:1].contiguous(), kp, vp, tab1,
        torch.tensor(starts[:1], dtype=torch.int32, device="cuda"),
        torch.tensor(chunks[:1], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    if not torch.equal(alone[0], got[0]):
        raise AssertionError("paged_flash_extend: row 0 alone differs from "
                             "its row in the batch of 3")
    log("  paged_flash_extend bf16: row 0 alone == its row in the batch of "
        "3, bit for bit")
    # pages of 16..128 holding slot 0's first 1536 keys, shuffled tables
    rows_k, rows_v = kc[:, :1536].contiguous(), vc[:, :1536].contiguous()
    q = randn((1, 256, H, D))
    for ps in (16, 32, 64, 128):
        pk, pv, tab = _repage(torch, gen, rows_k, rows_v, ps)
        name = f"[1,256,{H},{D}] pages of {ps} start 1000 chunk 200"
        got = _extend_pair(torch, name, q, pk, pv, tab, [1000], [200])
        same_as_dense(name, got, q, rows_k, rows_v, [1000], [200])
    del kc, vc, rows_k, rows_v
    # head_dim 64 (Qwen2.5-0.5B G = 7, TinyLlama G = 8)
    for tag, h, kv, ps in (("G=7", 14, 2, 16), ("G=8", 32, 4, 128)):
        rows_k, rows_v = randn((2, 1024, kv, 64)), randn((2, 1024, kv, 64))
        pk, pv, tab = _repage(torch, gen, rows_k, rows_v, ps)
        q = randn((2, 256, h, 64))
        name = (f"[2,256,{h},64] kv {kv} ({tag}) pages of {ps} starts "
                "[777, 37] chunks [200, 50]")
        got = _extend_pair(torch, name, q, pk, pv, tab, [777, 37], [200, 50])
        same_as_dense(name, got, q, rows_k, rows_v, [777, 37], [200, 50])


def _dense_kernels(torch, gen, lens_host, start_host, chunk_host) -> list[dict]:
    """flash_decode and flash_extend over the dense slot cache at the
    serving shapes (8 slots of 4096 cells; one 476-token chunk at 1024),
    bf16 and fp32 against their plain versions, the mutants the bf16 limit
    must reject (the last 64-key tile left out; the next slot's row read),
    fp32 at debug-tiny's head_dim with a window below S, timings."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    bf16, f32 = torch.bfloat16, torch.float32
    out = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- flash_decode: 8 slots, contexts 4096..1, the full sweep -------------
    kc, vc = randn((SLOTS, CAPACITY, KV, D), bf16), \
        randn((SLOTS, CAPACITY, KV, D), bf16)
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    q = randn((SLOTS, H, D), bf16)
    got = ca.flash_decode(q, kc, vc, lens, window=CAPACITY)
    want = ca.flash_decode_reference(q, kc, vc, lens, window=CAPACITY)
    torch.cuda.synchronize()
    err = _check("flash_decode bf16 [8,32,128] cache [8,4096,8,128]", got,
                 want, rel=BF16_REL)
    cols = torch.arange(CAPACITY, device="cuda")
    mask = (cols[None, :] < lens[:, None])[:, None]
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("flash_decode: the mutants' mask is not the "
                             "plain version's")
    _must_fail("flash_decode bf16, last 64-key tile of the 4096-token row "
               "left out",
               _plain(torch, q[:, None], kc, vc, mask,
                      (CAPACITY - 64, CAPACITY, [0]))[:, 0], want,
               rel=BF16_REL)
    _must_fail("flash_decode bf16, the next slot's row read",
               _plain(torch, q[:, None], kc.roll(-1, 0), vc.roll(-1, 0),
                      mask)[:, 0], want, rel=BF16_REL)
    sk = ca.DECODE_SPLIT_KEYS
    _must_fail(f"flash_decode bf16, keys [{sk}, {2 * sk}) of the 4096-token "
               "row left out (a lost partial)",
               _plain(torch, q[:, None], kc, vc, mask,
                      (sk, 2 * sk, [0]))[:, 0], want, rel=BF16_REL)
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"flash_decode bf16 kv_lens {edge_host} (split edges)",
           ca.flash_decode(q, kc, vc, edge, window=CAPACITY),
           ca.flash_decode_reference(q, kc, vc, edge, window=CAPACITY),
           rel=BF16_REL)
    _bitwise(torch, "flash_decode bf16", lambda rows, sweep: ca.flash_decode(
        q[rows].contiguous(), kc[rows].contiguous(), vc[rows].contiguous(),
        edge[rows].contiguous(), window=sweep), edge_host)
    cells = sum(lens_host)
    nbytes = cells * KV * D * 2 * 2 + 2 * q.numel() * 2 + SLOTS * 4
    bms, by = bound_ms(nbytes, 4 * H * D * cells, PEAK_BF16_FLOPS)
    out.append(dict(
        name="flash_decode", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_decode.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:128",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_decode(q, kc, vc, lens,
                                           window=CAPACITY), 50),
        ms_cold=cuda_ms_cold(lambda: ca.flash_decode(q, kc, vc, lens,
                                                     window=CAPACITY), 20),
        dev_ms=profiled_ms(lambda: ca.flash_decode(q, kc, vc, lens,
                                                   window=CAPACITY), 20,
                           DENSE_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.flash_decode_reference(
            q, kc, vc, lens, window=CAPACITY), 5),
        bound_ms=bms, bound_by=by,
        **dict(zip(("library_ms", "library_ms_cold"),
                   _sdpa_ms(torch, q[:, None], kc, vc, mask)))))
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    _check(f"flash_decode bf16 kv_lens {SERVE_LENS} window {SERVE_WINDOW}",
           ca.flash_decode(q, kc, vc, serve, window=SERVE_WINDOW),
           ca.flash_decode_reference(q, kc, vc, serve, window=SERVE_WINDOW),
           rel=BF16_REL)
    _serve_times(torch, "flash_decode", lambda: ca.flash_decode(
        q, kc, vc, serve, window=SERVE_WINDOW), out[-1], DENSE_DECODE_MARKS)
    qf = randn((SLOTS, H, D), f32)
    kf, vf = kc.float(), vc.float()
    _check("flash_decode fp32 [8,32,128] cache [8,4096,8,128]",
           ca.flash_decode(qf, kf, vf, lens, window=CAPACITY),
           ca.flash_decode_reference(qf, kf, vf, lens, window=CAPACITY),
           atol=FP32_ATOL)
    _check(f"flash_decode fp32 kv_lens {edge_host} (split edges)",
           ca.flash_decode(qf, kf, vf, edge, window=CAPACITY),
           ca.flash_decode_reference(qf, kf, vf, edge, window=CAPACITY),
           atol=FP32_ATOL)
    del kf, vf, qf

    # -- flash_extend: the 476-token chunk at 1024 of slot 0's row -----------
    t = 512
    q = randn((1, t, H, D), bf16)
    rows_k, rows_v = kc[:1].contiguous(), vc[:1].contiguous()
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.flash_extend(q, rows_k, rows_v, start, chunk)
    want = ca.flash_extend_reference(q, rows_k, rows_v, start, chunk)
    torch.cuda.synchronize()
    err = _check("flash_extend bf16 [1,512,32,128] rows [1,4096,8,128] "
                 "start 1024", got, want, rel=BF16_REL, rows=[chunk_host])
    keys = start_host + chunk_host
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = cols[None, None, :] <= q_pos[None, :, None]
    if not torch.equal(_plain(torch, q, rows_k, rows_v, mask), want):
        raise AssertionError("flash_extend: the mutants' mask is not the "
                             "plain version's")
    last = (keys - 1) // 64 * 64
    _must_fail(f"flash_extend bf16, last 64-key tile [{last}, {keys}) left out",
               _plain(torch, q, rows_k, rows_v, mask, (last, keys, [0])), want,
               rel=BF16_REL, rows=[chunk_host])
    _must_fail("flash_extend bf16, the next slot's row read",
               _plain(torch, q, kc[1:2], vc[1:2], mask), want, rel=BF16_REL,
               rows=[chunk_host])
    _tc_mutants(torch, "flash_extend", q, rows_k, rows_v,
                cols[None, None, :] <= q_pos[None, :, None] + 1, want,
                [chunk_host])
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = keys * KV * D * 2 * 2 + 2 * chunk_host * H * D * 2 + 8
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    out.append(dict(
        name="flash_extend", route="cuda",
        source="llmlb_tpu_torch/csrc/flash_extend.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:642",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.flash_extend(q, rows_k, rows_v, start, chunk),
                   20),
        ms_cold=cuda_ms_cold(lambda: ca.flash_extend(q, rows_k, rows_v, start,
                                                     chunk), 20),
        plain_ms=cuda_ms(lambda: ca.flash_extend_reference(
            q, rows_k, rows_v, start, chunk), 3),
        bound_ms=bms, bound_by=by,
        **dict(zip(("library_ms", "library_ms_cold"),
                   _sdpa_ms(torch, q, rows_k, rows_v, mask)))))
    # the same chunk starting inside a key tile (1000 = 15 * 64 + 40)
    st = torch.tensor([1000], dtype=torch.int32, device="cuda")
    _check("flash_extend bf16 [1,512,32,128] rows [1,4096,8,128] start 1000",
           ca.flash_extend(q, rows_k, rows_v, st, chunk),
           ca.flash_extend_reference(q, rows_k, rows_v, st, chunk),
           rel=BF16_REL, rows=[chunk_host])
    qf = randn((1, t, H, D), f32)
    kf, vf = rows_k.float(), rows_v.float()
    _check("flash_extend fp32 [1,512,32,128] rows [1,4096,8,128] start 1024",
           ca.flash_extend(qf, kf, vf, start, chunk),
           ca.flash_extend_reference(qf, kf, vf, start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    del kc, vc, rows_k, rows_v, kf, vf, q, qf

    # -- fp32 at debug-tiny's head_dim 16, G=2, a window below S -------------
    kc, vc = randn((3, 320, 4, 16), f32), randn((3, 320, 4, 16), f32)
    q = randn((3, 8, 16), f32)
    kl = torch.tensor([1, 137, 256], dtype=torch.int32, device="cuda")
    _check("flash_decode fp32 [3,8,16] cache [3,320,4,16] window 256",
           ca.flash_decode(q, kc, vc, kl, window=256),
           ca.flash_decode_reference(q, kc, vc, kl, window=256),
           atol=FP32_ATOL)
    q = randn((3, 16, 8, 16), f32)
    st = torch.tensor([0, 13, 300], dtype=torch.int32, device="cuda")
    ch = torch.tensor([16, 9, 3], dtype=torch.int32, device="cuda")
    _check("flash_extend fp32 [3,16,8,16] rows [3,320,4,16]",
           ca.flash_extend(q, kc, vc, st, ch),
           ca.flash_extend_reference(q, kc, vc, st, ch), atol=FP32_ATOL,
           rows=[16, 9, 3])
    return out


def _lora_kernel(torch, gen) -> list[dict]:
    """lora_delta at Llama-3-8B's four projection shapes, 9 pool rows (8
    adapters and the identity) at rank 16, decode (8, 1) and prefill (8, 128)
    rows, and (8, 512) timed: mode (a), the fp32 delta, against the plain
    version; mode (b), the delta added into a projection output y in place,
    bit for bit against y + mode (a) rounded (and within the bf16 limit of
    y + the plain delta rounded); the mutants the limit must reject (the
    next adapter's rows, the last rank column, one cluster rank's partial
    left out); an all-identity batch (+0.0 in mode a, y + 0.0 in mode b);
    fp32 at the same and at debug-tiny widths; timings of both modes."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import lora_target_dims
    from llmlb_tpu_torch.ops import lora

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_preset("llama-3-8b")
    rank, n_rows = 16, 9
    idx_host = [0, 3, 1, 0, 8, 2, 2, 5]
    idx = torch.tensor(idx_host, dtype=torch.int32, device="cuda")
    marks = ("bgmv_cluster_kernel",)

    def pools(in_dim, out_dim, dtype, rank=rank, n_rows=n_rows):
        a = torch.randn((n_rows, in_dim, rank), generator=gen,
                        device="cuda") * in_dim**-0.5
        b = torch.randn((n_rows, rank, out_dim), generator=gen,
                        device="cuda") * rank**-0.5
        a[0] = 0.0  # the identity adapter
        b[0] = 0.0
        return a.to(dtype).contiguous(), b.to(dtype).contiguous()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def both_modes(tag, x, a, b, ix, y, rel):
        """Mode (a) against the plain version, mode (b) bit for bit against
        y + mode (a) rounded; returns (mode a's max error, the delta)."""
        got = lora.lora_delta(x, a, b, ix)
        want = lora.lora_delta_reference(x, a, b, ix)
        fused = lora.lora_delta_add(y.clone(), x, a, b, ix)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"{tag}: output is {got.dtype}")
        err = _check(f"{tag} mode (a)", got, want, rel=rel)
        if not torch.equal(fused, y + got.to(y.dtype)):
            raise AssertionError(f"{tag}: mode (b) is not y + delta.to(dtype) "
                                 "bit for bit")
        plain = y + want.to(y.dtype)
        differ = int((fused != plain).sum())
        _check(f"{tag} mode (b) against y + plain delta ({differ} of "
               f"{plain.numel()} elements differ from it by a rounding)",
               fused, plain, rel=BF16_REL if y.dtype == bf16 else rel)
        log(f"  {tag} mode (b): bit for bit y + mode (a).to({y.dtype})")
        return err, got

    row = None
    dims = lora_target_dims(cfg, ("wq", "wk", "wg", "wd"))
    for tgt, (in_dim, out_dim) in dims.items():
        a, b = pools(in_dim, out_dim, bf16)
        for t in (1, 128, 512):
            x = randn((SLOTS, t, in_dim), bf16)
            y = randn((SLOTS, t, out_dim), bf16)
            tag = f"lora_delta bf16 {tgt} x [8,{t},{in_dim}] -> {out_dim}"
            err, got = both_modes(tag, x, a, b, idx, y, LORA_REL)
            want = lora.lora_delta_reference(x, a, b, idx)
            if tgt == "wg" and t in (1, 128):
                plan = lora.lora_plan(t, in_dim, out_dim)
                lo, hi = plan["in"][3]
                x_cut = x.clone()
                x_cut[..., lo:hi] = 0
                _must_fail(f"{tag}, cluster rank 3's partial (IN [{lo}, {hi})"
                           f" of {plan['cluster']} slices) left out",
                           lora.lora_delta_reference(x_cut, a, b, idx), want,
                           rel=LORA_REL)
                _must_fail(f"{tag}, row i reading adapter idx_i + 1",
                           lora.lora_delta_reference(x, a, b, (idx + 1) % n_rows),
                           want, rel=LORA_REL)
                a_cut = a.clone()
                a_cut[..., -1] = 0
                _must_fail(f"{tag}, the last rank column dropped",
                           lora.lora_delta_reference(x, a_cut, b, idx), want,
                           rel=LORA_REL)
                zeros = torch.zeros_like(idx)
                zero = lora.lora_delta(x, a, b, zeros)
                if not (torch.equal(zero, torch.zeros_like(zero))
                        and not torch.signbit(zero).any()):
                    raise AssertionError("lora_delta: the identity row's delta "
                                         "is not exactly +0.0")
                y0 = y.clone()
                y0[..., :4] = -0.0
                if not torch.equal(lora.lora_delta_add(y0.clone(), x, a, b,
                                                       zeros), y0 + 0.0):
                    raise AssertionError("lora_delta_add: the identity rows "
                                         "are not y + 0.0")
                log(f"  {tag}, idx all 0: delta exactly +0.0, mode (b) y + 0.0")
            ms_a = cuda_ms(lambda: lora.lora_delta(x, a, b, idx), 50)
            ms_b = cuda_ms(lambda: lora.lora_delta_add(y, x, a, b, idx), 50)
            # back to back, a call this short is bound by the host's launch
            # path; the profiler gives the kernel's own time
            dev_a = profiled_ms(lambda: lora.lora_delta(x, a, b, idx), 20,
                                marks)
            dev_b = profiled_ms(lambda: lora.lora_delta_add(y, x, a, b, idx),
                                20, marks)
            log(f"  {tag}: mode (a) {ms_a:.4f} ms warm, device {dev_a:.4f} ms; "
                f"mode (b) {ms_b:.4f} ms warm, device {dev_b:.4f} ms")
            if t == 1 and tgt == "wg":
                # the main path's call: mode (b). Its least work: x once, the
                # 7 distinct rows the batch selects once, y read and written
                # once; two products per (row, position)
                distinct = len(set(idx_host))
                nbytes = (x.numel() * 2 + distinct * rank * (in_dim + out_dim)
                          * 2 + 2 * y.numel() * 2 + SLOTS * 4)
                bms, by = bound_ms(nbytes, 2 * SLOTS * t * rank
                                   * (in_dim + out_dim), PEAK_BF16_FLOPS)
                nbytes_a = nbytes - 2 * y.numel() * 2 + SLOTS * t * out_dim * 4
                row = dict(
                    name="lora_delta", route="cuda",
                    source="llmlb_tpu_torch/csrc/lora_bgmv.cu",
                    replaces="llmlb_tpu/ops/lora.py:87", max_abs_err=err,
                    ms=ms_b, dev_ms=dev_b,
                    ms_cold=cuda_ms_cold(
                        lambda: lora.lora_delta_add(y, x, a, b, idx), 20),
                    mode_a_ms=ms_a, mode_a_dev_ms=dev_a,
                    mode_a_bound_ms=bound_ms(nbytes_a, 0, PEAK_BF16_FLOPS)[0],
                    plain_ms=cuda_ms(lambda: y + lora.lora_delta_reference(
                        x, a, b, idx).to(bf16), 5),
                    bound_ms=bms, bound_by=by, library_ms=None)
                log(f"  lora_delta at the decode shape (wg, mode b): bound "
                    f"{bms:.5f} ms ({by}); mode (a) bound "
                    f"{row['mode_a_bound_ms']:.5f} ms")
            del x, y, got, want
        af, bf = a.float(), b.float()
        xf = randn((SLOTS, 1, in_dim), f32)
        both_modes(f"lora_delta fp32 {tgt} x [8,1,{in_dim}] -> {out_dim}",
                   xf, af, bf, idx, randn((SLOTS, 1, out_dim), f32), LORA_REL)
        del a, b, af, bf, xf
    # fp32 at debug-tiny's widths (hidden 128, KV 64, ffn 256), rank 8
    tiny = get_preset("debug-tiny")
    for tgt, (in_dim, out_dim) in lora_target_dims(
            tiny, ("wq", "wk", "wg", "wd")).items():
        a, b = pools(in_dim, out_dim, f32, rank=8, n_rows=3)
        x = randn((5, 7, in_dim), f32)
        ix = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32, device="cuda")
        both_modes(f"lora_delta fp32 debug-tiny {tgt} x [5,7,{in_dim}] -> "
                   f"{out_dim}", x, a, b, ix, randn((5, 7, out_dim), f32),
                   LORA_REL)
    return [row]


def _dequant(codes, scales, tables, dtype, scale_tables=None):
    """The plain versions' dequantized rows [B, N*PS, K, D]: codes gathered
    through `tables`, scales through `scale_tables` (default the same)."""
    from llmlb_tpu_torch.quant import dequantize_kv

    idx = tables.long()
    sidx = idx if scale_tables is None else scale_tables.long()
    b, n = idx.shape
    _, ps, kv, d = codes.shape
    return dequantize_kv(codes[idx].reshape(b, n * ps, kv, d),
                         scales[sidx].reshape(b, n * ps, kv), dtype)


def _quant_kernels(torch, gen, kp, vp, tables, lens_host, tab1, start_host,
                   chunk_host) -> list[dict]:
    """paged_flash_decode_quant and paged_flash_extend_quant at the shapes of
    the bf16 checks above, on those pools quantized: bf16 and fp32 against
    the plain versions, four mutants the bf16 limit must reject, timings."""
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.quant import quantize_kv

    bf16, f32 = torch.bfloat16, torch.float32
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    ppn = tables.shape[1]
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    cols = torch.arange(ppn * PAGE, device="cuda")
    out = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def mutants(q, mask, tab, decode):
        """(name, plain version with the fault) for faults a kernel reading
        int8 pages could have."""
        kc, vc = (_dequant(kq, ks, tab, q.dtype), _dequant(vq, vs, tab, q.dtype))
        yield "page 5 of row 0 left out", _plain(torch, q, kc, vc, mask,
                                                   (5 * PAGE, 6 * PAGE, [0]))
        if decode:  # the 4096-token row's last key tile, a lost partial
            yield "last 64-key tile of row 0 left out", _plain(
                torch, q, kc, vc, mask, (4096 - 64, 4096, [0]))
            sk = ca.DECODE_SPLIT_KEYS
            yield (f"keys [{sk}, {2 * sk}) of row 0 left out (a lost "
                   "partial)", _plain(torch, q, kc, vc, mask,
                                      (sk, 2 * sk, [0])))
        # an off-by-one in the scale index: K scales of the next page
        wrong = _dequant(kq, ks, tab, q.dtype, torch.roll(tab, -1, dims=1))
        yield "K scales read from the next page", _plain(torch, q, wrong, vc,
                                                         mask)
        yield "K's scales used for V", _plain(
            torch, q, kc, _dequant(vq, ks, tab, q.dtype), mask)

    # -- decode: 8 rows, contexts 4096..1 -------------------------------------
    q = randn((SLOTS, H, D), bf16)
    got = ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, lens, pages=ppn)
    want = ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 lens, pages=ppn)
    torch.cuda.synchronize()
    err = _check("paged_flash_decode_quant bf16 [8,32,128] ctx<=4096", got,
                 want, rel=BF16_REL)
    mask = (cols[None, :] < lens[:, None])[:, None]
    kc, vc = _dequant(kq, ks, tables, bf16), _dequant(vq, vs, tables, bf16)
    if not torch.equal(_plain(torch, q[:, None], kc, vc, mask)[:, 0], want):
        raise AssertionError("paged_flash_decode_quant: the mutants' plain "
                             "version is not the plain version")
    del kc, vc
    for what, mutant in mutants(q[:, None], mask, tables, True):
        _must_fail(f"paged_flash_decode_quant bf16, {what}", mutant[:, 0],
                   want, rel=BF16_REL)
    kv_cells = sum(lens_host)
    table_reads = sum(-(-n // PAGE) for n in lens_host)
    # codes and a float32 scale per (position, KV head), for K and V
    nbytes = (kv_cells * KV * (D + 4) * 2 + 2 * q.numel() * 2
              + table_reads * 4 + SLOTS * 4)
    bms, by = bound_ms(nbytes, 4 * H * D * kv_cells, PEAK_BF16_FLOPS)
    out.append(dict(
        name="paged_flash_decode_quant", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_decode_quant.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:346",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 50),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_decode_quant(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 20,
            QUANT_DECODE_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_decode_quant_reference(
            q, kq, ks, vq, vs, tables, lens, pages=ppn), 5),
        bound_ms=bms, bound_by=by, library_ms=None))
    edge_host = _edge_lens(ca)
    edge = torch.tensor(edge_host, dtype=torch.int32, device="cuda")
    _check(f"paged_flash_decode_quant bf16 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, edge,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 edge, pages=ppn),
           rel=BF16_REL)
    _bitwise(torch, "paged_flash_decode_quant bf16",
             lambda rows, sweep: ca.paged_flash_decode_quant(
                 q[rows].contiguous(), kq, ks, vq, vs,
                 tables[rows].contiguous(), edge[rows].contiguous(),
                 pages=sweep // PAGE), edge_host)
    serve = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    serve_pages = SERVE_WINDOW // PAGE
    _check(f"paged_flash_decode_quant bf16 kv_lens {SERVE_LENS} pages "
           f"{serve_pages}",
           ca.paged_flash_decode_quant(q, kq, ks, vq, vs, tables, serve,
                                       pages=serve_pages),
           ca.paged_flash_decode_quant_reference(q, kq, ks, vq, vs, tables,
                                                 serve, pages=serve_pages),
           rel=BF16_REL)
    _serve_times(torch, "paged_flash_decode_quant",
                 lambda: ca.paged_flash_decode_quant(
                     q, kq, ks, vq, vs, tables, serve, pages=serve_pages),
                 out[-1], QUANT_DECODE_MARKS)
    qf = randn((SLOTS, H, D), f32)
    _check("paged_flash_decode_quant fp32 [8,32,128] ctx<=4096",
           ca.paged_flash_decode_quant(qf, kq, ks, vq, vs, tables, lens,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(qf, kq, ks, vq, vs, tables,
                                                 lens, pages=ppn),
           atol=FP32_ATOL)
    _check(f"paged_flash_decode_quant fp32 kv_lens {edge_host} (split edges)",
           ca.paged_flash_decode_quant(qf, kq, ks, vq, vs, tables, edge,
                                       pages=ppn),
           ca.paged_flash_decode_quant_reference(qf, kq, ks, vq, vs, tables,
                                                 edge, pages=ppn),
           atol=FP32_ATOL)

    # -- extend: one 476-token chunk at position 1024 ------------------------
    t = 512
    q = randn((1, t, H, D), bf16)
    start = torch.tensor([start_host], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([chunk_host], dtype=torch.int32, device="cuda")
    got = ca.paged_flash_extend_quant(q, kq, ks, vq, vs, tab1, start, chunk)
    want = ca.paged_flash_extend_quant_reference(q, kq, ks, vq, vs, tab1,
                                                 start, chunk)
    torch.cuda.synchronize()
    err = _check("paged_flash_extend_quant bf16 [1,512,32,128] start 1024",
                 got, want, rel=BF16_REL, rows=[chunk_host])
    q_pos = start_host + torch.arange(t, device="cuda")
    mask = cols[None, None, :] <= q_pos[None, :, None]
    for what, mutant in mutants(q, mask, tab1, False):
        _must_fail(f"paged_flash_extend_quant bf16, {what}", mutant, want,
                   rel=BF16_REL, rows=[chunk_host])
    kc, vc = _dequant(kq, ks, tab1, bf16), _dequant(vq, vs, tab1, bf16)
    for what, (kt, vt) in _tile_mutants(kc, vc):
        _must_fail(f"paged_flash_extend_quant bf16, {what}",
                   _plain(torch, q, kt, vt, mask), want, rel=BF16_REL,
                   rows=[chunk_host])
    del kc, vc
    keys = start_host + chunk_host
    visible = sum(start_host + i + 1 for i in range(chunk_host))
    nbytes = (keys * KV * (D + 4) * 2 + 2 * chunk_host * H * D * 2
              + -(-keys // PAGE) * 4 + 8)
    bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
    out.append(dict(
        name="paged_flash_extend_quant", route="cuda",
        source="llmlb_tpu_torch/csrc/paged_extend_quant.cu",
        replaces="llmlb_tpu/ops/pallas_attention.py:885",
        max_abs_err=err,
        ms=cuda_ms(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20),
        ms_cold=cuda_ms_cold(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20),
        dev_ms=profiled_ms(lambda: ca.paged_flash_extend_quant(
            q, kq, ks, vq, vs, tab1, start, chunk), 20, QUANT_EXTEND_MARKS),
        plain_ms=cuda_ms(lambda: ca.paged_flash_extend_quant_reference(
            q, kq, ks, vq, vs, tab1, start, chunk), 3),
        bound_ms=bms, bound_by=by, library_ms=None))
    qf = randn((1, t, H, D), f32)
    _check("paged_flash_extend_quant fp32 [1,512,32,128] start 1024",
           ca.paged_flash_extend_quant(qf, kq, ks, vq, vs, tab1, start, chunk),
           ca.paged_flash_extend_quant_reference(qf, kq, ks, vq, vs, tab1,
                                                 start, chunk),
           atol=FP32_ATOL, rows=[chunk_host])
    return out


VERIFY_K1 = 5  # the verify chunk: the engine's default 4 drafts + 1
# the kernel checks' verify rows: ragged starts and chunks of 1..5, three
# chunks across a page edge (126..130 over 128, 1020..1024 over 1024,
# 2046..2048 over 2048)
VERIFY_STARTS = [156, 126, 1020, 2046, 160, 511, 3000, 0]
VERIFY_CHUNKS = [5, 5, 5, 3, 1, 4, 2, 5]
VERIFY_CTXS = (160, 2048)  # the serve-shape timings: 8 full chunks near these


def _verify_times(torch, name, kernel, plain, marks, kv_bytes, lib=None):
    """The verify-shape times of one attention kernel at each context of
    VERIFY_CTXS: 8 rows, starts ctx-4..ctx+3, full chunks of K+1. `kernel`
    and `plain` take (start, chunk) tensors; `kv_bytes` is one cached
    (token, head) K or V vector's bytes; `lib(start, chunk)` the library
    call's ms, when there is one."""
    out = {}
    for ctx in VERIFY_CTXS:
        starts = [ctx - 4 + i for i in range(SLOTS)]
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        ch = torch.full((SLOTS,), VERIFY_K1, dtype=torch.int32, device="cuda")
        keys = sum(s + VERIFY_K1 for s in starts)
        visible = sum(s + i + 1 for s in starts for i in range(VERIFY_K1))
        nbytes = (keys * KV * kv_bytes * 2 + 2 * SLOTS * VERIFY_K1 * H * D * 2
                  + sum(-(-(s + VERIFY_K1) // PAGE) for s in starts) * 4
                  + SLOTS * 8)
        bms, by = bound_ms(nbytes, 4 * H * D * visible, PEAK_BF16_FLOPS)
        out[ctx] = dict(
            ms=cuda_ms(lambda: kernel(st, ch), 50),
            dev_ms=profiled_ms(lambda: kernel(st, ch), 20, marks),
            plain_ms=cuda_ms(lambda: plain(st, ch), 5),
            bound_ms=bms, bound_by=by,
            library_ms=None if lib is None else lib(st, ch))
        t = out[ctx]
        lib_txt = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
        log(f"  {name} at the verify shape [8,{VERIFY_K1}], ctx {ctx}: "
            f"kernel {t['ms']:.4f} ms warm, device {t['dev_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, library {lib_txt}, bound "
            f"{bms:.5f} ms ({by})")
    return out


def _verify_kernels(torch, gen, rows: list[dict]) -> None:
    """The speculative verify step's four kernels at its shape, held against
    their plain versions: paged_flash_extend, paged_flash_extend_quant and
    flash_extend over 8 rows of K+1 = 5 queries from ragged starts, chunks
    of 1..5, three crossing a page edge (mutants: row 1's keys past the
    edge at 128 left out, and its page after the edge read from the next
    table entry, must be rejected; the dense extend over the gathered rows
    gives the paged extend's bits), and lora_delta over the B * (K+1) rows
    with mixed adapter rows in both modes. Their times at the serve shape
    (8 full chunks near ctx 160 and 2048) are kept on the rows under
    "verify"."""
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import lora_target_dims
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.ops import lora
    from llmlb_tpu_torch.quant import quantize_kv

    bf16 = torch.bfloat16
    by_name = {r["name"]: r for r in rows}
    ppn = CAPACITY // PAGE
    pages_total = SLOTS * ppn + 1
    kp, vp = _pool(torch, gen, pages_total, bf16)
    perm = torch.randperm(pages_total - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(SLOTS, ppn).to(torch.int32).contiguous()
    q = torch.randn((SLOTS, VERIFY_K1, H, D), generator=gen,
                    device="cuda").to(bf16)
    start = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device="cuda")
    chunk = torch.tensor(VERIFY_CHUNKS, dtype=torch.int32, device="cuda")
    shape = (f"[8,{VERIFY_K1},32,128] starts {VERIFY_STARTS} chunks "
             f"{VERIFY_CHUNKS}")
    kc, vc = ca.gather_kv_pages(kp, tables), ca.gather_kv_pages(vp, tables)
    cols = torch.arange(ppn * PAGE, device="cuda")
    q_pos = start[:, None] + torch.arange(VERIFY_K1, device="cuda")[None, :]
    mask = cols[None, None, :] <= q_pos[:, :, None]
    edge = (PAGE, 2 * PAGE, [1])  # row 1's keys past the page edge at 128
    shifted = tables.clone()
    shifted[1, 1] = tables[1, 2]
    rel, defined = BF16_REL, VERIFY_CHUNKS

    got = ca.paged_flash_extend(q, kp, vp, tables, start, chunk)
    want = ca.paged_flash_extend_reference(q, kp, vp, tables, start, chunk)
    torch.cuda.synchronize()
    err = _check(f"paged_flash_extend bf16 verify {shape}", got, want,
                 rel=rel, rows=defined)
    if not torch.equal(_plain(torch, q, kc, vc, mask), want):
        raise AssertionError("paged_flash_extend verify: the mutants' mask is "
                             "not the plain version's")
    _must_fail("paged_flash_extend bf16 verify, row 1's keys past the page "
               "edge at 128 dropped", _plain(torch, q, kc, vc, mask, edge),
               want, rel=rel, rows=defined)
    _must_fail("paged_flash_extend bf16 verify, row 1's page after the edge "
               "read from the next table entry",
               ca.paged_flash_extend_reference(q, kp, vp, shifted, start,
                                               chunk), want, rel=rel,
               rows=defined)
    by_name["paged_flash_extend"]["verify"] = dict(max_abs_err=err, **{
        f"ctx{c}": t for c, t in _verify_times(
            torch, "paged_flash_extend",
            lambda s, c: ca.paged_flash_extend(q, kp, vp, tables, s, c),
            lambda s, c: ca.paged_flash_extend_reference(q, kp, vp, tables,
                                                         s, c),
            PAGED_EXTEND_MARKS, D * 2).items()})

    dgot = ca.flash_extend(q, kc, vc, start, chunk)
    dwant = ca.flash_extend_reference(q, kc, vc, start, chunk)
    torch.cuda.synchronize()
    err = _check(f"flash_extend bf16 verify {shape}", dgot, dwant, rel=rel,
                 rows=defined)
    _must_fail("flash_extend bf16 verify, row 1's keys past 128 dropped",
               _plain(torch, q, kc, vc, mask, edge), dwant, rel=rel,
               rows=defined)
    if not all(torch.equal(dgot[b, :n], got[b, :n])
               for b, n in enumerate(defined)):
        raise AssertionError("flash_extend over the gathered rows does not "
                             "give paged_flash_extend's bits at the verify "
                             "shape")
    log("  flash_extend over the gathered rows: paged_flash_extend's bits at "
        "the verify shape")

    def dense_lib(s, c):
        pos = s[:, None] + torch.arange(VERIFY_K1, device="cuda")[None, :]
        m = cols[None, None, :] <= pos[:, :, None]
        return _sdpa_ms(torch, q, kc, vc, m)[0]

    by_name["flash_extend"]["verify"] = dict(max_abs_err=err, **{
        f"ctx{c}": t for c, t in _verify_times(
            torch, "flash_extend",
            lambda s, c: ca.flash_extend(q, kc, vc, s, c),
            lambda s, c: ca.flash_extend_reference(q, kc, vc, s, c),
            ("flash_extend_tc_kernel",), D * 2, dense_lib).items()})
    del kc, vc, dgot, dwant

    qk, qv = quantize_kv(kp), quantize_kv(vp)
    del kp, vp
    qgot = ca.paged_flash_extend_quant(q, *qk, *qv, tables, start, chunk)
    qwant = ca.paged_flash_extend_quant_reference(q, *qk, *qv, tables, start,
                                                  chunk)
    torch.cuda.synchronize()
    err = _check(f"paged_flash_extend_quant bf16 verify {shape}", qgot, qwant,
                 rel=rel, rows=defined)
    dk, dv = _dequant(*qk, tables, bf16), _dequant(*qv, tables, bf16)
    _must_fail("paged_flash_extend_quant bf16 verify, row 1's keys past the "
               "page edge at 128 dropped",
               _plain(torch, q, dk, dv, mask, edge), qwant, rel=rel,
               rows=defined)
    del dk, dv
    _must_fail("paged_flash_extend_quant bf16 verify, row 1's page after the "
               "edge read from the next table entry",
               ca.paged_flash_extend_quant_reference(q, *qk, *qv, shifted,
                                                     start, chunk), qwant,
               rel=rel, rows=defined)
    by_name["paged_flash_extend_quant"]["verify"] = dict(max_abs_err=err, **{
        f"ctx{c}": t for c, t in _verify_times(
            torch, "paged_flash_extend_quant",
            lambda s, c: ca.paged_flash_extend_quant(q, *qk, *qv, tables, s,
                                                     c),
            lambda s, c: ca.paged_flash_extend_quant_reference(
                q, *qk, *qv, tables, s, c),
            QUANT_EXTEND_MARKS, D + 4).items()})
    del qk, qv, q

    # lora_delta over the verify's B * (K+1) rows, wg's shape, rank 16
    cfg = get_preset("llama-3-8b")
    in_dim, out_dim = lora_target_dims(cfg, ("wg",))["wg"]
    rank, n_rows = 16, 9
    idx_host = [0, 3, 1, 0, 8, 2, 2, 5]
    idx = torch.tensor(idx_host, dtype=torch.int32, device="cuda")
    a = torch.randn((n_rows, in_dim, rank), generator=gen,
                    device="cuda") * in_dim**-0.5
    b = torch.randn((n_rows, rank, out_dim), generator=gen,
                    device="cuda") * rank**-0.5
    a[0] = 0.0
    b[0] = 0.0
    a, b = a.to(bf16).contiguous(), b.to(bf16).contiguous()
    x = torch.randn((SLOTS, VERIFY_K1, in_dim), generator=gen,
                    device="cuda").to(bf16)
    y = torch.randn((SLOTS, VERIFY_K1, out_dim), generator=gen,
                    device="cuda").to(bf16)
    tag = (f"lora_delta bf16 wg x [8,{VERIFY_K1},{in_dim}] -> {out_dim} "
           f"(the verify's rows, adapters {idx_host})")
    lgot = lora.lora_delta(x, a, b, idx)
    lwant = lora.lora_delta_reference(x, a, b, idx)
    fused = lora.lora_delta_add(y.clone(), x, a, b, idx)
    torch.cuda.synchronize()
    err = _check(f"{tag} mode (a)", lgot, lwant, rel=LORA_REL)
    if not torch.equal(fused, y + lgot.to(bf16)):
        raise AssertionError(f"{tag}: mode (b) is not y + delta.to(dtype)")
    _must_fail(f"{tag}, row i reading adapter idx_i + 1",
               lora.lora_delta_reference(x, a, b, (idx + 1) % n_rows), lwant,
               rel=LORA_REL)
    distinct = len(set(idx_host))
    nbytes = (x.numel() * 2 + distinct * rank * (in_dim + out_dim) * 2
              + 2 * y.numel() * 2 + SLOTS * 4)
    bms, bby = bound_ms(nbytes, 2 * SLOTS * VERIFY_K1 * rank
                        * (in_dim + out_dim), PEAK_BF16_FLOPS)
    t = dict(max_abs_err=err,
             ms=cuda_ms(lambda: lora.lora_delta_add(y, x, a, b, idx), 50),
             dev_ms=profiled_ms(lambda: lora.lora_delta_add(y, x, a, b, idx),
                                20, ("bgmv_cluster_kernel",)),
             plain_ms=cuda_ms(lambda: y + lora.lora_delta_reference(
                 x, a, b, idx).to(bf16), 5),
             bound_ms=bms, bound_by=bby, library_ms=None)
    by_name["lora_delta"]["verify"] = t
    log(f"  {tag} mode (b): kernel {t['ms']:.4f} ms warm, device "
        f"{t['dev_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{bms:.5f} ms ({bby})")


def phase_unembed() -> None:
    """The Llama-3-8B vocab projection on the card, untied and tied (the
    head a transposed view): bf16 operands, fp32 logits held against the
    fp32 product of the same bf16 values, and the same argmax per row."""
    import dataclasses

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.ops.norms import rms_norm

    cfg = get_preset("llama-3-8b")
    e, vocab = cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((SLOTS, e), generator=gen, device="cuda").to(cfg.dtype)
    head = (torch.randn((e, vocab), generator=gen, device="cuda")
            * e**-0.5).to(cfg.dtype)
    ln = torch.ones(e, dtype=cfg.dtype, device="cuda")
    want = rms_norm(x, ln, cfg.rms_eps).float() @ head.float()
    rounded = (want.to(cfg.dtype).float() - want).abs().max().item()
    for name, c, params in (
            ("untied", cfg, {"ln_final": ln, "lm_head": head}),
            ("tied", dataclasses.replace(cfg, tie_word_embeddings=True),
             {"ln_final": ln, "embed": head.T.contiguous()})):
        got = llama._unembed(c, params, x)
        err = (got - want).abs().max().item()
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        log(f"  unembed llama-3-8b {name} [8,4096]x[4096,128256] "
            f"{got.dtype}: max_abs_err {err:.3e} (atol {UNEMBED_ATOL:g}; "
            f"logits rounded to bf16 would be off by {rounded:.3e}); "
            f"argmax {'equal' if same else 'DIFFERS'}")
        if got.dtype != torch.float32 or not err <= UNEMBED_ATOL or not same:
            raise AssertionError(f"unembed {name}: fp32 logits disagree")
        del got, params
    del x, head, want


def phase_model_entry_points() -> None:
    """The serving entry points at debug size: card (kernels) against CPU
    (plain path), fp32 logits within FP32_ATOL * 10 (two layers). The three
    paged ones with model-dtype pools and weights, with int8 pools and
    weights, with an adapter pool and mixed `lora_idx`, and with int8
    weights and adapters; the three dense-slot ones, with and without
    adapters."""
    import tempfile

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import LoraManager, save_adapter
    from llmlb_tpu_torch.models import llama
    from llmlb_tpu_torch.quant import quantize_params

    cfg = get_preset("debug-tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tables = torch.tensor([[3, 7, 1, 10], [5, 2, 9, 11]], dtype=torch.int32)
    rng = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 512, (2, 32), generator=rng)
    lens = torch.tensor([5, 21], dtype=torch.int32)
    chunk = torch.randint(0, 512, (2, 16), generator=rng)
    chunk_lens = torch.tensor([16, 3], dtype=torch.int32)
    toks = torch.randint(0, 512, (2,), generator=rng)
    slots = torch.tensor([2, 0], dtype=torch.int64)

    # an adapter pool with two adapters in rows 1 and 2 (row 0 identity)
    with tempfile.TemporaryDirectory() as lora_dir:
        save_adapter(lora_dir, "acme", cfg, rank=4)
        save_adapter(lora_dir, "beta", cfg, rank=8,
                     targets=("wq", "wk", "wv", "wo", "wg", "wu", "wd"))
        mgr = LoraManager(cfg, lora_dir=lora_dir, max_adapters=2, rank_cap=8)
        pool = mgr.init_pool_leaves(cfg.dtype, "cpu")
        mgr.attach(pool)
        for i, name in enumerate(("acme", "beta")):
            mgr.acquire(name, f"r{i}")
    lora_idx = torch.tensor([2, 1], dtype=torch.int32)

    def paged(dev, p, quantized, lidx):
        tb = tables.to(dev)
        li = None if lidx is None else lidx.to(dev)
        ck, cv = llama.init_kv_pages(cfg, 12, 16, dev, quantized=quantized)
        out = [llama.prefill_into_pages(p, cfg, ids.to(dev), lens.to(dev), tb,
                                        ck, cv, lora_idx=li)[0]]
        out.append(llama.prefill_extend_pages(
            p, cfg, chunk.to(dev), chunk_lens.to(dev), lens.to(dev), tb,
            ck, cv, lora_idx=li)[0])
        seq = (lens + chunk_lens).to(dev)
        for _ in range(2):
            out.append(llama.decode_step_paged(p, cfg, toks.to(dev), seq, ck,
                                               cv, tb, window=64,
                                               lora_idx=li)[0])
            seq = seq + 1
        return [o.cpu() for o in out]

    def dense(dev, p, _quantized, lidx):
        # 3 slots of 320 cells: the prompts land in slots 2 and 0; decode
        # runs over all 3 rows (row 1 idle) with a 256-cell window
        li = None if lidx is None else lidx.to(dev)
        ck, cv = llama.init_kv_cache(cfg, 3, 320, dev)
        out = [llama.prefill_into_slots(p, cfg, ids.to(dev), lens.to(dev),
                                        slots.to(dev), ck, cv,
                                        lora_idx=li)[0]]
        out.append(llama.prefill_extend_slots(
            p, cfg, chunk.to(dev), chunk_lens.to(dev), lens.to(dev),
            slots.to(dev), ck, cv, lora_idx=li)[0])
        seq = torch.zeros(3, dtype=torch.int32)
        seq[slots] = lens + chunk_lens
        rows_li = None
        if li is not None:
            rows_li = torch.zeros(3, dtype=torch.int32)
            rows_li[slots] = lidx
            rows_li = rows_li.to(dev)
        last = torch.zeros(3, dtype=torch.int64)
        last[slots] = toks
        seq = seq.to(dev)
        for _ in range(2):
            logits = llama.decode_step(p, cfg, last.to(dev), seq, ck, cv,
                                       window=256, lora_idx=rows_li)[0]
            out.append(logits[slots.to(dev)])
            seq = seq + 1
        return [o.cpu() for o in out]

    cases = (("paged", paged, False, None, cfg.dtype),
             ("paged", paged, True, None, "int8 pools and weights"),
             ("paged", paged, False, lora_idx, "adapters, lora_idx [2, 1]"),
             ("paged", paged, "weights", lora_idx,
              "int8 weights + adapters"),
             ("dense", dense, False, None, cfg.dtype),
             ("dense", dense, False, lora_idx, "adapters, lora_idx [2, 1]"))
    for layout, fn, quantized, lidx, tag in cases:
        p = quantize_params(params) if quantized else params
        if lidx is not None:
            p = {**p, **pool}
        gp = {k: v.cuda() for k, v in p.items()}
        names = ((f"prefill_into_{'pages' if layout == 'paged' else 'slots'}",
                  f"prefill_extend_{'pages' if layout == 'paged' else 'slots'}")
                 + (("decode_step_paged#1", "decode_step_paged#2")
                    if layout == "paged" else ("decode_step#1",
                                               "decode_step#2")))
        pools_int8 = quantized is True
        for name, g, c in zip(names, fn("cuda", gp, pools_int8, lidx),
                              fn("cpu", p, pools_int8, lidx)):
            err = (g - c).abs().max().item()
            log(f"  model {name} debug-tiny ({tag}) fp32 logits card vs cpu: "
                f"max_abs_err {err:.3e}")
            if not (err <= FP32_ATOL * 10 and torch.isfinite(g).all()):
                raise AssertionError(f"{name}: card logits disagree with the "
                                     f"plain path (max_abs_err {err:.3e})")
    _moe_entry_points()


def _moe_entry_points() -> None:
    """The eight Mixtral entry points at debug-moe-tiny (4 experts, top-2),
    card against CPU, fp32 logits within FP32_ATOL * 10: both regimes (a
    prefill and an extend of 2 x 16 tokens, capacity dispatch; of 1 x 16,
    exact), a verify of 3 positions and two decode steps (exact); paged
    with model-dtype params, int8 weights and int8 pools, and an attention
    adapter pool with mixed `lora_idx`; the dense-slot ones with and
    without adapters."""
    import tempfile

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import LoraManager, save_adapter
    from llmlb_tpu_torch.models import mixtral
    from llmlb_tpu_torch.quant import quantize_params

    cfg = get_preset("debug-moe-tiny")
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with tempfile.TemporaryDirectory() as lora_dir:
        save_adapter(lora_dir, "acme", cfg, rank=4)
        save_adapter(lora_dir, "beta", cfg, rank=8)
        mgr = LoraManager(cfg, lora_dir=lora_dir, max_adapters=2, rank_cap=8)
        pool = mgr.init_pool_leaves(cfg.dtype, "cpu")
        mgr.attach(pool)
        for i, name in enumerate(("acme", "beta")):
            mgr.acquire(name, f"r{i}")
    if mgr.targets != ("wq", "wk", "wv", "wo"):
        raise AssertionError(f"MoE adapter pools over {mgr.targets}")
    rng = torch.Generator().manual_seed(2)
    tables = torch.tensor([[3, 7, 1, 10], [5, 2, 9, 11]], dtype=torch.int32)
    lens = torch.tensor([5, 13], dtype=torch.int32)
    chunk_lens = torch.tensor([10, 3], dtype=torch.int32)
    slots = torch.tensor([2, 0], dtype=torch.int64)

    def run(dev, p, quantized, lidx, rows, layout):
        ids = torch.randint(0, 512, (rows, 16), generator=rng)
        chunk = torch.randint(0, 512, (rows, 16), generator=rng)
        ver = torch.randint(0, 512, (rows, 3), generator=rng)
        toks = torch.randint(0, 512, (rows,), generator=rng)
        li = None if lidx is None else lidx[:rows].to(dev)
        ln, cl = lens[:rows].to(dev), chunk_lens[:rows].to(dev)
        vl = torch.full((rows,), 3, dtype=torch.int32, device=dev)
        out = []
        if layout == "paged":
            tb = tables[:rows].to(dev)
            ck, cv = mixtral.init_kv_pages(cfg, 12, 8, dev,
                                           quantized=quantized)
            out.append(mixtral.prefill_into_pages(
                p, cfg, ids.to(dev), ln, tb, ck, cv, lora_idx=li)[0])
            out.append(mixtral.prefill_extend_pages(
                p, cfg, chunk.to(dev), cl, ln, tb, ck, cv, lora_idx=li)[0])
            seq = ln + cl
            out.append(mixtral.verify_step_paged(
                p, cfg, ver.to(dev), vl, seq, tb, ck, cv, window=32,
                lora_idx=li)[0])
            seq = seq + 3
            for _ in range(2):
                out.append(mixtral.decode_step_paged(
                    p, cfg, toks.to(dev), seq, ck, cv, tb, window=32,
                    lora_idx=li)[0])
                seq = seq + 1
            return [o.cpu() for o in out]
        # dense: 3 slots of 48 cells; verify and decode run every slot
        sl = slots[:rows].to(dev)
        ck, cv = mixtral.init_kv_cache(cfg, 3, 48, dev)
        out.append(mixtral.prefill_into_slots(
            p, cfg, ids.to(dev), ln, sl, ck, cv, lora_idx=li)[0])
        out.append(mixtral.prefill_extend_slots(
            p, cfg, chunk.to(dev), cl, ln, sl, ck, cv, lora_idx=li)[0])
        seq = torch.zeros(3, dtype=torch.int32)
        seq[slots[:rows]] = lens[:rows] + chunk_lens[:rows]
        rows_li = None
        if lidx is not None:
            rows_li = torch.zeros(3, dtype=torch.int32)
            rows_li[slots[:rows]] = lidx[:rows]
            rows_li = rows_li.to(dev)
        all_ver = torch.zeros((3, 3), dtype=torch.int64)
        all_ver[slots[:rows]] = ver
        out.append(mixtral.verify_step(
            p, cfg, all_ver.to(dev), torch.full((3,), 3, dtype=torch.int32,
                                                device=dev),
            seq.to(dev), None, ck, cv, window=48,
            lora_idx=rows_li)[0][sl])
        last = torch.zeros(3, dtype=torch.int64)
        last[slots[:rows]] = toks
        out.append(mixtral.decode_step(
            p, cfg, last.to(dev), (seq + 3).to(dev), ck, cv, window=48,
            lora_idx=rows_li)[0][sl])
        return [o.cpu() for o in out]

    lora_idx = torch.tensor([2, 1], dtype=torch.int32)
    cases = (("paged", False, None, "fp32"),
             ("paged", True, None, "int8 weights and pools"),
             ("paged", False, lora_idx, "attention adapters [2, 1]"),
             ("dense", False, None, "fp32"),
             ("dense", False, lora_idx, "attention adapters [2, 1]"))
    names = {"paged": ("prefill_into_pages", "prefill_extend_pages",
                       "verify_step_paged", "decode_step_paged#1",
                       "decode_step_paged#2"),
             "dense": ("prefill_into_slots", "prefill_extend_slots",
                       "verify_step", "decode_step")}
    for layout, quantized, lidx, tag in cases:
        p = quantize_params(params) if quantized else params
        if lidx is not None:
            p = {**p, **pool}
        gp = {k: v.cuda() for k, v in p.items()}
        for rows in (2, 1):
            regime = "capacity" if rows * 16 > 4 * cfg.num_experts else "exact"
            state = rng.get_state()
            got = run("cuda", gp, quantized, lidx, rows, layout)
            rng.set_state(state)
            want = run("cpu", p, quantized, lidx, rows, layout)
            for name, g, c in zip(names[layout], got, want):
                err = (g - c).abs().max().item()
                log(f"  model mixtral.{name} debug-moe-tiny ({tag}; {rows} "
                    f"row(s) x 16: prefill and extend {regime}) fp32 logits "
                    f"card vs cpu: max_abs_err {err:.3e}")
                if not (err <= FP32_ATOL * 10 and torch.isfinite(g).all()):
                    raise AssertionError(
                        f"mixtral.{name}: card logits disagree with the "
                        f"plain path (max_abs_err {err:.3e})")


def _post(url: str, body: dict, timeout: float = 600,
          headers: dict | None = None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _chat(base: str, content: str, max_tokens: int, stream: bool,
          model: str = "llama-3-8b", lora: str | None = None,
          headers: dict | None = None) -> dict:
    """One greedy chat request; returns {text, usage, finish, model} after
    checking the response shape."""
    body = {"model": model, "temperature": 0, "max_tokens": max_tokens,
            "stream": stream,
            "messages": [{"role": "user", "content": content}]}
    if lora is not None:
        body["lora"] = lora
    with _post(base + "/v1/chat/completions", body,
               headers=headers) as resp:
        if not stream:
            out = json.loads(resp.read())
            assert out["object"] == "chat.completion", out
            choice = out["choices"][0]
            return {"text": choice["message"]["content"], "usage": out["usage"],
                    "finish": choice["finish_reason"], "model": out["model"]}
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert lines[-1] == "data: [DONE]", lines[-3:]
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    usage = chunks[-1]["usage"]
    finish = chunks[-2]["choices"][0]["finish_reason"]
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks[:-1] if c["choices"])
    return {"text": text, "usage": usage, "finish": finish,
            "model": chunks[0]["model"]}


def _timed_core_request(core, prompt: list[int], max_tokens: int,
                        lora: str | None = None, **sampling):
    """Submit straight to the serving core (greedy unless `sampling` says
    otherwise); returns (ids, ttft_s, decode tokens/s of this request)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    req = core.submit(Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=max_tokens, lora=lora, **sampling)))
    ids, stamps = [], []
    while True:
        kind, value = req.events.get(timeout=600)
        if kind == "token":
            ids.append(int(value))
            stamps.append(time.monotonic())
        elif kind == "done":
            break
        else:
            raise RuntimeError(f"engine error: {value}")
    ttft = stamps[0] - req.submitted_at
    rate = (len(ids) - 1) / (stamps[-1] - stamps[0]) if len(ids) > 1 else 0.0
    return ids, ttft, rate


def _concurrent(fns: list) -> list:
    """Run the zero-argument callables on threads at once; their results in
    order, or the first error raised."""
    results: dict[int, object] = {}
    errors: list[BaseException] = []

    def worker(i: int) -> None:
        try:
            results[i] = fns[i]()
        except BaseException as e:  # collected and re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or len(results) != len(fns):
        raise RuntimeError(f"concurrent requests failed: {errors!r}")
    return [results[i] for i in range(len(fns))]


def _shared(a: list[int], b: list[int]) -> int:
    """Length of the common prefix of two token lists."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# The kernels each serving path must launch, and those it must not.
BF16_PATH = ("flash_prefill", "paged_flash_decode", "paged_flash_extend")
INT8_PATH = ("flash_prefill", "paged_flash_decode_quant",
             "paged_flash_extend_quant")
LORA_PATH = BF16_PATH + ("lora_delta",)
# the kernels a decode step launches (a landed resume launches only these)
DECODE_KERNELS = ("paged_flash_decode", "paged_flash_decode_quant",
                  "flash_decode")
DENSE_PATH = ("flash_prefill", "flash_decode", "flash_extend")
# Adapters of the LoRA phase: (name, rank, targets). Their factors are
# drawn at scale 0.03: the delta of a projection is then ~0.1-0.3 of the
# base output at Llama-3-8B's widths (0.25, the default, is sized for
# debug-tiny and would swamp the base model).
ADAPTERS = (("acme", 8, ("wq", "wk", "wv", "wo")),
            ("beta", 16, ("wq", "wk", "wv", "wo", "wg", "wu", "wd")))
ADAPTER_SCALE = 0.03
# greedy tokens of the long prompt's timed requests
LONG_TOKENS = 16


# Ops of the model whose row-0 outputs _first_difference compares, and the
# label each gets (the projections are labelled by their weight's name).
TRACED_OPS = {"rms_norm": "norm", "_proj": None, "apply_rope": "rope",
              "gqa_attention_prefill": "attention",
              "gqa_attention_decode": "attention",
              "paged_attention_decode": "attention", "_unembed": "unembed"}
# the prefill group sizes the batch_invariance phase holds row 0 across
GROUPS = (1, 2, 4, 8)


def _traced(run) -> list[tuple[str, object]]:
    """Run `run()` with the model's ops in TRACED_OPS wrapped to record
    (where, a copy of batch row 0 of the op's output), in call order.
    `where` names the entry-point call (counted by its unembed), the layer
    (counted by its two norms, ln_attn and ln_mlp) and the op."""
    from llmlb_tpu_torch.models import llama

    records = []
    state = {"call": 0, "norms": 0, "unembed": False}
    saved = {name: getattr(llama, name) for name in TRACED_OPS}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            if name == "_unembed":
                state["unembed"] = True
            try:
                out = fn(*args, **kwargs)
            finally:
                state["unembed"] = False
            tag = args[1] if name == "_proj" else TRACED_OPS[name]
            if name == "rms_norm" and not state["unembed"]:
                state["norms"] += 1
                tag = ("ln_attn", "ln_mlp")[(state["norms"] - 1) % 2]
            elif name == "rms_norm":
                tag = "ln_final"
            where = (f"entry-point call {state['call']}, layer "
                     f"{(state['norms'] - 1) // 2}, {tag}")
            if name in ("_unembed", "rms_norm") and tag in ("unembed",
                                                             "ln_final"):
                where = f"entry-point call {state['call']}, {tag}"
            records.append((where, out[0].detach().clone()))
            if name == "_unembed":
                state["call"] += 1
                state["norms"] = 0
            return out
        return inner

    try:
        for name, fn in saved.items():
            setattr(llama, name, wrap(name, fn))
        run()
    finally:
        for name, fn in saved.items():
            setattr(llama, name, fn)
    return records


def _first_difference(run_a, run_b) -> str:
    """The first op (in call order) whose row-0 output differs bit for bit
    between two runs of the model's entry points, as _traced records them."""
    import torch

    a, b = _traced(run_a), _traced(run_b)
    for (wa, xa), (wb, xb) in zip(a, b):
        if wa != wb:
            return f"the runs call different ops: {wa} / {wb}"
        if xa.shape != xb.shape:
            return f"{wa}: shapes {tuple(xa.shape)} / {tuple(xb.shape)}"
        if not torch.equal(xa, xb):
            diff = (xa.float() - xb.float()).abs().max().item()
            return (f"{wa}: row 0 first differs here (max |diff| {diff:.3e}, "
                    f"{int((xa != xb).sum())} of {xa.numel()} elements)")
    if len(a) != len(b):
        return f"the runs call {len(a)} and {len(b)} traced ops"
    return "no traced op differs in row 0 (the difference is elsewhere)"


def phase_batch_invariance(core, prompts: list[list[int]], label: str,
                           lora_rows: list[int] | None) -> None:
    """C1: row 0's prefill logits do not depend on the group it is prefilled
    with. The serve phases' timed prompt (124 tokens, bucket 128) goes
    (prompts[0]) goes through the entry point `_prefill_group` calls
    (prefill_into_pages, or prefill_into_slots for the dense layout) alone
    and as row 0 of groups of 2, 4 and 8 whose other rows are other prompts
    of the same bucket (prompts[1:]);
    its last-position logits must be equal bit for bit. The KV lands in the
    trash page (paged) or the idle slots (dense): the engine is idle. With
    `lora_rows`, row i takes adapter pool row lora_rows[i]. On a difference
    the first op whose row 0 differs is reported."""
    import numpy as np
    import torch

    from llmlb_tpu_torch.models import llama

    bucket = 128
    ids_all = np.zeros((max(GROUPS), bucket), np.int64)
    lens_all = np.zeros((max(GROUPS),), np.int32)
    for i, p in enumerate(prompts[:max(GROUPS)]):
        if not 64 < len(p) <= bucket:
            raise AssertionError(f"prompt {i} has {len(p)} tokens, not in the "
                                 f"{bucket} bucket")
        ids_all[i, :len(p)] = p
        lens_all[i] = len(p)

    def run(g):
        ids = torch.from_numpy(ids_all[:g]).cuda()
        lens = torch.from_numpy(lens_all[:g]).cuda()
        lidx = (None if lora_rows is None else
                torch.tensor(lora_rows[:g], dtype=torch.int32, device="cuda"))
        if core.page_pool is not None:
            tables = torch.zeros((g, core._block_tables.shape[1]),
                                 dtype=torch.int32, device="cuda")
            return llama.prefill_into_pages(core.params, core.cfg, ids, lens,
                                            tables, core.cache_k, core.cache_v,
                                            lora_idx=lidx)[0]
        slots = torch.arange(g, device="cuda")
        return llama.prefill_into_slots(core.params, core.cfg, ids, lens,
                                        slots, core.cache_k, core.cache_v,
                                        lora_idx=lidx)[0]

    solo = run(1)
    for g in GROUPS[1:]:
        grouped = run(g)
        torch.cuda.synchronize()
        if not torch.equal(grouped[0], solo[0]):
            where = _first_difference(lambda: run(1), lambda: run(g))
            raise AssertionError(
                f"batch_invariance {label}: row 0's logits alone and in a "
                f"group of {g} differ (max |diff| "
                f"{(grouped[0] - solo[0]).abs().max().item():.3e}); {where}")
    log(f"batch_invariance {label}: row 0's prefill logits bit-identical "
        f"alone and in groups of {list(GROUPS[1:])}"
        + ("" if lora_rows is None else
           f" (adapter pool rows {lora_rows[:max(GROUPS)]})"))


def _dense_paged_report(core, prompt: list[int]) -> str:
    """Why the dense engine's greedy stream parts from the paged one's: the
    timed prompt's prefill and first decode step through the dense entry
    points (the dense engine's idle slot 0) and through the paged ones (a
    temporary 3-page pool: the trash page and the row's two), with the same
    weights, traced op by op on row 0."""
    import torch

    from llmlb_tpu_torch.models import llama

    cfg, params = core.cfg, core.params
    n = len(prompt)
    ids = torch.zeros((1, 128), dtype=torch.int64, device="cuda")
    ids[0, :n] = torch.tensor(prompt, device="cuda")
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    ck, cv = llama.init_kv_pages(cfg, 3, PAGE, "cuda")
    tables = torch.zeros((SLOTS, 2), dtype=torch.int32, device="cuda")
    tables[0] = torch.tensor([1, 2])
    seq = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    seq[0] = n

    def paged():
        logits = llama.prefill_into_pages(params, cfg, ids, lens, tables[:1],
                                          ck, cv)[0]
        toks = torch.zeros(SLOTS, dtype=torch.int64, device="cuda")
        toks[0] = logits[0].argmax()
        llama.decode_step_paged(params, cfg, toks, seq, ck, cv, tables,
                                window=SERVE_WINDOW)

    def dense():
        logits = llama.prefill_into_slots(
            params, cfg, ids, lens, torch.zeros(1, dtype=torch.int64,
                                                device="cuda"),
            core.cache_k, core.cache_v)[0]
        toks = torch.zeros(SLOTS, dtype=torch.int64, device="cuda")
        toks[0] = logits[0].argmax()
        llama.decode_step(params, cfg, toks, seq, core.cache_k, core.cache_v,
                          window=SERVE_WINDOW)

    return _first_difference(paged, dense)


# The graph = eager workload: (sampling, adapter) of each of its rows, run
# together; the adapters apply in the LoRA phase (its mixed batch).
GRAPH_ROWS = ((dict(), None), (dict(), "acme"),
              (dict(temperature=0.8, top_p=0.95, seed=1234), "beta"),
              (dict(temperature=1.0, top_k=40, seed=77), "acme"))
GRAPH_TOKENS = 48


def _graph_counters(core, label: str, dev: dict) -> dict:
    """The decode graphs of the serving core: every burst after a key's
    first is one replay. Logs what the graphs cost: capture seconds, the
    pool's bytes, and per key the port's kernels and the graph's nodes per
    replay."""
    st = core.stats()
    info = core.decode_graph_info()
    if not info["enabled"]:
        raise AssertionError(f"serve {label}: decode graphs are off on the "
                             "card")
    if st.decode_graph_replays < 1 or st.decode_graphs < 1:
        raise AssertionError(f"serve {label}: no decode burst replayed a "
                             f"graph ({st})")
    if st.decode_eager_bursts > st.decode_graphs:
        raise AssertionError(
            f"serve {label}: {st.decode_eager_bursts} eager bursts for "
            f"{st.decode_graphs} captured keys")
    if st.decode_graph_replays + st.decode_eager_bursts != core.decode_bursts:
        raise AssertionError(f"serve {label}: bursts do not add up ({st}, "
                             f"{core.decode_bursts} bursts)")
    log(f"serve {label} [{dev['smi']}]: decode graphs: "
        f"{st.decode_graph_replays} replays, {st.decode_eager_bursts} eager "
        f"bursts (one warm-up a key), {st.decode_graphs} keys captured in "
        f"{info['capture_s']:.3f} s, pool {info['pool_bytes'] / 2**20:.1f} "
        f"MiB (reserved memory after minus before each capture); per key "
        + "; ".join(f"{k}: nodes {v['nodes']}, port kernels {v['launches']}, "
                    f"capture {v['capture_s']:.3f} s, pool "
                    f"{v['pool_bytes'] / 2**20:.1f} MiB"
                    for k, v in info["keys"].items()))
    return info


def _graph_vs_eager(core, prompt: list[int], label: str, lora: bool,
                    dev: dict, core_kwargs: dict) -> dict:
    """On the same card and the same weights, an engine with
    decode_graphs=False: the GRAPH_ROWS workload (greedy and seeded rows;
    with adapters the mixed batch) gives the same tokens as on the serving
    core, whose bursts replay graphs; two identical unseeded requests at
    temperature 1 draw different tokens on the serving core whenever they
    do on the eager one; and the eager engine's single-stream decode rate."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    eager = EngineCore(core.cfg, core.params, device="cuda", seed=0,
                       num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                       decode_graphs=False, prefix_cache=False, **core_kwargs)
    eager.start()
    try:
        def workload(c):
            return _concurrent([
                lambda i=i, sp=sp, name=name: _timed_core_request(
                    c, _fresh_head(prompt, 16 + i), GRAPH_TOKENS,
                    name if lora else None, **sp)[0]
                for i, (sp, name) in enumerate(GRAPH_ROWS)])

        def unseeded_twice(c):
            return [_timed_core_request(c, prompt, 32, temperature=1.0)[0]
                    for _ in range(2)]

        replays = core.stats().decode_graph_replays
        graph_ids, eager_ids = workload(core), workload(eager)
        replayed = core.stats().decode_graph_replays - replays
        same = [_shared(a, b) for a, b in zip(graph_ids, eager_ids)]
        log(f"serve {label}: graph = eager: rows (greedy, greedy, seeded, "
            f"seeded){' with adapters [None, acme, beta, acme]' if lora else ''}"
            f" share {same} of {GRAPH_TOKENS} tokens; the graph core "
            f"replayed {replayed} bursts for them, the eager core "
            f"{eager.stats().decode_graph_replays}")
        if graph_ids != eager_ids:
            raise AssertionError(f"serve {label}: graph and eager bursts give "
                                 f"different tokens (shared {same})")
        if replayed < 1 or eager.stats().decode_graph_replays:
            raise AssertionError(f"serve {label}: the comparison did not set "
                                 "replays against eager bursts")
        g1, g2 = unseeded_twice(core)
        e1, e2 = unseeded_twice(eager)
        log(f"serve {label}: unseeded temperature-1 twice: the graph core's "
            f"draws share {_shared(g1, g2)} of 32 tokens, the eager core's "
            f"{_shared(e1, e2)}")
        if e1 != e2 and g1 == g2:
            raise AssertionError(f"serve {label}: replays repeat their "
                                 "unseeded noise")
        rates = [_timed_core_request(eager, prompt, 64)[2] for _ in range(2)]
        log(f"serve {label} [{dev['smi']}]: eager bursts (decode_graphs="
            f"False): decode {max(rates):.1f} tok/s")
        return {"decode_tok_s_1_eager": max(rates)}
    finally:
        eager.stop()
        del eager
        gc.collect()
        torch.cuda.empty_cache()


# The prefix block of each serve phase: a head of PREFIX_HEAD tokens (8
# pages of 128) shared by a donor and PREFIX_ROWS requests, each with a
# tail of its own, PREFIX_TOKENS greedy tokens each.
PREFIX_HEAD, PREFIX_TAIL, PREFIX_ROWS, PREFIX_TOKENS = 1024, 100, 8, 32
# the rows' adapters in the LoRA phase, and the donors' (one a namespace)
PREFIX_LORA_ROWS = (None, "acme", "beta", None, "acme", "beta", None, "acme")
PREFIX_LORA_DONORS = (None, "acme", "beta")


def _fresh_head(prompt: list[int], i: int) -> list[int]:
    """The timed prompt with its first content token (after the 9-token
    "<|user|>\\n" tag) changed: a prompt of the same length and bucket that
    shares no cacheable head with it, so it is a prefix-cache miss."""
    return prompt[:9] + [0x41 + i] + prompt[10:]


def _first_word(text: str, j: int) -> str:
    """`text` with its first word ("w0") replaced by "v<j>": the long
    prompt at the same length with a head of its own."""
    return f"v{j}" + text[2:]


class _LogitSpy:
    """Keeps the first-token logits of every request the core activates,
    by (prompt, adapter), in order: wraps the core's _activate_group as an
    instance attribute until close()."""

    def __init__(self, core):
        self.core, self.logits = core, {}
        activate = core._activate_group

        def spy(group, slot_ids, lens, logits):
            for row, (_slot, request, _n) in enumerate(group):
                key = (tuple(request.prompt_ids), request.sampling.lora)
                self.logits.setdefault(key, []).append(
                    logits[row].float().clone())
            activate(group, slot_ids, lens, logits)

        core._activate_group = spy

    def get(self, prompt: list[int], lora: str | None) -> list:
        return self.logits[(tuple(prompt), lora)]

    def close(self) -> None:
        del self.core._activate_group


def _wait_idle(core, timeout: float = 120.0) -> None:
    """Until no slot holds a request: a finish donates before it frees the
    slot, so the prefix counters are final then."""
    t_end = time.monotonic() + timeout
    while core.stats().active_slots or core.stats().queued:
        if time.monotonic() > t_end:
            raise AssertionError(f"the engine is not idle ({core.stats()})")
        time.sleep(0.005)


def _hit_within(label: str, what: str, hit, cold) -> float:
    """A hit's first-token logits against the cold prefill's, within the
    bf16 limit 2^-6 (|cold| + rms(cold)); returns the max |diff|."""
    err, ok = _within(hit, cold, 0.0, BF16_REL, None)
    if not ok:
        raise AssertionError(f"serve {label}: {what}: a hit's logits are "
                             f"outside the bf16 limit of the cold prefill's "
                             f"(max |diff| {err:.3e})")
    return err


class _Timeline:
    """While open, the host wall of each step-loop call of the core that
    did work: admission (`_try_insert`), a prefill chunk
    (`_advance_prefill`) and a decode burst (`_decode_active`), wrapped as
    instance attributes on the engine thread until close()."""

    KINDS = {"_try_insert": "admit", "_advance_prefill": "chunk",
             "_decode_active": "burst"}

    def __init__(self, core):
        self.core, self.events = core, []
        for name, kind in self.KINDS.items():
            def timed(*a, fn=getattr(core, name), kind=kind):
                t0 = time.monotonic()
                did = fn(*a)
                if did:
                    self.events.append((kind, t0, time.monotonic()))
                return did
            setattr(core, name, timed)

    def close(self) -> None:
        for name in self.KINDS:
            delattr(self.core, name)


def _timed_miss(core, prompt: list[int], lora: str | None) -> tuple:
    """One request of LONG_TOKENS alone on an idle core, and where its TTFT
    went: (ids, ttft_s, split), the split the ms from submit to the first
    admission, the prefill chunks' walls, the first burst's wall (its fetch
    emits the first token), and the rest of the TTFT."""
    line = _Timeline(core)
    try:
        t_submit = time.monotonic()
        ids, ttft, _ = _timed_core_request(core, prompt, LONG_TOKENS, lora)
    finally:
        line.close()
    events = [e for e in line.events if e[1] < t_submit + ttft]
    admit = next(e for e in events if e[0] == "admit")
    chunks = [e for e in events if e[0] == "chunk"]
    burst = next(e for e in events if e[0] == "burst")
    split = {"wait_ms": (admit[1] - t_submit) * 1e3,
             "chunk_ms": [(e[2] - e[1]) * 1e3 for e in chunks],
             "burst_ms": (burst[2] - burst[1]) * 1e3}
    split["rest_ms"] = (ttft * 1e3 - split["wait_ms"] - sum(split["chunk_ms"])
                        - split["burst_ms"])
    return ids, ttft, split


def _split_text(split: dict) -> str:
    return (f"wait {split['wait_ms']:.1f}, chunks "
            f"[{', '.join(f'{c:.1f}' for c in split['chunk_ms'])}], first "
            f"burst {split['burst_ms']:.1f}, rest {split['rest_ms']:.1f} ms")


def _fresh_batch(core, prompt: list[int]) -> tuple[float, int, int]:
    """SLOTS x 64 tokens at once, each prompt with a head of its own
    (misses): (tok/s incl. prefill, prefill dispatches, prefix evictions)."""
    d0, e0 = core.prefill_dispatches, core.stats().prefix.prefix_evictions_total
    t0 = time.monotonic()
    _concurrent([lambda i=i: _timed_core_request(
        core, _fresh_head(prompt, i), 64) for i in range(SLOTS)])
    rate = SLOTS * 64 / (time.monotonic() - t0)
    return (rate, core.prefill_dispatches - d0,
            core.stats().prefix.prefix_evictions_total - e0)


def _shared_head_traffic(core, block: dict) -> tuple:
    """The prefix block's traffic on a core: the donors one after another,
    then the rows together. Returns each row's (ids, ttft, rate), and the
    stats, prefill dispatches and extend launches the rows added."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    for name in block["donors"]:
        _timed_core_request(core, block["donor"], PREFIX_TOKENS, name)
    _wait_idle(core)
    st0, d0 = core.stats(), core.prefill_dispatches
    l0 = ca.LAUNCHES[block["extend"]]
    out = _concurrent([lambda i=i: _timed_core_request(
        core, block["rows"][i], PREFIX_TOKENS, block["names"][i])
        for i in range(PREFIX_ROWS)])
    _wait_idle(core)
    return (out, st0, core.stats(), core.prefill_dispatches - d0,
            ca.LAUNCHES[block["extend"]] - l0)


def _prefix_block(core, label: str, lora: bool) -> dict:
    """The prefix cache on the card, on the fresh serving core (its cache
    empty): the donors run one after another (in the LoRA phase one a
    namespace: base, acme, beta), then the PREFIX_ROWS shared-head rows
    together, and row 0 once more alone. Checks the counters the traffic
    implies, no copy when paged and one a hit when dense, one suffix
    dispatch a hit (the extend kernel's launches rise by the layers of each
    dispatch) and two identical hits giving the same ids. Returns the
    block, with the rows' results and first-token logits, for
    _cache_off_engine to hold against a cold prefill."""
    import numpy as np

    # ids past the 256 byte tokens: no chat prompt shares a head with them
    rng = np.random.default_rng(9)
    head = rng.integers(256, core.cfg.vocab_size, size=PREFIX_HEAD).tolist()
    tails = rng.integers(256, core.cfg.vocab_size,
                         size=(PREFIX_ROWS + 1, PREFIX_TAIL))
    tails[:, 0] = 256 + np.arange(PREFIX_ROWS + 1)  # the tails part at once
    block = {
        "donor": head + tails[0].tolist(),
        "rows": [head + t.tolist() for t in tails[1:]],
        "names": PREFIX_LORA_ROWS if lora else (None,) * PREFIX_ROWS,
        "donors": PREFIX_LORA_DONORS if lora else (None,),
        "extend": ("flash_extend" if core.page_pool is None else
                   "paged_flash_extend_quant" if core.quant.kv else
                   "paged_flash_extend")}
    rows, names, extend = block["rows"], block["names"], block["extend"]
    layers = core.cfg.num_layers
    # a miss of PREFIX_HEAD + PREFIX_TAIL tokens: its chunks (each an extend
    # dispatch) beyond the largest bucket, else one group prefill
    largest = core.prefill_buckets[-1]
    n = PREFIX_HEAD + PREFIX_TAIL
    miss_chunks = -(-n // largest) if n > largest else 1
    miss_extends = miss_chunks if n > largest else 0

    def delta(a, b, key):
        return getattr(b.prefix, key) - getattr(a.prefix, key)

    spy = _LogitSpy(core)
    try:
        st_begin = core.stats()
        hits, st0, st1, dispatches, launches = _shared_head_traffic(core,
                                                                    block)
        again = _timed_core_request(core, rows[0], PREFIX_TOKENS, names[0])
    finally:
        spy.close()
    n_hit = delta(st0, st1, "prefix_hits_total")
    n_miss = delta(st0, st1, "prefix_misses_total")
    counts = {"donor_misses": delta(st_begin, st0, "prefix_misses_total"),
              "donor_insertions": delta(st_begin, st0,
                                        "prefix_insertions_total"),
              "hits": n_hit, "misses": n_miss,
              "cached_tokens": delta(st0, st1, "prefix_cached_tokens_total"),
              "insertions": delta(st0, st1, "prefix_insertions_total"),
              "copies": delta(st0, st1, "kv_copy_dispatches"),
              "prefill_dispatches": dispatches, f"{extend}_launches": launches}
    log(f"serve {label}: prefix block: donors {list(block['donors'])}, rows "
        f"{list(names)}; {counts}; cache {core.prefix_cache_info()}")
    want = {"donor_misses": len(block["donors"]),
            "donor_insertions": len(block["donors"]),
            "hits + misses": PREFIX_ROWS,
            "cached_tokens": PREFIX_HEAD * n_hit,
            "prefill_dispatches": n_hit + miss_chunks * n_miss,
            f"{extend}_launches": layers * (n_hit + miss_extends * n_miss)}
    got = dict(counts, **{"hits + misses": n_hit + n_miss})
    if core.page_pool is not None:
        # zero-copy: every row hits the donor's 8 pages and only touches
        # the entry when it finishes (its head is covered)
        want.update(hits=PREFIX_ROWS, misses=0, insertions=0, copies=0)
    else:
        # the dense donor pins a slot, so 7 rows find one free; the 8th
        # waits for a slot that slot pressure frees by evicting a donor
        want.update(copies=n_hit)
        if n_hit < PREFIX_ROWS - 1:
            raise AssertionError(f"serve {label}: {n_hit} of {PREFIX_ROWS} "
                                 "dense rows hit the cached head")
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise AssertionError(f"serve {label}: prefix counters (got, want): "
                             f"{wrong}")
    if again[0] != hits[0][0]:
        raise AssertionError(f"serve {label}: two identical hits give "
                             f"different ids (shared {_shared(again[0], hits[0][0])}"
                             f" of {PREFIX_TOKENS})")
    return dict(block, hits=hits, logits=spy, counts=counts)


def _cache_off_engine(core, label: str, lora: bool, dev: dict,
                      core_kwargs: dict, block: dict, long_prompt: list[int],
                      prompt: list[int], stats: dict) -> dict:
    """An engine with prefix_cache=False over the same weights, built after
    the serving core's launch counts are read (its launches are not the
    serving core's): the prefix block's traffic, whose first-token logits
    each hit's must lie within the bf16 limit of; the long prompt as a
    miss, whose ids the serving core's cold run must give, with the split
    of its TTFT; and the SLOTS x 64 requests of heads of their own,
    timed against the serving core's."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    lname = "beta" if lora else None
    cold = EngineCore(core.cfg, core.params, device="cuda", seed=0,
                      num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                      prefix_cache=False, **core_kwargs)
    cold.start()
    cspy = _LogitSpy(cold)
    try:
        off, *_ = _shared_head_traffic(cold, block)
        long_off = min((_timed_miss(cold, long_prompt, lname)
                        for _ in range(2)), key=lambda r: r[1])
        # once untimed: a fresh engine's first burst of each decode key
        # runs eagerly and captures its graph
        _fresh_batch(cold, prompt)
        tok_s_8_off, d_off, _ = _fresh_batch(cold, prompt)
    finally:
        cspy.close()
        cold.stop()
        del cold
        gc.collect()
        torch.cuda.empty_cache()
    # the serving core's miss once more (a head of its own), with the
    # cache-off engine gone: whether a slower miss there is the engine's
    # or the time's
    later = _timed_miss(core, _fresh_head(long_prompt, 0), lname)
    rows, names = block["rows"], block["names"]
    errs = [_hit_within(label, f"prefix row {i}",
                        block["logits"].get(rows[i], names[i])[0],
                        cspy.get(rows[i], names[i])[0])
            for i in range(PREFIX_ROWS)]
    shared = [_shared(h[0], c[0]) for h, c in zip(block["hits"], off)]
    on_s = sum(h[1] for h in block["hits"]) / PREFIX_ROWS
    off_s = sum(c[1] for c in off) / PREFIX_ROWS
    log(f"serve {label} [{dev['smi']}]: prefix block: mean TTFT of the "
        f"{PREFIX_ROWS} shared-head rows ({len(rows[0])} tokens, "
        f"{PREFIX_HEAD} shared) {on_s * 1e3:.1f} ms with the cache on, "
        f"{off_s * 1e3:.1f} ms with it off; hit logits within the bf16 "
        f"limit of the cold prefill's (max |diff| {max(errs):.3e}); hit and "
        f"cold streams share {shared} of {PREFIX_TOKENS} tokens; a second "
        f"identical hit gives the same {PREFIX_TOKENS} ids")
    if long_off[0] != stats["long_ids"]:
        raise AssertionError(f"serve {label}: the long prompt's greedy ids "
                             "differ between identical cold runs (the serving "
                             "core and the cache-off engine)")
    log(f"serve {label} [{dev['smi']}]: the {len(long_prompt)}-token prompt, "
        f"a miss: TTFT {stats['ttft_long_s'] * 1e3:.1f} ms with the cache on "
        f"({_split_text(stats['long_split'])}), "
        f"{long_off[1] * 1e3:.1f} ms with it off "
        f"({_split_text(long_off[2])}), the same {LONG_TOKENS} ids; with "
        f"the cache on once more after: {later[1] * 1e3:.1f} ms "
        f"({_split_text(later[2])})")
    log(f"serve {label} [{dev['smi']}]: {SLOTS} concurrent x 64 tokens "
        f"(heads of their own): {stats['tok_s_8']:.1f} tok/s in "
        f"{stats['tok_s_8_dispatches']} prefill dispatches with "
        f"{stats['tok_s_8_evictions']} donor evictions with the cache on, "
        f"{tok_s_8_off:.1f} tok/s in {d_off} with it off (its graphs "
        "captured by an untimed run before)")
    return {"prefix_ttft_on_s": on_s, "prefix_ttft_off_s": off_s,
            "ttft_long_off_s": long_off[1], "tok_s_8_off": tok_s_8_off}


# The overload block of each serve phase: a priority park, page exhaustion
# (paged phases), /v1/resume over HTTP; the endpoints block (bf16); and the
# drain block, last, on a server of its own.
PARK_TOKENS = 48  # tokens of each row of the priority block
PARK_AFTER = 16  # the victim's tokens before the priority-0 request
PARK_HEAD = 40  # _fresh_head offsets of the priority block's prompts
VICTIM_SAMPLING = dict(temperature=0.8, top_p=0.95, seed=4242)
# the sweep of committed lengths (bf16): adoptions on the idle core
SWEEP = (16, 128)
# page exhaustion: on 256-position slots, two rows of EXHAUST_TOKENS tokens
# after a 100-token prompt want 2 pages each; the pool has 3 (and the
# trash page)
EXHAUST_TOKENS, EXHAUST_PAGES = 60, 4
EMBED_INPUTS = [f"Embedding input {i}: " + "z" * (20 + 3 * i)
                for i in range(SLOTS)]  # 39..60 bytes: one 64-token bucket


def _submit(core, prompt: list[int], max_tokens: int, priority: int = 1,
            lora: str | None = None, parked=None, **sampling):
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    return core.submit(Request(prompt_ids=list(prompt), parked=parked,
                               sampling=SamplingParams(
                                   max_tokens=max_tokens, priority=priority,
                                   lora=lora, **sampling)))


def _collect(request, first: list | None = None) -> tuple[list[int], str]:
    """A request's tokens and finish reason; `first` gets the host time of
    its first token event."""
    ids = []
    while True:
        kind, value = request.events.get(timeout=600)
        if kind == "token":
            if first is not None and not ids:
                first.append(time.perf_counter())
            ids.append(int(value))
        elif kind == "done":
            return ids, value
        else:
            raise RuntimeError(f"engine error: {value}")


def _collect_n(request, n: int) -> list[int]:
    """A request's first n tokens; then it is cancelled (a cancelled finish
    donates no prefix) and its end awaited."""
    ids = []
    while len(ids) < n:
        kind, value = request.events.get(timeout=600)
        if kind != "token":
            raise RuntimeError(f"request ended after {len(ids)} tokens: "
                               f"{kind} {value}")
        ids.append(int(value))
    request.cancel()
    while request.events.get(timeout=600)[0] == "token":
        pass
    return ids


def _row_kv(core, slot_id: int, rows: int):
    """Copies of K and V of a slot's positions [0, rows), every layer
    (int8 pools as {"q", "s"} pairs)."""
    import torch

    if core.page_pool is None:
        return tuple(pool[:, slot_id, :rows].clone()
                     for pool in (core.cache_k, core.cache_v))
    pos = torch.arange(rows, device=core.device)
    table = torch.as_tensor(core._block_tables[slot_id],
                            device=core.device).long()
    pages, off = table[pos // core.kv_page_size], pos % core.kv_page_size

    def take(pool):
        if isinstance(pool, dict):
            return {k: v[:, pages, off].clone() for k, v in pool.items()}
        return pool[:, pages, off].clone()
    return take(core.cache_k), take(core.cache_v)


def _kv_head(kv, rows: int):
    """The first `rows` positions of a _row_kv copy."""
    def cut(x):
        return ({k: v[:, :rows] for k, v in x.items()}
                if isinstance(x, dict) else x[:, :rows])
    return cut(kv[0]), cut(kv[1])


def _kv_first_difference(a, b) -> str | None:
    """Where two _row_kv copies first differ (K or V, layer, position)."""
    import torch

    for name, x, y in (("K", a[0], b[0]), ("V", a[1], b[1])):
        pairs = ([(f"{name} {k}", x[k], y[k]) for k in x]
                 if isinstance(x, dict) else [(name, x, y)])
        for what, u, v in pairs:
            if torch.equal(u, v):
                continue
            diff = (u != v).reshape(u.shape[0], u.shape[1], -1).any(-1)
            layer, pos = (int(i) for i in diff.nonzero()[0])
            return f"{what} of layer {layer}, position {pos}"
    return None


class _Uncounted:
    """Takes the port's kernel launches made inside the block back out of
    the counts, keeping them in `launches`: the recomputations that compare
    two runs, and the engines beside the serving core, are not the main
    path."""

    def __enter__(self):
        from llmlb_tpu_torch.kernels import build

        self.before = dict(build.LAUNCHES)
        return self

    def __exit__(self, *exc):
        from llmlb_tpu_torch.kernels import build

        self.launches = build.launches_since(self.before)
        build.add_launches(self.launches, times=-1)


def _window(n: int) -> int:
    w = 256
    while w < n:
        w *= 2
    return w


def _decode_logits(core, kv, n_kv: int, token: int, lora_row: int):
    """The logits one decode step gives a row holding `kv` (its positions
    [0, n_kv)) that is fed `token` at position n_kv - 1: the step the
    engine runs to sample the row's next token, over SLOTS rows (row 0 the
    row, the others idle) through scratch pages (paged) or a scratch slot
    cache (dense) of the engine's own layout and KV dtype."""
    import torch

    from llmlb_tpu_torch.models import llama

    cfg, dev = core.cfg, core.device
    window = _window(n_kv + 1)
    toks = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    seq = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    toks[0], seq[0] = token, n_kv - 1
    lidx = None
    if core.lora is not None:
        lidx = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        lidx[0] = lora_row
    k, v = kv
    if core.page_pool is None:
        ck, cv = llama.init_kv_cache(cfg, SLOTS, window, dev)
        ck[:, 0, :n_kv], cv[:, 0, :n_kv] = k, v
        return llama.decode_step(core.params, cfg, toks, seq, ck, cv,
                                 window=window, lora_idx=lidx)[0][0]
    ps = core.kv_page_size
    npages = -(-n_kv // ps)
    ck, cv = llama.init_kv_pages(cfg, npages + 1, ps, dev,
                                 quantized=core.quant.kv)

    def put(pool, rows):
        if isinstance(pool, dict):
            for key in pool:
                put(pool[key], rows[key])
            return
        flat = pool[:, 1:].reshape(pool.shape[0], npages * ps,
                                   *pool.shape[3:])
        flat[:, :n_kv] = rows
    put(ck, k)
    put(cv, v)
    tables = torch.zeros((SLOTS, npages), dtype=torch.int32, device=dev)
    tables[0] = torch.arange(1, npages + 1, device=dev)
    return llama.decode_step_paged(core.params, cfg, toks, seq, ck, cv,
                                   tables, window=window,
                                   lora_idx=lidx)[0][0]


def _reference_design_logits(core, ids: list[int], lora_row: int):
    """The reference's resume (`_effective_prompt`): prompt + committed
    prefilled in one pass at its bucket, through fresh scratch pages (or a
    scratch slot); the last position's logits and the pass's wall ms."""
    import torch

    from llmlb_tpu_torch.models import llama

    cfg, dev = core.cfg, core.device
    n = len(ids)
    bucket = core._bucket_for(n)
    x = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    x[0, :n] = torch.tensor(ids, device=dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    lidx = (torch.tensor([lora_row], dtype=torch.int32, device=dev)
            if core.lora is not None else None)
    if core.page_pool is None:
        ck, cv = llama.init_kv_cache(cfg, 1, bucket, dev)
        slot = torch.zeros(1, dtype=torch.int64, device=dev)
        run = lambda: llama.prefill_into_slots(  # noqa: E731
            core.params, cfg, x, lens, slot, ck, cv, lora_idx=lidx)[0][0]
    else:
        ps = core.kv_page_size
        npages = -(-bucket // ps)
        ck, cv = llama.init_kv_pages(cfg, npages + 1, ps, dev,
                                     quantized=core.quant.kv)
        tables = torch.arange(1, npages + 1, dtype=torch.int32,
                              device=dev)[None]
        run = lambda: llama.prefill_into_pages(  # noqa: E731
            core.params, cfg, x, lens, tables, ck, cv, lora_idx=lidx)[0][0]
    run()  # warm
    _sync(core)
    t0 = time.perf_counter()
    logits = run()
    _sync(core)
    return logits, (time.perf_counter() - t0) * 1e3


def _sync(core) -> None:
    import torch

    if core.device.type == "cuda":
        torch.cuda.synchronize(core.device)


class _ResumeWatch:
    """On the engine thread: for the watched requests, copies of their KV
    rows once enough tokens are committed (between bursts), and for a
    resumed one the re-admission time (its prefill group starts), its
    committed length then, and the time its first new token is fetched.
    Wraps the core's _prefill_group and _emit_fetched as instance
    attributes until close()."""

    def __init__(self, core):
        self.core = core
        self.watches: dict[int, dict] = {}  # id(request) -> watch
        prefill, emit = core._prefill_group, core._emit_fetched

        def prefill_group(bucket, group):
            for _slot, request, n in group:
                w = self.watches.get(id(request))
                if w is not None and request.parked is not None:
                    m = len(request.parked.tokens)
                    w.update(readmit=time.perf_counter(), m=m,
                             min_tokens=m + 1, rows=n + m)
            prefill(bucket, group)

        def emit_fetched(tokens, active):
            emit(tokens, active)
            for slot_id, slot in enumerate(core.slots):
                w = self.watches.get(id(slot.request))
                if (w is None or "kv" in w or w.get("min_tokens") is None
                        or len(slot.out_tokens) < w["min_tokens"]):
                    continue
                w["kv"] = _row_kv(core, slot_id, w["rows"])
                w["first_new"] = time.perf_counter()

        core._prefill_group, core._emit_fetched = prefill_group, emit_fetched

    def watch(self, request, min_tokens: int | None = None,
              rows: int | None = None) -> dict:
        """Copy the KV rows [0, rows) once `min_tokens` are committed; with
        None, once the request resumes, its positions up to and including
        its committed tokens, when its first new token is fetched."""
        w = self.watches[id(request)] = {"min_tokens": min_tokens,
                                         "rows": rows}
        return w

    def close(self) -> None:
        del self.core._prefill_group, self.core._emit_fetched


def _priority_park(core, prompt: list[int], label: str, lora: bool,
                   dev: dict, sweep: bool) -> dict:
    """SLOTS rows fill the engine: the victim (priority 2, seeded, with
    adapter acme in the LoRA phase) and SLOTS - 1 greedy rows of priority
    1, PARK_TOKENS tokens each; once the victim has PARK_AFTER tokens a
    priority-0 request arrives and parks it (the only priority-2 row). The
    victim's tokens must be its solo uninterrupted run's, its KV rows at the
    resume point (prompt and committed tokens) the uninterrupted run's bit
    for bit, and the counters must move by one park and one resume. The
    next step's logits are recomputed from each run's rows by one scratch
    decode step (equal, as the rows are; the engine's own batched step is
    not read), and serve as the base of the reference design's gap. Also the reference design's logit gap
    at the same point. With `sweep`, adoptions of the solo run's first
    SWEEP[i] tokens on the idle core: their latency and continuation."""
    victim_prompt = _fresh_head(prompt, PARK_HEAD)
    name = "acme" if lora else None
    n = len(victim_prompt)
    if core.page_pool is None:
        # dense donors pin slots, and slot pressure evicts a donor before it
        # parks a row (the reference's order): forget them first, on the
        # loop's thread, so that the arrival finds every slot decoding
        core.call_in_loop(core._drop_prefix_cache)
    solo_tokens = max(PARK_TOKENS, max(SWEEP) + 8 if sweep else 0)
    watch = _ResumeWatch(core)
    try:
        # the uninterrupted run first (its prompt is new to the cache; it is
        # cancelled, not finished, so it donates none), its KV rows copied
        # once PARK_TOKENS are committed: they cover any park point
        solo = _submit(core, victim_prompt, solo_tokens + 16, 2, name,
                       **VICTIM_SAMPLING)
        w_solo = watch.watch(solo, PARK_TOKENS, n + PARK_TOKENS - 1)
        solo_ids = _collect_n(solo, solo_tokens)
        _wait_idle(core)
        st0 = core.stats()
        victim = _submit(core, victim_prompt, PARK_TOKENS, 2, name,
                         **VICTIM_SAMPLING)
        w = watch.watch(victim)
        others = [_submit(core, _fresh_head(prompt, PARK_HEAD + 1 + i),
                          PARK_TOKENS, 1) for i in range(SLOTS - 1)]
        got: list[int] = []
        while len(got) < PARK_AFTER:
            kind, value = victim.events.get(timeout=600)
            if kind != "token":
                raise AssertionError(f"victim ended early: {kind} {value}")
            got.append(int(value))
        hi = _submit(core, _fresh_head(prompt, PARK_HEAD + SLOTS), 16, 0)
        rest, reason = _collect(victim)
        for r in [hi, *others]:
            _collect(r)
        _wait_idle(core)
        st1 = core.stats()
    finally:
        watch.close()
    ids = got + rest
    moved = (st1.preemptions_total - st0.preemptions_total,
             st1.preempt_resumes_total - st0.preempt_resumes_total)
    if moved != (1, 1):
        raise AssertionError(f"serve {label}: the priority block moved "
                             f"(preemptions, resumes) by {moved}, not (1, 1)")
    if ids != solo_ids[:PARK_TOKENS] or reason != "length":
        raise AssertionError(
            f"serve {label}: the parked row's tokens part from its solo run "
            f"after {_shared(ids, solo_ids)} of {PARK_TOKENS}")
    m = w["m"]
    if not PARK_AFTER <= m <= PARK_TOKENS - 4 or "kv" not in w:
        raise AssertionError(f"serve {label}: parked at {m} committed tokens")
    resumed_kv, uninterrupted_kv = w["kv"], _kv_head(w_solo["kv"], n + m)
    lora_row = core.lora.slot_of(name) if lora else 0
    with _Uncounted():
        args = (n + m, ids[m - 1], lora_row)
        resumed = _decode_logits(core, resumed_kv, *args)
        uninterrupted = _decode_logits(core, uninterrupted_kv, *args)
        ref, ref_ms = _reference_design_logits(core, victim_prompt + ids[:m],
                                               lora_row)
    import torch

    gap = (ref.float() - uninterrupted.float()).abs().max().item()
    where = _kv_first_difference(resumed_kv, uninterrupted_kv)
    if where is not None or not torch.equal(resumed, uninterrupted):
        raise AssertionError(
            f"serve {label}: the resumed row's KV rows first differ from the "
            f"uninterrupted run's at {where}; the next step's logits "
            f"recomputed from each differ by max |diff| "
            f"{(resumed - uninterrupted).abs().max().item():.3e}")
    out = {"park_m": m, "resume_ms": (w["first_new"] - w["readmit"]) * 1e3,
           "ref_gap": gap, "ref_prefill_ms": ref_ms, "moved": moved}
    log(f"serve {label} [{dev['smi']}]: priority park: the priority-2 row "
        f"({n}-token prompt{', adapter acme' if lora else ''}) parked at {m} "
        f"committed tokens; re-admission to its first new token "
        f"{out['resume_ms']:.1f} ms (its prompt's prefill, then {m - 1} "
        f"committed tokens fed through decode steps); its {PARK_TOKENS} "
        f"tokens its solo run's; its KV rows [0, {n + m}) at the resume "
        f"point bit-identical to the uninterrupted run's (so are the next "
        f"step's logits recomputed from each); the reference design (prompt "
        f"+ committed in one prefill, {ref_ms:.1f} ms) moves those logits by "
        f"max |diff| {gap:.3e}; (preemptions, resumes) moved by {moved}")
    if sweep:
        out["sweep"] = []
        for c in SWEEP:
            from llmlb_tpu_torch.engine.scheduler import ParkedState

            first: list = []
            t0 = time.perf_counter()
            r = _submit(core, victim_prompt, c + 8, 2, name,
                        parked=ParkedState(c, solo_ids[:c]), **VICTIM_SAMPLING)
            new, _ = _collect(r, first)
            if new != solo_ids[c:c + 8]:
                raise AssertionError(f"serve {label}: an adoption of {c} "
                                     "committed tokens parts from the solo "
                                     "run")
            with _Uncounted():
                _, ms = _reference_design_logits(
                    core, victim_prompt + solo_ids[:c], lora_row)
            out["sweep"].append((c, (first[0] - t0) * 1e3, ms))
            log(f"serve {label} [{dev['smi']}]: adoption of {c} committed "
                f"tokens on the idle core: first new token "
                f"{out['sweep'][-1][1]:.1f} ms after submit (the reference "
                f"design's prefill of {n + c} tokens: {ms:.1f} ms); its 8 "
                "new tokens the solo run's")
    return out


def _page_exhaustion(small, prompt: list[int], label: str, dev: dict) -> dict:
    """On the small engine (2 slots of 256 positions, EXHAUST_PAGES pages:
    the trash page and 3): two rows that want 2 pages each run together;
    both must finish with their solo runs' tokens and finish reasons, none
    early with "length", after at least one park."""
    prompts = [_fresh_head(prompt, PARK_HEAD + 20 + i)[:100] for i in range(2)]
    solo = [_collect(_submit(small, p, EXHAUST_TOKENS)) for p in prompts]
    t0 = time.perf_counter()
    both = [_submit(small, p, EXHAUST_TOKENS) for p in prompts]
    got = [_collect(r) for r in both]
    wall = time.perf_counter() - t0
    st = small.stats()
    if got != solo:
        raise AssertionError(
            f"serve {label}: page exhaustion: the rows' (shared tokens, "
            f"reasons) {[(_shared(a[0], b[0]), a[1]) for a, b in zip(got, solo)]}"
            f" against their solo runs")
    if st.preemptions_total < 1 or small.page_pool.total != EXHAUST_PAGES - 1:
        raise AssertionError(f"serve {label}: page exhaustion parked "
                             f"{st.preemptions_total} rows in a pool of "
                             f"{small.page_pool.total} pages")
    log(f"serve {label} [{dev['smi']}]: page exhaustion (2 slots, "
        f"{small.page_pool.total} pages of 128, 2 rows of {EXHAUST_TOKENS} "
        f"tokens): {st.preemptions_total} park(s), "
        f"{st.preempt_resumes_total} resume(s); both rows their solo runs' "
        f"tokens and finish reasons, together in {wall:.2f} s")
    return {"parks": st.preemptions_total,
            "resumes": st.preempt_resumes_total, "wall_s": wall}


def _timed(times: dict, name: str, fn, *args):
    """fn(*args), its wall seconds under `name` in `times`."""
    t0 = time.perf_counter()
    out = fn(*args)
    times[name] = round(time.perf_counter() - t0, 1)
    return out


def _sse_lines(resp):
    """The data payloads of an SSE response, as they arrive."""
    for line in resp:
        line = line.strip()
        if line.startswith(b"data: "):
            yield line[len(b"data: "):]


def _armed(content: str, max_tokens: int, lora: str | None) -> dict:
    body = {"model": "llama-3-8b", "temperature": 0, "max_tokens": max_tokens,
            "stream": True, "llmlb_replay": True,
            "messages": [{"role": "user", "content": content}]}
    if lora is not None:
        body["lora"] = lora
    return body


def _stream_ids(base: str, path: str, body: dict) -> tuple[list[int], str]:
    """(replay ids, finish reason) of an armed stream read to its end."""
    ids, finish, done = [], None, False
    with _post(base + path, body) as resp:
        for data in _sse_lines(resp):
            if data == b"[DONE]":
                done = True
                continue
            obj = json.loads(data)
            if obj.get("object") == "llmlb.replay":
                ids.extend(obj["tokens"])
            for c in obj.get("choices") or []:
                finish = c.get("finish_reason") or finish
    if not done:
        raise AssertionError(f"{path}: the stream ended without [DONE]")
    return ids, finish


def _resume_http(base: str, label: str, lora: bool, dev: dict) -> dict:
    """An armed stream of 32 tokens read to its end (the uninterrupted
    ids), the same request cut by the client after 16 replay ids, then
    POST /v1/resume with those ids: its replay frames must carry every
    committed id, in order, and its completion must be the uninterrupted
    one."""
    import http.client

    body = _armed(f"Resume check for {label}: count to ten.", 32,
                  "acme" if lora else None)
    full, finish = _stream_ids(base, "/v1/chat/completions", body)
    host, port = base[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    cut: list[int] = []
    for data in _sse_lines(conn.getresponse()):
        obj = json.loads(data)
        if obj.get("object") == "llmlb.replay":
            cut.extend(obj["tokens"])
            if len(cut) >= 16:
                break
    conn.close()  # the client goes: the engine cancels the stream
    t0 = time.perf_counter()
    again, finish2 = _stream_ids(base, "/v1/resume",
                                 {**body, "committed_ids": cut})
    wall = time.perf_counter() - t0
    if len(full) != 32 or finish != "length":
        raise AssertionError(f"serve {label}: the armed stream gave "
                             f"{len(full)} ids ({finish})")
    if cut != full[:len(cut)] or (again, finish2) != (full, finish):
        raise AssertionError(
            f"serve {label}: /v1/resume after {len(cut)} committed ids gives "
            f"{_shared(again, full)} of the uninterrupted {len(full)} ids")
    log(f"serve {label} [{dev['smi']}]: /v1/resume after {len(cut)} "
        f"committed ids of a cut armed stream: the uninterrupted {len(full)} "
        f"ids, every one in its replay frames, in {wall:.2f} s")
    return {"committed": len(cut), "wall_s": wall}


class _EmitSpy:
    """The tokens the core emits, by request id, in order of first token:
    wraps the core's _emit as an instance attribute until close()."""

    def __init__(self, core):
        self.core, self.ids = core, {}
        emit = core._emit

        def spy(slot_id, token):
            rid = core.slots[slot_id].request.request_id
            self.ids.setdefault(rid, []).append(token)
            emit(slot_id, token)

        core._emit = spy

    def last(self) -> list[int]:
        return list(self.ids.values())[-1]

    def close(self) -> None:
        del self.core._emit


def _endpoints(base: str, core, dev: dict) -> dict:
    """/v1/completions (streamed) on the chat's templated text and
    /v1/responses (streamed) on its content carry the chat's greedy ids;
    /v1/embeddings of SLOTS inputs returns finite unit vectors, each the
    same bits alone as in the batch."""
    import math

    from llmlb_tpu_torch.engine.tokenizer import default_chat_template

    content = "Endpoints: name three colours."
    messages = [{"role": "user", "content": content}]
    spy = _EmitSpy(core)
    try:
        _chat(base, content, 16, False)
        chat_ids = spy.last()
        with _post(base + "/v1/completions", {
                "model": "llama-3-8b", "temperature": 0, "max_tokens": 16,
                "stream": True,
                "prompt": default_chat_template(messages)}) as resp:
            frames = list(_sse_lines(resp))
        if frames[-1] != b"[DONE]":
            raise AssertionError("/v1/completions: no [DONE]")
        completion_ids = spy.last()
        with _post(base + "/v1/responses", {
                "model": "llama-3-8b", "temperature": 0, "max_tokens": 16,
                "stream": True, "input": content}) as resp:
            raw = resp.read()
        if b"event: response.completed" not in raw:
            raise AssertionError("/v1/responses: no response.completed")
        response_ids = spy.last()
    finally:
        spy.close()
    if not chat_ids == completion_ids == response_ids or len(chat_ids) != 16:
        raise AssertionError(
            f"completions / responses share {_shared(chat_ids, completion_ids)}"
            f" / {_shared(chat_ids, response_ids)} of the chat's 16 ids")

    def embed(inputs):
        t0 = time.perf_counter()
        with _post(base + "/v1/embeddings", {"model": "llama-3-8b",
                                              "input": inputs}) as resp:
            out = json.loads(resp.read())
        return ([d["embedding"] for d in out["data"]],
                (time.perf_counter() - t0) * 1e3)

    embed(EMBED_INPUTS)  # warm
    batch, batch_ms = embed(EMBED_INPUTS)
    alone = [embed([x]) for x in EMBED_INPUTS]
    for i, vec in enumerate(batch):
        if len(vec) != core.cfg.hidden_size or not all(map(math.isfinite,
                                                          vec)):
            raise AssertionError(f"embedding {i}: not {core.cfg.hidden_size} "
                                 "finite values")
        norm = math.sqrt(sum(x * x for x in vec))
        if abs(norm - 1.0) > 1e-4:
            raise AssertionError(f"embedding {i}: norm {norm}")
        if alone[i][0][0] != vec:
            raise AssertionError(f"embedding {i} differs alone and in the "
                                 f"batch of {SLOTS}")
    one_ms = min(ms for _, ms in alone)
    log(f"serve bf16 [{dev['smi']}]: /v1/completions and /v1/responses carry "
        f"the chat's 16 greedy ids; /v1/embeddings: {SLOTS} inputs in "
        f"{batch_ms:.1f} ms, one in {one_ms:.1f} ms (HTTP included); unit "
        f"vectors, each the same bits alone as in the batch")
    return {"embed_batch_ms": batch_ms, "embed_one_ms": one_ms}


GATEWAY_PASSWORD = "gateway-smoke-1"


def _gw_json(url: str, body: dict | None = None,
             headers: dict | None = None) -> dict:
    """GET (no body) or POST `url` on the gateway; the JSON it answers."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


CLOUD_KEY = "sk-smoke-cloud"


class _CloudMock:
    """Stand-ins on 127.0.0.1 for the cloud providers' chat APIs (OpenAI's
    /v1/chat/completions, Anthropic's /v1/messages) and the Hugging Face
    model API, so that the gateway's `openai:` and `anthropic:` models and
    its model registry run without a request leaving the machine. `hits`
    counts the requests each answered."""

    REPO = "org/llama-3-8b"

    def __init__(self):
        from collections import Counter
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        hits = self.hits = Counter()
        repo = self.REPO

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, status=200):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == f"/api/models/{repo}":
                    hits["hf"] += 1
                    return self._json({"id": repo, "siblings": [
                        {"rfilename": f} for f in (
                            "config.json", "tokenizer.json",
                            "model-00001-of-00002.safetensors",
                            "model-00002-of-00002.safetensors")]})
                self._json({"error": "not found"}, 404)

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))) or b"{}")
                if (self.path == "/v1/chat/completions" and
                        self.headers.get("Authorization")
                        == f"Bearer {CLOUD_KEY}"):
                    hits["openai"] += 1
                    return self._json({
                        "id": "chatcmpl-mock", "object": "chat.completion",
                        "model": body["model"], "choices": [{
                            "index": 0, "finish_reason": "stop",
                            "message": {"role": "assistant",
                                        "content": "from the openai mock"}}],
                        "usage": {"prompt_tokens": 3, "completion_tokens": 4,
                                  "total_tokens": 7}})
                if (self.path == "/v1/messages" and
                        self.headers.get("x-api-key") == CLOUD_KEY):
                    hits["anthropic"] += 1
                    return self._json({
                        "id": "msg_mock", "type": "message",
                        "role": "assistant", "model": body["model"],
                        "content": [{"type": "text",
                                     "text": "from the anthropic mock"}],
                        "stop_reason": "end_turn", "stop_sequence": None,
                        "usage": {"input_tokens": 3, "output_tokens": 4}})
                self._json({"error": "refused"}, 401)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.srv.server_address[1]

    def env(self) -> dict:
        """The gateway's environment for the providers and the registry."""
        return {"LLMLB_OPENAI_BASE_URL": self.url,
                "LLMLB_ANTHROPIC_BASE_URL": self.url,
                "LLMLB_GOOGLE_BASE_URL": self.url, "HF_BASE_URL": self.url,
                "OPENAI_API_KEY": CLOUD_KEY, "ANTHROPIC_API_KEY": CLOUD_KEY}

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def _start_gateway(data_dir: str, faults: list[dict],
                   env: dict | None = None, port: int = 0):
    """`python -m llmlb_tpu_torch.gateway.server serve` on `port` of
    127.0.0.1 (0: a free one), from the tree the port was imported from,
    with `env` added to its environment; returns the process and its base
    URL once it listens, after checking that it runs on the native core."""
    import os

    import llmlb_tpu_torch

    root = Path(llmlb_tpu_torch.__file__).resolve().parents[1]
    log_path = Path(data_dir) / "gateway.log"
    env = {**os.environ, "LLMLB_DATA_DIR": data_dir,
           "LLMLB_LOG_DIR": os.path.join(data_dir, "logs"),
           "LLMLB_ADMIN_PASSWORD": GATEWAY_PASSWORD,
           "LLMLB_FAULTS": json.dumps(faults), **(env or {})}
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmlb_tpu_torch.gateway.server", "serve",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)",
                      log_path.read_text())
        if m and _runs_native(proc.pid):
            return proc, f"http://127.0.0.1:{m.group(1)}"
        if m:
            proc.kill()
            proc.wait()
            raise AssertionError("the gateway runs on the Python twins: it "
                                 "has no native library mapped")
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise AssertionError(f"the gateway did not start: "
                         f"{log_path.read_text()[-2000:]}")


def _gw_call(method: str, url: str, body: dict | None = None,
             headers: dict | None = None) -> tuple[int, dict]:
    """Any method on the gateway: (status, the JSON it answers), also on
    an error status."""
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _messages(base: str, content: str, max_tokens: int, stream: bool,
              headers: dict | None = None) -> dict:
    """One greedy /v1/messages request; returns {text, usage, stop,
    events} after checking the response's shape: a streamed one must be
    one message (one message_start first, content blocks opened, fed and
    closed in index order, message_delta, then one message_stop last, no
    error event)."""
    body = {"model": "llama-3-8b", "temperature": 0, "max_tokens": max_tokens,
            "stream": stream,
            "messages": [{"role": "user", "content": content}]}
    with _post(base + "/v1/messages", body, headers=headers) as resp:
        raw = resp.read()
    if not stream:
        out = json.loads(raw)
        if out.get("type") != "message" or out.get("role") != "assistant":
            raise AssertionError(f"/v1/messages: {out}")
        return {"text": "".join(b["text"] for b in out["content"]
                                if b["type"] == "text"),
                "usage": out["usage"], "stop": out["stop_reason"],
                "events": 0}
    events = []
    for block in raw.split(b"\n\n"):
        if not block.strip():
            continue
        name = data = None
        for line in block.split(b"\n"):
            if line.startswith(b"event:"):
                name = line[len(b"event:"):].strip().decode()
            elif line.startswith(b"data:"):
                data = json.loads(line[len(b"data:"):])
        events.append((name, data))
    names = [n for n, _ in events]
    bad = (names[:1] != ["message_start"] or names[-2:] != ["message_delta",
                                                            "message_stop"]
           or names.count("message_start") != 1 or "error" in names
           or names.count("message_stop") != 1)
    open_idx, next_idx = None, 0
    for name, data in events:
        bad |= not isinstance(data, dict) or data.get("type") != name
        if name == "content_block_start":
            bad |= open_idx is not None or data["index"] != next_idx
            open_idx, next_idx = data["index"], next_idx + 1
        elif name in ("content_block_delta", "content_block_stop"):
            bad |= data["index"] != open_idx
            if name == "content_block_stop":
                open_idx = None
    if bad or open_idx is not None:
        raise AssertionError(f"/v1/messages: a malformed event stream {names}")
    delta = events[-2][1]
    return {"text": "".join(d["delta"]["text"] for n, d in events
                            if n == "content_block_delta"),
            "usage": delta["usage"], "stop": delta["delta"]["stop_reason"],
            "events": len(events)}


def _armed_text(base: str, content: str, max_tokens: int) -> tuple[int, str]:
    """(bytes, text) of an armed greedy chat stream read to its end."""
    with _post(base + "/v1/chat/completions",
               _armed(content, max_tokens, None)) as resp:
        raw = resp.read()
    text = []
    for line in raw.split(b"\n"):
        if line.startswith(b"data: {"):
            obj = json.loads(line[len(b"data: "):])
            for c in obj.get("choices") or []:
                text.append((c.get("delta") or {}).get("content") or "")
    return len(raw), "".join(text)


def _ttft_1(url: str, content: str, headers: dict | None = None) -> float:
    """Seconds to the first frame after the role delta of a greedy 1-token
    chat stream: the frame the first sampled token produces."""
    body = {"model": "llama-3-8b", "temperature": 0, "max_tokens": 1,
            "stream": True, "messages": [{"role": "user", "content": content}]}
    t0 = time.perf_counter()
    seen = []
    with _post(url + "/v1/chat/completions", body, headers=headers) as resp:
        for _ in _sse_lines(resp):
            seen.append(time.perf_counter() - t0)
    if len(seen) < 3:
        raise AssertionError(f"a 1-token stream gave {len(seen)} frames")
    return seen[1]


def _gateway_block(engine, base: str, dev: dict) -> dict:
    """The port's gateway (llmlb_tpu_torch/gateway/) in front of this
    phase's engine server, as a subprocess on the standard library, its
    cloud providers and Hugging Face API a local mock: the registration
    detects the engine as `tpu` and syncs its model; a greedy 64-token chat
    streamed and not, /v1/responses and /v1/messages streamed and not
    through the gateway carry the direct path's ids, text and usage; a
    second registration of the same server (http://localhost:PORT) has a
    chat stream, then a /v1/messages stream, cut half-way by the
    `engine_abort` fault rule, and the gateway resumes each on the first to
    the uncut text; an `openai:` and an `anthropic:` model reach the mock;
    a model is registered from the mock's repo and its manifest served; an
    invitation registers a user, the second registration is renamed and
    deleted, and the audit log's chain verifies; TTFT of 1-token streams
    through the gateway against direct, median of 5 each, interleaved."""
    import tempfile

    from llmlb_tpu_torch.ops import cuda_attention as ca

    core = engine.core
    t0 = time.perf_counter()
    before = dict(ca.LAUNCHES)
    cut_text = "Gateway resume: list the planets in order."
    armed_bytes, _ = _armed_text(base, cut_text, 64)
    uncut = _chat(base, cut_text, 64, True)
    msg_cut_text = "Gateway messages resume: name the oceans."
    spy = _EmitSpy(core)
    try:
        msg_bytes, msg_uncut = _armed_text(base, msg_cut_text, 64)
        msg_uncut_ids = spy.last()
    finally:
        spy.close()
    port = base.rsplit(":", 1)[1]
    # both rules match the second registration only; the second fires on
    # its second chat stream (the /v1/messages one), once
    faults = [{"kind": "engine_abort", "endpoint": "localhost",
               "path": "/v1/chat", "after_bytes": armed_bytes // 2,
               "max_fires": 1},
              {"kind": "engine_abort", "endpoint": "localhost",
               "path": "/v1/chat", "after_bytes": msg_bytes // 2,
               "every_n": 2, "max_fires": 1}]
    mock = _CloudMock()
    feed = None
    with tempfile.TemporaryDirectory(prefix="llmlb-gw-") as data_dir:
        proc, gw = _start_gateway(data_dir, faults, mock.env())
        try:
            start_s = time.perf_counter() - t0
            token = _gw_json(gw + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            key = _gw_json(gw + "/api/api-keys", {"name": "smoke"},
                           admin)["api_key"]
            inf = {"Authorization": f"Bearer {key}"}
            feed = _WsClient(gw, "/ws/dashboard", token)
            ep = _gw_json(gw + "/api/endpoints", {
                "base_url": base, "name": "serve-bf16"}, admin)
            models = [m["model_id"] for m in ep.get("models") or []]
            if (ep["endpoint_type"], ep["status"]) != ("tpu", "online") or \
                    models != ["llama-3-8b"]:
                raise AssertionError(f"gateway registration: {ep}")
            content = "Gateway check: describe a GPU in one line."
            msg_content = "Gateway messages: describe a river in one line."
            spy = _EmitSpy(core)
            try:
                pairs = {}
                for stream in (True, False):
                    direct = _chat(base, content, 64, stream)
                    d_ids = spy.last()
                    via = _chat(gw, content, 64, stream, headers=inf)
                    pairs[stream] = (direct, via, d_ids, spy.last())
                body = {"model": "llama-3-8b", "temperature": 0,
                        "max_output_tokens": 64, "input": content}
                r_direct = _gw_json(base + "/v1/responses", body)
                rd_ids = spy.last()
                r_via = _gw_json(gw + "/v1/responses", body, inf)
                rv_ids = spy.last()
                m_direct = _chat(base, msg_content, 64, False)
                md_ids = spy.last()
                msg_before = dict(ca.LAUNCHES)
                msgs = {}
                for stream in (False, True):
                    msgs[stream] = (_messages(gw, msg_content, 64, stream,
                                              inf), spy.last())
                msg_launches = {k: ca.LAUNCHES[k] - msg_before.get(k, 0)
                                for k in BF16_PATH}
            finally:
                spy.close()
            for stream, (direct, via, d_ids, v_ids) in pairs.items():
                if via != direct or v_ids != d_ids or len(d_ids) != 64:
                    raise AssertionError(
                        f"gateway chat (stream={stream}): {via['usage']} "
                        f"against {direct['usage']}; ids share "
                        f"{_shared(v_ids, d_ids)} of {len(d_ids)}")
            if pairs[True][2] != pairs[False][2]:
                raise AssertionError("streamed and plain chats differ")

            def out(r):
                return ([c.get("text") for o in r["output"]
                         for c in o.get("content") or []], r["usage"])

            if out(r_via) != out(r_direct) or rv_ids != rd_ids:
                raise AssertionError(f"gateway /v1/responses: {out(r_via)} "
                                     f"against {out(r_direct)}")
            want = {"input_tokens": m_direct["usage"]["prompt_tokens"],
                    "output_tokens": m_direct["usage"]["completion_tokens"]}
            for stream, (msg, ids) in msgs.items():
                if (msg["text"], msg["stop"], msg["usage"], ids) != (
                        m_direct["text"], "max_tokens", want, md_ids) or \
                        len(md_ids) != 64:
                    raise AssertionError(
                        f"gateway /v1/messages (stream={stream}): "
                        f"{msg['stop']} {msg['usage']} against {want}; ids "
                        f"share {_shared(ids, md_ids)} of {len(md_ids)}")
            # the cuts: a second registration of this server, unmeasured so
            # chosen first, cut half-way; each resume lands on the first
            ep2 = _gw_json(gw + "/api/endpoints", {
                "base_url": f"http://localhost:{port}",
                "name": "resume-origin"}, admin)
            if ep2["endpoint_type"] != "tpu":
                raise AssertionError(f"second registration: {ep2}")
            resumed = _chat(gw, cut_text, 64, True, headers=inf)
            spy = _EmitSpy(core)
            try:
                msg_resumed = _messages(gw, msg_cut_text, 64, True, inf)
                cut_ids = list(spy.ids.values())
            finally:
                spy.close()
            with urllib.request.urlopen(gw + "/metrics", timeout=60) as r:
                metrics = r.read().decode()
            if resumed != uncut:
                raise AssertionError(f"the resumed stream: {resumed} against "
                                     f"the uncut {uncut}")
            # the origin's ids up to the cut, then the adopter's, are the
            # uncut stream's (the random weights' text is mostly empty:
            # ids above the byte range decode to nothing)
            spliced = len(cut_ids) == 2 and any(
                cut_ids[0][:c] + cut_ids[1] == msg_uncut_ids
                for c in range(1, len(cut_ids[0]) + 1))
            if (msg_resumed["text"], msg_resumed["stop"],
                    msg_resumed["usage"].get("output_tokens")) != (
                    msg_uncut, "max_tokens", 64) or not spliced:
                raise AssertionError(
                    f"the resumed /v1/messages stream: {msg_resumed['text']!r}"
                    f" {msg_resumed['usage']} against the uncut {msg_uncut!r};"
                    f" ids {[len(i) for i in cut_ids]}, spliced {spliced}")
            if ('llmlb_gateway_stream_resumes_total{outcome="success"} 2'
                    not in metrics):
                raise AssertionError("the gateway booked no resume: " + " ".join(
                    ln for ln in metrics.splitlines() if "resume" in ln))
            admin_s = _admin_block(gw, admin, inf, ep2["id"], mock)
            # TTFT, interleaved, fresh heads (no prefix-cache hits)
            direct_t, via_t = [], []
            for i in range(5):
                direct_t.append(_ttft_1(base, f"TTFT probe {i}a: say hi."))
                via_t.append(_ttft_1(gw, f"TTFT probe {i}b: say hi.", inf))
            health = _gw_json(gw + "/api/health")
            dash = _dashboard_block(gw, admin, feed, ep["id"], dev)
        finally:
            if feed is not None:
                feed.close()
            proc.terminate()
            code = proc.wait(timeout=60)
            mock.close()
        if code != 0:
            raise AssertionError(f"the gateway exited with {code}")
    launches = {k: ca.LAUNCHES[k] - before.get(k, 0) for k in BF16_PATH}
    if not launches["flash_prefill"] or not launches["paged_flash_decode"]:
        raise AssertionError(f"gateway traffic launched {launches}")
    if not msg_launches["flash_prefill"] or \
            not msg_launches["paged_flash_decode"]:
        raise AssertionError(f"/v1/messages traffic launched {msg_launches}")
    multi = _multi_worker_block(engine, base, dev, content, pairs[True][0],
                                pairs[True][2])
    update = _update_block(engine, base, dev)
    stats = {"start_s": round(start_s, 3),
             "ttft_direct_ms": statistics.median(direct_t) * 1e3,
             "ttft_gateway_ms": statistics.median(via_t) * 1e3,
             "ttft_direct_all_ms": [t * 1e3 for t in direct_t],
             "ttft_gateway_all_ms": [t * 1e3 for t in via_t],
             "launches": launches, "messages_launches": msg_launches,
             "admin_s": admin_s, "dashboard": dash, "multi_worker": multi,
             "update": update,
             "breakers": {e["name"]: e["breaker"]["state"]
                          for e in health["endpoints"]}}
    log(f"serve bf16 [{dev['smi']}]: gateway: registered as tpu with "
        f"llama-3-8b synced; chat (streamed and not), /v1/responses and "
        f"/v1/messages (streamed, {msgs[True][0]['events']} events, and not) "
        f"through it carry the direct path's 64 ids, text and usage; a chat "
        f"stream cut at {armed_bytes // 2} of ~{armed_bytes} bytes and a "
        f"/v1/messages stream cut at {msg_bytes // 2} of ~{msg_bytes} resumed "
        f"on the other registration to the uncut text (its ids: "
        f"{len(cut_ids[1])} of 64 from the adopter); launches {launches}, "
        f"/v1/messages {msg_launches}")
    log(f"serve bf16 [{dev['smi']}]: gateway TTFT (1-token stream, median of "
        f"5) {stats['ttft_gateway_ms']:.2f} ms through the gateway against "
        f"{stats['ttft_direct_ms']:.2f} ms direct (all: gateway "
        f"{[round(t, 2) for t in stats['ttft_gateway_all_ms']]}, direct "
        f"{[round(t, 2) for t in stats['ttft_direct_all_ms']]}); gateway up "
        f"in {start_s:.2f} s; the block {time.perf_counter() - t0:.1f} s")
    return stats


def _children(pid: int) -> list[int]:
    """The live processes whose parent is `pid` (read from /proc)."""
    import os

    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def _multi_worker_block(engine, base: str, dev: dict, content: str,
                        direct: dict, d_ids: list[int]) -> dict:
    """`python -m llmlb_tpu_torch.gateway.server serve --workers 2` in
    front of this phase's engine server, on a free fixed port: both workers
    list the engine registered through one of them; six greedy 64-token
    chats of the gateway block's `content` (three streamed, three not, each
    on a fresh connection) carry the direct path's ids `d_ids` and its
    text and usage, more chats if one worker served none; the merged
    /metrics has request series of both workers; 12 lookups of one chat's
    trace on fresh connections answer 200; both workers' gossip sent and
    received, none refused; SIGTERM: the supervisor exits 0 and no worker
    outlives it."""
    import os
    import signal
    import socket
    import tempfile

    import llmlb_tpu_torch
    from llmlb_tpu_torch.ops import cuda_attention as ca

    core = engine.core
    t0 = time.perf_counter()
    before = dict(ca.LAUNCHES)
    root = Path(llmlb_tpu_torch.__file__).resolve().parents[1]
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    gw = f"http://127.0.0.1:{port}"
    with tempfile.TemporaryDirectory(prefix="llmlb-mw-") as data_dir:
        env = {**os.environ, "LLMLB_DATA_DIR": data_dir,
               "LLMLB_LOG_DIR": os.path.join(data_dir, "logs"),
               "LLMLB_GOSSIP_DIR": os.path.join(data_dir, "gossip"),
               "LLMLB_ADMIN_PASSWORD": GATEWAY_PASSWORD,
               "LLMLB_HEALTH_CHECK_INTERVAL": "0.5",
               "LLMLB_METRICS_SPOOL_SECS": "0.5"}
        env.pop("LLMLB_FAULTS", None)
        log_path = Path(data_dir) / "gateway.log"
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "llmlb_tpu_torch.gateway.server",
                 "serve", "--host", "127.0.0.1", "--port", str(port),
                 "--workers", "2"],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        kids: list[int] = []

        def until(pred, what: str, timeout_s: float = 60.0):
            deadline = time.monotonic() + timeout_s
            while True:
                got = pred()
                if got:
                    return got
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"multi-worker gateway: {what}: "
                        f"{log_path.read_text()[-2000:]}")
                time.sleep(0.02)

        def up() -> bool:
            try:
                with urllib.request.urlopen(gw + "/health", timeout=5) as r:
                    return r.status == 200
            except OSError:
                return False

        def by_worker(what: str) -> dict:
            """/api/health from each worker (fresh connections)."""
            seen: dict = {}

            def both():
                h = _gw_json(gw + "/api/health")
                seen[h["worker"]["index"]] = h
                return len(seen) == 2 and h["worker"]["count"] == 2
            until(both, what)
            return seen

        try:
            until(up, "never answered /health")
            start_s = time.perf_counter() - t0
            kids = until(lambda: len(_children(proc.pid)) == 2
                         and _children(proc.pid), "two workers")
            token = _gw_json(gw + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            key = _gw_json(gw + "/api/api-keys", {"name": "smoke-mw"},
                           admin)["api_key"]
            inf = {"Authorization": f"Bearer {key}"}
            ep = _gw_json(gw + "/api/endpoints", {
                "base_url": base, "name": "serve-bf16-mw"}, admin)

            def listed():
                seen = by_worker("the engine listed")
                return all(any(e["name"] == "serve-bf16-mw"
                               and e["status"] == "online"
                               for e in h["endpoints"])
                           for h in seen.values())
            until(listed, "a worker never listed the engine online")
            listed_s = time.perf_counter() - t0
            python_twins = [pid for pid in kids if not _runs_native(pid)]
            if python_twins:
                raise AssertionError(f"multi-worker gateway: workers "
                                     f"{python_twins} run on the Python "
                                     "twins (no native library mapped)")
            def scrape(route: str | None) -> dict:
                with urllib.request.urlopen(gw + "/metrics",
                                            timeout=60) as r:
                    text = r.read().decode()
                return {w: int(sum(
                    float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                    if ln.startswith("llmlb_gateway_requests_total{")
                    and (route is None or f'route="{route}"' in ln)
                    and f'worker="{w}"' in ln)) for w in ("0", "1")}

            def settled() -> dict:
                """Chats by worker once the sibling's spool has them all."""
                got: dict = {}

                def all_in():
                    got.update(scrape("/v1/chat/completions"))
                    return sum(got.values()) == len(chats)
                until(all_in, "the merged /metrics never counted the chats",
                      timeout_s=20.0)
                return got

            spy = _EmitSpy(core)
            chats: list[bool] = []
            try:
                def chat() -> str:
                    n = len(chats)
                    stream = n % 2 == 0
                    rid = f"smoke-mw-{n}"
                    via = _chat(gw, content, 64, stream,
                                headers={**inf, "X-Request-Id": rid})
                    v_ids = spy.last()
                    if via != direct or v_ids != d_ids:
                        raise AssertionError(
                            f"multi-worker chat {n} (stream={stream}): "
                            f"{via['usage']} against {direct['usage']}; ids "
                            f"share {_shared(v_ids, d_ids)} of {len(d_ids)}")
                    chats.append(stream)
                    return rid

                for _ in range(6):
                    rid = chat()
                served = settled()
                # one worker served none of the six: more, until each has
                while not all(served.values()):
                    if len(chats) >= 16:
                        raise AssertionError(
                            f"multi-worker chats served {served}")
                    rid = chat()
                    served = settled()
            finally:
                spy.close()
            chats_s = time.perf_counter() - t0
            requests = scrape(None)
            if not all(requests.values()):
                raise AssertionError(f"merged /metrics: {requests}")
            lookups = []
            for _ in range(12):
                status, got = _gw_call("GET", gw + f"/api/traces/{rid}",
                                       headers=admin)
                lookups.append(status)
                if status != 200 or got.get("trace_id") != rid:
                    raise AssertionError(f"trace lookup: {status} {got}")
            gossip = {i: {k: h["gossip"][k] for k in (
                "sent_total", "received_total", "recv_rejected_total",
                "send_errors_total", "peers")}
                for i, h in by_worker("gossip stats").items()}
            for g in gossip.values():
                if not (g["sent_total"] > 0 and g["received_total"] > 0
                        and g["recv_rejected_total"] == 0
                        and g["peers"] == 1):
                    raise AssertionError(f"multi-worker gossip: {gossip}")
            stop_t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
            stop_s = time.perf_counter() - stop_t
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        left = [pid for pid in kids if os.path.exists(f"/proc/{pid}")]
        for pid in left:
            os.kill(pid, signal.SIGKILL)
        if code != 0 or left:
            raise AssertionError(f"multi-worker gateway: exit {code}, "
                                 f"workers left {left}: "
                                 f"{log_path.read_text()[-2000:]}")
    launches = {k: ca.LAUNCHES[k] - before.get(k, 0) for k in BF16_PATH}
    if not launches["flash_prefill"] or not launches["paged_flash_decode"]:
        raise AssertionError(f"multi-worker traffic launched {launches}")
    stats = {"seconds": round(time.perf_counter() - t0, 3),
             "start_s": round(start_s, 3), "listed_s": round(listed_s, 3),
             "stop_s": round(stop_s, 3),
             "chats_s": round(chats_s, 3),
             "chats": len(chats), "streamed": sum(chats),
             "ids_equal_direct": len(chats),
             "chats_by_worker": served, "requests_by_worker": requests,
             "trace_lookups_200": lookups.count(200),
             "gossip": {str(i): g for i, g in sorted(gossip.items())},
             # "online": worker 0 took the registration and probed at once;
             # "pending": worker 1 took it and worker 0's loop probed it
             "registration": ep["status"], "native_workers": len(kids),
             "launches": launches}
    log(f"serve bf16 [{dev['smi']}]: multi_worker {json.dumps(stats)}")
    return stats


class _ReleaseStub:
    """A GitHub Releases stand-in on 127.0.0.1 (the standard library's
    server on a thread), so that the gateway's self-update runs with no
    request leaving the machine: the latest release of acme/llmlb-tpu is
    v9.9.9 with one asset, app.bin, of `size` seeded bytes. `hits` counts
    the requests it answered, by route."""

    def __init__(self, size: int):
        import random
        from collections import Counter
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.asset = random.Random(9).randbytes(size)
        hits = self.hits = Counter()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/repos/acme/llmlb-tpu/releases/latest":
                    hits["release"] += 1
                    return self._send(json.dumps({
                        "tag_name": "v9.9.9", "body": "smoke release",
                        "assets": [{"name": "app.bin",
                                    "browser_download_url":
                                        outer.url + "/assets/app.bin"}],
                    }).encode(), "application/json")
                if self.path == "/assets/app.bin":
                    hits["asset"] += 1
                    return self._send(outer.asset, "application/octet-stream")
                self.send_error(404)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = "http://127.0.0.1:%d" % self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


UPDATE_ASSET_BYTES = 4 * 1024 * 1024 + 13
UPDATE_PACE_S = 0.015


def _update_block(engine, base: str, dev: dict) -> dict:
    """The gateway's self-update, instance lock, tray and assistant in
    front of this phase's engine server, on a free fixed port P with a data
    directory of its own and a release stub (`_ReleaseStub`) for the
    GitHub API: `status` names the gateway's pid; a second `serve --port P`
    on that directory exits non-zero naming the lock while the first still
    answers /health; a greedy 64-token chat stream through the gateway
    (its ids paced by UPDATE_PACE_S a token on the engine, so that it is
    still live when the apply drains) runs on, after its first frames and
    4 ids,
    through an update check that finds v9.9.9 (the tray's menu offers it
    and its notifications say "Update available") and a normal apply:
    while it is live /api/system reads `draining` and a new
    /v1/chat/completions gets 503 with Retry-After; it ends with the direct
    path's 64 ids, text and usage; the gateway then exits 0 by itself,
    leaving the stub's bytes in app.bin, the old ones in app.bin.bak, the
    marker naming v9.9.9 and no lock file. Playing the supervisor, the
    block starts it again on P (LLMLB_UVLOOP=1: uvloop where the machine
    has it, else the fallback's warning); its post-restart watch clears
    the marker after three healthy probes and /api/system's history
    records `post_restart: healthy`; `assistant curl` runs a greedy
    16-token chat through it with the key from LLMLB_API_KEY, equal to a
    direct chat of the prompt; `stop --port P` ends it with exit 0 and
    `status` then prints "not running". The block's traffic launches
    flash_prefill and paged_flash_decode."""
    import os
    import socket
    import tempfile

    import llmlb_tpu_torch
    from llmlb_tpu_torch.ops import cuda_attention as ca

    core = engine.core
    t0 = time.perf_counter()
    before = dict(ca.LAUNCHES)
    root = Path(llmlb_tpu_torch.__file__).resolve().parents[1]
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    gw = f"http://127.0.0.1:{port}"
    stub = _ReleaseStub(UPDATE_ASSET_BYTES)
    old = b"the artifact before the update\n" * 1000
    try:
        import uvloop  # noqa: F401

        has_uvloop = True
    except ImportError:
        has_uvloop = False
    content = "Update drain: describe a lighthouse in one line."
    spy = _EmitSpy(core)
    try:
        direct = _chat(base, content, 64, True)
        d_ids = spy.last()
        a_content = "Assistant check: name a colour."
        a_direct = _chat(base, a_content, 16, False)
        a_ids = spy.last()
    finally:
        spy.close()
    if len(d_ids) != 64 or len(a_ids) != 16:
        raise AssertionError(f"direct chats gave {len(d_ids)} and "
                             f"{len(a_ids)} ids")
    procs: list = []
    with tempfile.TemporaryDirectory(prefix="llmlb-up-") as data_dir:
        artifact = Path(data_dir) / "app.bin"
        artifact.write_bytes(old)
        env = {"LLMLB_UPDATE_REPO": "acme/llmlb-tpu",
               "LLMLB_UPDATE_API_BASE": stub.url,
               "LLMLB_UPDATE_ARTIFACT": str(artifact), "LLMLB_TRAY": "1"}
        cli_env = {**os.environ, "LLMLB_DATA_DIR": data_dir,
                   "LLMLB_PORT": str(port), "LLMLB_ROUTER_URL": gw}

        def cli(*args: str) -> subprocess.CompletedProcess:
            return subprocess.run(
                [sys.executable, "-m", "llmlb_tpu_torch.gateway.server",
                 *args], cwd=root, env=cli_env, capture_output=True,
                text=True, timeout=120)

        try:
            proc, _ = _start_gateway(data_dir, [], env, port=port)
            procs.append(proc)
            start_s = time.perf_counter() - t0
            # the lock: status names the holder, a second serve is refused
            status = cli("status").stdout.strip()
            if status != f"running: pid={proc.pid} port={port}":
                raise AssertionError(f"status: {status!r}")
            second = subprocess.run(
                [sys.executable, "-m", "llmlb_tpu_torch.gateway.server",
                 "serve", "--host", "127.0.0.1", "--port", str(port)],
                cwd=root, env={**cli_env, "LLMLB_LOG_DIR": os.path.join(
                    data_dir, "logs2"), "LLMLB_ADMIN_PASSWORD":
                    GATEWAY_PASSWORD, **env},
                capture_output=True, text=True, timeout=120)
            refusal = (f"another llmlb instance (pid {proc.pid}) already "
                       f"holds port {port}")
            if second.returncode == 0 or refusal not in second.stderr:
                raise AssertionError(f"a second serve on port {port}: exit "
                                     f"{second.returncode}, "
                                     f"{second.stderr[-1500:]}")
            if _gw_call("GET", gw + "/health") != (200, {"status": "ok"}):
                raise AssertionError("the first gateway stopped answering")
            token = _gw_json(gw + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            key = _gw_json(gw + "/api/api-keys", {"name": "smoke-up"},
                           admin)["api_key"]
            inf = {"Authorization": f"Bearer {key}"}
            ep = _gw_json(gw + "/api/endpoints", {
                "base_url": base, "name": "serve-bf16-up"}, admin)
            if (ep["endpoint_type"], ep["status"]) != ("tpu", "online"):
                raise AssertionError(f"registration: {ep}")

            # the drained update of a live stream
            frames: list[bytes] = []
            ended = threading.Event()
            failed: list[BaseException] = []

            def stream() -> None:
                try:
                    body = {"model": "llama-3-8b", "temperature": 0,
                            "max_tokens": 64, "stream": True,
                            "messages": [{"role": "user",
                                          "content": content}]}
                    with _post(gw + "/v1/chat/completions", body,
                               headers=inf) as resp:
                        for data in _sse_lines(resp):
                            frames.append(data)
                except BaseException as e:  # re-raised on the main thread
                    failed.append(e)
                finally:
                    ended.set()

            spy = _EmitSpy(core)
            paced = core._emit

            def pace(slot_id, tok):
                paced(slot_id, tok)
                time.sleep(UPDATE_PACE_S)

            core._emit = pace
            try:
                reader = threading.Thread(target=stream, daemon=True)
                reader.start()

                def emitted() -> int:
                    return len(spy.last()) if spy.ids else 0

                # its first frames (on random weights most ids decode to no
                # text, so the engine's ids say how far it has gone)
                deadline = time.monotonic() + 600
                while not (frames and emitted() >= 4) and not ended.is_set():
                    if time.monotonic() > deadline:
                        raise AssertionError("the stream never started")
                    time.sleep(0.002)
                if ended.is_set():
                    raise AssertionError(f"the stream ended before the "
                                         f"update: {failed or frames[-3:]}")
                check = _gw_json(gw + "/api/system/update/check", {}, admin)
                if (check.get("available"), check.get("version")) != (
                        True, "v9.9.9"):
                    raise AssertionError(f"update check: {check}")
                tray = _gw_json(gw + "/api/system/tray", headers=admin)
                note_deadline = time.monotonic() + 10
                while not tray["notifications"] and \
                        time.monotonic() < note_deadline:
                    time.sleep(0.02)
                    tray = _gw_json(gw + "/api/system/tray", headers=admin)
                item = tray["menu"][1]
                if item != {"id": "update", "enabled": True, "label":
                            "Update to v9.9.9 available — apply"} or [
                        n["title"] for n in tray["notifications"]] != [
                        "Update available"]:
                    raise AssertionError(f"tray: {tray}")
                apply_t = time.perf_counter()
                ids_at_apply = emitted()
                code, applied = _gw_call("POST",
                                         gw + "/api/system/update/apply", {},
                                         admin)
                if code != 202 or applied.get("applying") is not True:
                    raise AssertionError(f"apply: {code} {applied}")
                seen = None
                while seen != "draining" and not ended.is_set():
                    seen = _gw_json(gw + "/api/system",
                                    headers=admin)["update"]["state"]
                    time.sleep(0.002)
                live_at_drain = not ended.is_set()
                ids_at_drain = emitted()
                req = urllib.request.Request(
                    gw + "/v1/chat/completions", data=json.dumps({
                        "model": "llama-3-8b", "max_tokens": 4,
                        "messages": [{"role": "user", "content": "hi"}]
                    }).encode(), headers={"Content-Type": "application/json",
                                          **inf})
                try:
                    urllib.request.urlopen(req, timeout=60).close()
                    rejected = (200, None)
                except urllib.error.HTTPError as e:
                    rejected = (e.code, e.headers.get("Retry-After"))
                live_at_503 = not ended.is_set()
                reader.join(timeout=600)
                gone = proc.wait(timeout=120)
                exit_s = time.perf_counter() - apply_t
            finally:
                spy.close()
            if failed:
                raise failed[0]
            v_ids = spy.last()
            if not (live_at_drain and live_at_503 and seen == "draining"):
                raise AssertionError(
                    f"the stream was not live through the drain: state "
                    f"{seen}, live at draining {live_at_drain}, at the 503 "
                    f"{live_at_503}")
            if rejected[0] != 503 or not rejected[1]:
                raise AssertionError(f"a new chat while draining: {rejected}")
            chunks = [json.loads(f) for f in frames if f != b"[DONE]"]
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks if c["choices"])
            if (frames[-1:] != [b"[DONE]"] or v_ids != d_ids
                    or text != direct["text"]
                    or chunks[-1].get("usage") != direct["usage"]):
                raise AssertionError(
                    f"the drained stream: ids share {_shared(v_ids, d_ids)} "
                    f"of {len(d_ids)}, usage {chunks[-1].get('usage')} "
                    f"against {direct['usage']}")
            if gone != 0:
                raise AssertionError(f"the gateway exited with {gone} after "
                                     "the apply")
            marker = json.loads((Path(data_dir) /
                                 "update_pending.json").read_text())
            bak = Path(str(artifact) + ".bak")
            lock = Path(data_dir) / f"llmlb-{port}.lock"
            if (artifact.read_bytes() != stub.asset or not bak.exists()
                    or bak.read_bytes() != old
                    or marker.get("version") != "v9.9.9" or lock.exists()):
                raise AssertionError(
                    f"after the apply: app.bin {artifact.stat().st_size} "
                    f"bytes, .bak {bak.exists()}, marker {marker}, lock "
                    f"{lock.exists()}")

            # the supervisor's restart, on uvloop where the machine has it
            restart_t = time.perf_counter()
            proc, _ = _start_gateway(data_dir, [],
                                     {**env, "LLMLB_UVLOOP": "1"}, port=port)
            procs.append(proc)
            marker_path = Path(data_dir) / "update_pending.json"
            deadline = time.monotonic() + 60
            while marker_path.exists():
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError("the restarted gateway kept the "
                                         "marker")
                time.sleep(0.02)
            cleared_s = time.perf_counter() - restart_t
            gw_log = (Path(data_dir) / "gateway.log").read_text()
            loop_line = next((ln.split(": ", 1)[-1] for ln in
                              gw_log.splitlines() if "uvloop" in ln), None)
            want_line = ("uvloop event loop policy installed" if has_uvloop
                         else "LLMLB_UVLOOP=1 but uvloop is not installed; "
                              "using the stdlib asyncio event loop")
            if loop_line != want_line:
                raise AssertionError(f"uvloop ({has_uvloop}): the gateway "
                                     f"logged {loop_line!r}")
            token = _gw_json(gw + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            system = _gw_json(gw + "/api/system", headers=admin)
            history = [{k: v for k, v in h.items() if k != "ts"}
                       for h in system["update"]["history"]]
            if {"version": "v9.9.9", "post_restart": "healthy"} not in history:
                raise AssertionError(f"restarted: history {history}")
            deadline = time.monotonic() + 60
            while not any(e["name"] == "serve-bf16-up"
                          and e["status"] == "online" for e in
                          _gw_json(gw + "/api/endpoints",
                                   headers=admin)["endpoints"]):
                if time.monotonic() > deadline:
                    raise AssertionError("the restarted gateway never listed "
                                         "the engine online")
                time.sleep(0.05)

            # the assistant, its key from the environment
            body = json.dumps({"model": "llama-3-8b", "temperature": 0,
                               "max_tokens": 16, "messages": [
                                   {"role": "user", "content": a_content}]})
            spy = _EmitSpy(core)
            try:
                cli_env["LLMLB_API_KEY"] = key
                ran = cli("assistant", "curl",
                          f"curl {gw}/v1/chat/completions -d '{body}'")
                del cli_env["LLMLB_API_KEY"]
                via_ids = spy.last() if spy.ids else []
            finally:
                spy.close()
            try:
                out = json.loads(ran.stdout)
                reply = json.loads(out["body"])
            except (ValueError, KeyError) as e:
                raise AssertionError(f"assistant: exit {ran.returncode}, "
                                     f"{ran.stdout[-800:]} "
                                     f"{ran.stderr[-800:]}") from e
            if (ran.returncode, out["status"]) != (0, 200) or key in \
                    ran.stdout or via_ids != a_ids or (
                    reply["choices"][0]["message"]["content"],
                    reply["usage"]) != (a_direct["text"], a_direct["usage"]):
                raise AssertionError(
                    f"assistant chat: exit {ran.returncode}, status "
                    f"{out['status']}, usage {reply.get('usage')} against "
                    f"{a_direct['usage']}, ids share "
                    f"{_shared(via_ids, a_ids)} of 16")

            # stop
            stop_t = time.perf_counter()
            stopped = cli("stop", "--port", str(port)).stdout.strip()
            code = proc.wait(timeout=120)
            stop_s = time.perf_counter() - stop_t
            after = cli("status").stdout.strip()
            if (stopped, code, after) != ("stopped", 0, "not running"):
                raise AssertionError(f"stop: {stopped!r}, exit {code}, "
                                     f"status {after!r}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            stub.close()
    launches = {k: ca.LAUNCHES[k] - before.get(k, 0) for k in BF16_PATH}
    if not launches["flash_prefill"] or not launches["paged_flash_decode"]:
        raise AssertionError(f"the update block launched {launches}")
    stats = {"seconds": round(time.perf_counter() - t0, 3),
             "start_s": round(start_s, 3),
             "apply_to_exit_s": round(exit_s, 3),
             "restart_to_cleared_s": round(cleared_s, 3),
             "stop_s": round(stop_s, 3),
             "drained_ids_equal_direct": v_ids == d_ids,
             "drained_ids": len(v_ids), "frames": len(frames),
             "ids_at_apply": ids_at_apply, "ids_at_drain": ids_at_drain,
             "rejected_while_draining": list(rejected),
             "asset_bytes": len(stub.asset), "stub_hits": dict(stub.hits),
             "uvloop": has_uvloop, "uvloop_line": loop_line,
             "assistant_ids_equal_direct": via_ids == a_ids,
             "launches": launches}
    log(f"serve bf16 [{dev['smi']}]: update {json.dumps(stats)}")
    return stats


class _WsClient:
    """A WebSocket client on the standard library alone (not the port's
    gateway/http.py, so that it checks that server independently): the
    RFC 6455 handshake with its Sec-WebSocket-Accept checked, a thread
    reading server frames (text events kept in order, pings answered with
    masked pongs), and a masked close frame at the end."""

    GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

    def __init__(self, base: str, path: str, token: str):
        import base64
        import hashlib
        import os
        import socket

        host, port = base.split("://", 1)[1].rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=60)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
            f"Authorization: Bearer {token}\r\n\r\n".encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise AssertionError(f"/ws: closed in the handshake "
                                     f"{self.buf!r}")
            self.buf += chunk
        head, self.buf = self.buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin-1").split("\r\n")
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (ln.partition(":") for ln in lines[1:])}
        want = base64.b64encode(hashlib.sha1(
            key.encode() + self.GUID).digest()).decode()
        if not lines[0].startswith("HTTP/1.1 101") or \
                headers.get("sec-websocket-accept") != want or \
                headers.get("upgrade", "").lower() != "websocket":
            raise AssertionError(f"/ws handshake: {lines}")
        self.events: list[dict] = []
        self.close_code: int | None = None
        self.pings = 0
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise EOFError
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _send(self, opcode: int, payload: bytes) -> None:
        import os
        import struct

        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x80 | opcode]) + (
            bytes([0x80 | n]) if n < 126 else
            bytes([0x80 | 126]) + struct.pack("!H", n))
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        with self.lock:
            self.sock.sendall(head + mask + body)

    def _pump(self) -> None:
        import struct

        parts: list[bytes] = []
        try:
            while True:
                b0, b1 = self._exact(2)
                if b1 & 0x80:
                    raise AssertionError("/ws: a masked server frame")
                n = b1 & 0x7F
                if n == 126:
                    n = struct.unpack("!H", self._exact(2))[0]
                elif n == 127:
                    n = struct.unpack("!Q", self._exact(8))[0]
                payload, opcode = self._exact(n), b0 & 0x0F
                if opcode == 0x9:
                    self.pings += 1
                    self._send(0xA, payload)
                elif opcode == 0x8:
                    self.close_code = struct.unpack("!H", payload[:2])[0] \
                        if len(payload) >= 2 else 1005
                    return
                elif opcode in (0x0, 0x1):
                    parts.append(payload)
                    if b0 & 0x80:
                        self.events.append(json.loads(b"".join(parts)))
                        parts = []
        except (EOFError, OSError):
            return

    def wait_for(self, done, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while not done(list(self.events)) and time.monotonic() < deadline:
            time.sleep(0.05)

    def close(self) -> int | None:
        """A masked close with 1000; the server's close code back."""
        import struct

        try:
            self._send(0x8, struct.pack("!H", 1000))
        except OSError:
            pass
        self.thread.join(timeout=15)
        self.sock.close()
        return self.close_code


def _dashboard_block(gw: str, admin: dict, feed: "_WsClient",
                     endpoint_id: str, dev: dict) -> dict:
    """The dashboard and the TPS benchmark through the gateway, after the
    block's traffic; the socket's events checked last. Returns its
    figures."""
    import llmlb_tpu_torch

    from llmlb_tpu_torch.ops import cuda_attention as ca

    t0 = time.perf_counter()
    before = dict(ca.LAUNCHES)
    status, run = _gw_call("POST", gw + "/api/benchmarks/tps", {
        "model": "llama-3-8b", "requests": 16, "concurrency": 4,
        "max_tokens": 32}, admin)
    if status != 202:
        raise AssertionError(f"benchmark start: {status} {run}")
    deadline = time.monotonic() + 120
    while run.get("status") != "completed" and time.monotonic() < deadline:
        time.sleep(0.1)
        run = _gw_call("GET", gw + f"/api/benchmarks/tps/{run['run_id']}",
                       headers=admin)[1]
    bench_s = time.perf_counter() - t0
    launches = {k: ca.LAUNCHES[k] - before.get(k, 0) for k in BF16_PATH}
    per = run.get("per_endpoint") or {}
    if (run.get("status"), run.get("succeeded"), run.get("failed"),
            list(per), per.get(endpoint_id, {}).get("requests")) != (
            "completed", 16, 0, [endpoint_id], 16):
        raise AssertionError(f"the TPS benchmark: {run}")
    if not launches["flash_prefill"] or not launches["paged_flash_decode"]:
        raise AssertionError(f"the TPS benchmark launched {launches}")
    log(f"serve bf16 [{dev['smi']}]: gateway TPS benchmark (16 requests x "
        f"32 tokens, concurrency 4, temperature 0.7): "
        f"{run['throughput_rps']} req/s, latency p50 "
        f"{run['latency_ms']['p50']} p90 {run['latency_ms']['p90']} p99 "
        f"{run['latency_ms']['p99']} ms, mean_tps "
        f"{per[endpoint_id]['mean_tps']} tok/s a request, "
        f"{run['duration_s']} s; launches {launches}")

    # the dashboard's data routes, its SPA and its log tail
    overview = _gw_call("GET", gw + "/api/dashboard/overview",
                        headers=admin)[1]
    tps = _gw_call("GET", gw + "/api/dashboard/model-tps", headers=admin)[1]
    tail = _gw_call("GET", gw + "/api/dashboard/logs/lb?lines=2000",
                    headers=admin)[1]
    with urllib.request.urlopen(gw + "/metrics", timeout=60) as r:
        metrics = r.read().decode()
    v1_requests = sum(
        int(float(ln.rsplit(" ", 1)[1])) for ln in metrics.splitlines()
        if ln.startswith('llmlb_gateway_requests_total{route="/v1/'))
    static = Path(llmlb_tpu_torch.__file__).parent / "gateway" / \
        "dashboard_static"
    for name in ("", "/index.html", "/app.js", "/views.js", "/charts.js",
                 "/style.css"):
        with urllib.request.urlopen(gw + "/dashboard" + name,
                                    timeout=60) as r:
            body = r.read()
        want = (static / (name.lstrip("/") or "index.html")).read_bytes()
        if r.status != 200 or body != want:
            raise AssertionError(f"/dashboard{name}: {r.status}, "
                                 f"{len(body)} bytes against {len(want)}")
    if overview["endpoints"] != {"total": 1, "online": 1} or \
            overview["requests"]["today"] < 12:
        raise AssertionError(f"dashboard overview: {overview}")
    if not any(k.endswith(":llama-3-8b:chat") for k in tps["tps"]):
        raise AssertionError(f"dashboard model-tps: {tps}")
    if not tail["available"] or "/logs/" not in tail["path"] or not any(
            "gateway listening on 127.0.0.1:" in ln for ln in tail["lines"]):
        raise AssertionError(f"dashboard log tail: {tail['path']}, "
                             f"{len(tail['lines'])} lines")
    if "llmlb_gateway_dropped_events_total 0\n" not in metrics:
        raise AssertionError("dropped events: " + " ".join(
            ln for ln in metrics.splitlines() if "dropped_events" in ln))

    # the socket: every event the block's actions published
    def traces(evs):
        return [e for e in evs if e["type"] == "TraceCompleted"
                and e["data"]["path"].startswith("/v1/")]

    feed.wait_for(lambda evs: len(traces(evs)) >= v1_requests)
    code = feed.close()
    evs = feed.events
    kinds = [e["type"] for e in evs]
    card = [e["data"]["tpu"] for e in evs if e["type"] == "TelemetryUpdated"
            and e["data"]["tpu"].get("hbm_total_bytes", 0) > 0]
    counts = {k: kinds.count(k) for k in sorted(set(kinds))}
    if (kinds.count("EndpointRegistered"), kinds.count("EndpointRemoved"),
            len(traces(evs)), code) != (2, 1, v1_requests, 1000) or \
            not card or not counts.get("MetricsUpdated") or \
            not counts.get("TpsUpdated"):
        raise AssertionError(f"/ws/dashboard events {counts}, /v1 traces "
                             f"{len(traces(evs))} of {v1_requests}, close "
                             f"{code}")
    log(f"serve bf16 [{dev['smi']}]: gateway dashboard: /ws/dashboard "
        f"carried {counts} ({len(traces(evs))} TraceCompleted for the "
        f"{v1_requests} /v1 requests the gateway counted; telemetry "
        f"{card[-1]['hbm_used_bytes']} of {card[-1]['hbm_total_bytes']} "
        f"bytes, {card[-1]['accelerator']}), closed with {code}; overview "
        f"{overview['requests']['today']} requests today on "
        f"{overview['endpoints']['online']} online endpoint; /dashboard and "
        f"its 5 files the port's bytes; the log tail {len(tail['lines'])} "
        f"lines of {tail['path']}; dropped events 0; the dashboard block "
        f"{time.perf_counter() - t0:.1f} s")
    return {"bench_s": round(bench_s, 3), "launches": launches,
            "throughput_rps": run["throughput_rps"],
            "latency_ms": run["latency_ms"],
            "mean_tps": per[endpoint_id]["mean_tps"],
            "duration_s": run["duration_s"], "events": counts,
            "v1_requests": v1_requests,
            "seconds": round(time.perf_counter() - t0, 3)}


def _admin_block(gw: str, admin: dict, inf: dict, second_id: str,
                 mock: _CloudMock) -> float:
    """The gateway's client and operator API beside inference: one
    `openai:` and one `anthropic:` chat reach the mock and are counted in
    /api/metrics/cloud, and an `anthropic:` /v1/messages request passes
    through to it (the reference counts only the chat path); a model registered from the mock's repo has its
    manifest; an invitation registers a user who logs in; the second
    registration is renamed, then deleted; the audit log holds the block's
    /v1/messages requests and its chain verifies. Returns its seconds."""
    t0 = time.perf_counter()
    r = _gw_json(gw + "/v1/chat/completions", {
        "model": "openai:gpt-mock", "messages": [
            {"role": "user", "content": "hi"}]}, inf)
    if r["choices"][0]["message"]["content"] != "from the openai mock":
        raise AssertionError(f"openai: {r}")
    r = _gw_json(gw + "/v1/chat/completions", {
        "model": "anthropic:claude-mock", "messages": [
            {"role": "user", "content": "hi"}]}, inf)
    if r["choices"][0]["message"]["content"] != "from the anthropic mock":
        raise AssertionError(f"anthropic: {r}")
    r = _gw_json(gw + "/v1/messages", {
        "model": "anthropic:claude-mock", "max_tokens": 8,
        "messages": [{"role": "user", "content": "hi"}]}, inf)
    if r["content"][0]["text"] != "from the anthropic mock":
        raise AssertionError(f"anthropic /v1/messages: {r}")
    with urllib.request.urlopen(urllib.request.Request(
            gw + "/api/metrics/cloud", headers=admin), timeout=60) as resp:
        cloud = resp.read().decode()
    for provider in ("openai", "anthropic"):
        line = (f'llmlb_cloud_requests_total{{provider="{provider}",'
                f'status="200"}} 1')
        if line not in cloud or mock.hits[provider] != 1 + (
                provider == "anthropic"):
            raise AssertionError(f"cloud metrics: {cloud!r}, {mock.hits}")
    status, reg = _gw_call("POST", gw + "/api/models/register",
                           {"repo": _CloudMock.REPO}, admin)
    status2, manifest = _gw_call(
        "GET", gw + "/api/models/registry/llama-3-8b/manifest.json",
        headers=admin)
    if (status, reg.get("format"), reg.get("files"), status2) != (
            201, "safetensors", 4, 200) or \
            manifest["source_repo"] != _CloudMock.REPO:
        raise AssertionError(f"registry: {status} {reg}, {status2} {manifest}")
    status, inv = _gw_call("POST", gw + "/api/invitations",
                           {"role": "viewer"}, admin)
    status2, user = _gw_call("POST", gw + "/api/auth/register", {
        "code": inv.get("code"), "username": "smoke-viewer",
        "password": "viewer-pass-1"})
    token = _gw_json(gw + "/api/auth/login", {
        "username": "smoke-viewer", "password": "viewer-pass-1"})["token"]
    if (status, status2, user.get("user", {}).get("role")) != (
            201, 201, "viewer") or not token:
        raise AssertionError(f"invitation: {status} {inv}, {status2} {user}")
    status, renamed = _gw_call("PUT", gw + f"/api/endpoints/{second_id}",
                               {"name": "resume-renamed"}, admin)
    status2, deleted = _gw_call("DELETE",
                                gw + f"/api/endpoints/{second_id}",
                                headers=admin)
    listed = [e["name"] for e in _gw_call("GET", gw + "/api/endpoints",
                                          headers=admin)[1]["endpoints"]]
    if (status, renamed.get("name"), status2, deleted, listed) != (
            200, "resume-renamed", 200, {"deleted": second_id},
            ["serve-bf16"]):
        raise AssertionError(f"endpoint update/delete: {renamed} {deleted} "
                             f"{listed}")
    status, verify = _gw_call("POST", gw + "/api/audit-log/verify", {}, admin)
    status2, log_ = _gw_call("GET", gw + "/api/audit-log?path=/v1/messages",
                             headers=admin)
    paths = [e["path"] for e in log_["entries"]]
    if (status, verify, status2) != (200, {"ok": True, "error": None}, 200) \
            or len(paths) < 4:
        raise AssertionError(f"audit: {verify}, {len(paths)} /v1/messages "
                             "entries")
    return time.perf_counter() - t0


def _drain_block(server, label: str) -> dict:
    """On a server of the small engine (drain is one-way, so last): an
    armed stream decoding, POST /api/drain with grace 0; the stream's
    socket must close without [DONE] and its row park; a new chat gets 503
    with Retry-After; /api/health says draining."""
    import http.client
    import urllib.error

    base = "http://%s:%d" % server.server_address[:2]
    # 128 tokens fit the 256-position slot; the drain comes after 8
    resp = _post(base + "/v1/chat/completions",
                 _armed(f"Drain check for {label}.", 128, None))
    ids, done, cut = [], False, False
    lines = _sse_lines(resp)
    for data in lines:
        obj = json.loads(data)
        if obj.get("object") == "llmlb.replay":
            ids.extend(obj["tokens"])
            if len(ids) >= 8:
                break
    t0 = time.perf_counter()
    with _post(base + "/api/drain", {"grace_s": 0}) as r:
        if not json.loads(r.read())["draining"]:
            raise AssertionError("/api/drain did not start a drain")
    try:
        for data in lines:
            done |= data == b"[DONE]"
    except (OSError, http.client.HTTPException) as e:
        cut = type(e).__name__
    resp.close()
    server.drain.wait(60)
    cut_s = time.perf_counter() - t0
    info = server.drain.info()
    try:
        _post(base + "/v1/chat/completions",
              _armed("after the drain", 4, None))
        raise AssertionError("a chat was admitted while draining")
    except urllib.error.HTTPError as e:
        refused = (e.code, e.headers.get("Retry-After"),
                   json.loads(e.read())["error"]["code"])
    with urllib.request.urlopen(base + "/api/health", timeout=60) as r:
        health = json.loads(r.read())
    if done or info["parked"] != 1 or info["aborted_connections"] != 1:
        raise AssertionError(f"serve {label}: drain: [DONE] {done}, "
                             f"{info}")
    if refused[0] != 503 or not refused[1] or refused[2] != "draining":
        raise AssertionError(f"serve {label}: drain refused a chat with "
                             f"{refused}")
    if health["status"] != "draining" or not health["draining"][
            "draining"]:
        raise AssertionError(f"serve {label}: /api/health says "
                             f"{health['status']}")
    return {"drain_cut_s": cut_s, "committed": len(ids),
            "stream_end": cut or "closed", "retry_after": refused[1],
            "parked": info["parked"]}


def _small_engine_blocks(core, prompt: list[int], label: str, dev: dict,
                         core_kwargs: dict) -> dict:
    """One small engine over the same weights (2 slots of 256 positions;
    paged, EXHAUST_PAGES pages), built after the serving core's launch
    counts are read, so that none of its launches is counted: page
    exhaustion on it (paged), then the drain on a server over it. Each
    block's seconds under "block_s"."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    times: dict[str, float] = {}
    t0 = time.perf_counter()
    paged = core.page_pool is not None
    small = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=2, slot_capacity=256, eos_id=-1,
                       prefix_cache=False, **core_kwargs,
                       **({"kv_pages": EXHAUST_PAGES} if paged else {}))
    engine = Engine("llama-3-8b", small, ByteTokenizer(core.cfg.vocab_size))
    small.start()
    times["small_engine"] = round(time.perf_counter() - t0, 1)
    server = thread = None
    out: dict = {"block_s": times}
    try:
        if paged:
            out["exhaustion"] = _timed(times, "exhaustion", _page_exhaustion,
                                       small, prompt, label, dev)
        server, thread = start_server(engine)
        out["drain"] = _timed(times, "drain", _drain_block, server, label)
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.shutdown()
        del engine, small
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- checkpoints

CKPT_SHARDS = 4


def phase_checkpoint(dev: dict) -> dict:
    """The seed-0 random Llama-3-8B weights, generated on the card as the
    serve phases' engines generate them, written as a 4-shard bf16 HF
    checkpoint (model.safetensors.index.json, and a config.json rendered
    from the llama-3-8b preset) into a temporary directory of the
    checkout's build directory, after checking that its disk holds them.
    The bf16 and int8 serve phases serve from it; the directory goes after
    the int8 phase. Returns the directory, the generated tensors (the bf16
    phase holds its load against them, then drops them) and the bytes."""
    import math
    import os
    import shutil
    import tempfile

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.safetensors_io import save_sharded
    from llmlb_tpu_torch.engine.weights import hf_config, hf_tensors
    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.models import llama

    cfg = get_preset("llama-3-8b")
    nbytes = sum(math.prod(shape) * cfg.dtype.itemsize
                 for shape, _ in llama.param_shapes(cfg).values())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    free = shutil.disk_usage(build.BUILD_DIR).free
    if free < nbytes + 2**27:
        raise AssertionError(
            f"checkpoint: {free / 1e9:.2f} GB free under {build.BUILD_DIR}; "
            f"the bf16 checkpoint needs {nbytes / 1e9:.2f} GB")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    t0 = time.perf_counter()
    files = save_sharded(hf_tensors(params, cfg), tmp.name, CKPT_SHARDS)
    with open(os.path.join(tmp.name, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    os.sync()
    write_s = time.perf_counter() - t0
    log(f"checkpoint [{dev['smi']}]: seed-0 llama-3-8b weights generated on "
        f"the card in {gen_s:.1f} s, written as {len(files)} bf16 shards "
        f"({nbytes / 1e9:.2f} GB, {free / 1e9:.1f} GB free before) in "
        f"{write_s:.1f} s ({nbytes / write_s / 1e9:.2f} GB/s, device to "
        "disk, synced)")
    return {"tmp": tmp, "dir": tmp.name, "params": params, "bytes": nbytes,
            "write_s": write_s}


class _RssPeak:
    """While open, the peak of this process's resident set over its value at
    the start, sampled from /proc/self/statm every 5 ms on a thread (the
    page cache a load reads through is not counted: it is not resident in
    the process)."""

    def __enter__(self):
        import os

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def growth_gib(self) -> float:
        return (self.peak - self.start) / 2**30


def _checkpoint_engine(label: str, ckpt: dict, core_kwargs: dict, dev: dict):
    """The serving engine through Engine.from_checkpoint over the written
    checkpoint, with a ByteTokenizer (this machine has no `transformers`,
    which HFTokenizer and so the server's own --checkpoint path need; the
    CPU tests cover that path). Holds the config read back against the
    preset and the loaded leaves against the generated tensors (bf16) or
    against quantize_params of a bf16 load of the same checkpoint (int8:
    the streamed quantization is the core's own pass), bit for bit, and
    logs the load's seconds, GB/s and peak host RSS growth. Returns the
    engine and the load's numbers."""
    import torch

    from llmlb_tpu_torch.engine import service
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmlb_tpu_torch.engine.weights import load_checkpoint, load_config
    from llmlb_tpu_torch.quant import quantize_params

    cfg = get_preset("llama-3-8b")
    if load_config(ckpt["dir"]) != cfg:
        raise AssertionError(f"checkpoint: config.json reads back as "
                             f"{load_config(ckpt['dir'])}, not the preset")
    int8 = bool(core_kwargs.get("quantize"))
    out: dict = {}
    if int8:
        # the reference for the streamed int8 leaves: the core's pass over
        # a bf16 load of the same checkpoint
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = load_checkpoint(ckpt["dir"], cfg, device="cuda")
        torch.cuda.synchronize()
        out["bf16_again_s"] = time.perf_counter() - t0
        want = quantize_params(ref)
        del ref
    else:
        want = ckpt.pop("params")
    real = service.load_checkpoint

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            params = real(*args, **kwargs)
            torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
        out["rss_growth_gib"] = rss.growth_gib
        return params

    service.load_checkpoint = timed
    try:
        engine = service.Engine.from_checkpoint(
            ckpt["dir"], model_id="llama-3-8b", device="cuda",
            tokenizer=ByteTokenizer(cfg.vocab_size), seed=0,
            num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
            **core_kwargs)
    finally:
        service.load_checkpoint = real
    params = engine.core.params
    if sorted(params) != sorted(want):
        raise AssertionError(f"serve {label}: loaded leaves {sorted(params)}"
                             f", expected {sorted(want)}")
    differ = [k for k in want if not torch.equal(params[k], want[k])]
    del want
    if differ:
        raise AssertionError(f"serve {label}: loaded leaves {differ} differ "
                             "from " + ("quantize_params of the bf16 load"
                                        if int8 else "the generated tensors"))
    out["gb_s"] = ckpt["bytes"] / out["load_s"] / 1e9
    out["device_gib"] = engine.core.param_bytes / 2**30
    log(f"serve {label} [{dev['smi']}]: Engine.from_checkpoint: the config "
        f"read back is the preset; load_checkpoint"
        f"{' (quantize_weights: int8 per layer on the card)' if int8 else ''}"
        f" read {ckpt['bytes'] / 1e9:.2f} GB in {out['load_s']:.2f} s "
        f"({out['gb_s']:.2f} GB/s, {out['device_gib']:.2f} GiB on the card), "
        f"peak host RSS growth {out['rss_growth_gib']:.2f} GiB; every leaf "
        + ("equals quantize_params of a bf16 load of the checkpoint (that "
           f"load: {out['bf16_again_s']:.2f} s)" if int8 else
           "equals the generated tensor") + " bit for bit")
    return engine, out


# ------------------------------------------------------------ kv shipping

SHIP_AFTER = (16, 128)  # committed tokens of the migrations (128: bf16)
SHIP_NEW = 16  # new tokens after the resume
OFFLOAD_PROMPT, OFFLOAD_PAGES = 400, 6


class _RidRows:
    """On the engine thread: a copy of the KV rows [0, rows) of the row
    serving gateway id `rid` once it holds `min_tokens` committed tokens
    (between bursts). Wraps the core's _emit_fetched until close()."""

    def __init__(self, core, rid: str, min_tokens: int, rows: int):
        from llmlb_tpu_torch.engine.scheduler import gateway_rid

        self.core, self.kv = core, None
        emit = core._emit_fetched

        def spy(tokens, active):
            emit(tokens, active)
            for slot_id, slot in enumerate(core.slots):
                r = slot.request
                if (self.kv is None and r is not None
                        and gateway_rid(r.request_id) == rid
                        and len(slot.out_tokens) >= min_tokens):
                    self.kv = _row_kv(core, slot_id, rows)

        core._emit_fetched = spy

    def close(self) -> None:
        del self.core._emit_fetched


def _resume_stream(url: str, body: dict, rid: str, committed: int):
    """POST /v1/resume, read to the end: (replay ids, ms from the POST to
    the first replay frame past the committed ids)."""
    ids, first = [], None
    t0 = time.perf_counter()
    with _post(url + "/v1/resume", body, headers={"X-Request-Id": rid}
               ) as resp:
        for data in _sse_lines(resp):
            if data == b"[DONE]":
                continue
            obj = json.loads(data)
            if obj.get("object") == "llmlb.replay":
                ids.extend(obj["tokens"])
                if first is None and len(ids) > committed:
                    first = (time.perf_counter() - t0) * 1e3
    return ids, first


def _migration(core, adopter, base, adopter_base, encode, label: str,
               c: int, dev: dict) -> dict:
    """An armed stream decoding on the serving core, parked after `c`
    committed ids by POST /v1/kv/export {"park": true}, then /v1/resume
    with its kv_pages on the adopter: its ids must be the uninterrupted
    run's, the adopter must launch no prefill or extend kernel, and the
    adopted row's KV rows at the resume point must be the uninterrupted
    run's bit for bit. Then the same resume without pages (the replay),
    for its latency. The adopter's launches are taken out of the counts
    and returned under "adopter_launches"."""
    import http.client

    import torch

    from llmlb_tpu_torch.engine import scheduler, service
    from llmlb_tpu_torch.engine.kv_transfer import parse_kv_payload

    content = f"Ship check {label} {c}: list the planets."
    body = _armed(content, c + SHIP_NEW, None)
    n = len(encode([{"role": "user", "content": content}]))
    margin = 24  # the ledger may run past c by a burst or two
    # the uninterrupted run, its rows copied past any resume point
    full_rid = f"kvfull-{c}"
    watch = _RidRows(core, full_rid, c + margin, n + c + margin)
    try:
        ids = []
        with _post(base + "/v1/chat/completions",
                   _armed(content, c + margin + 16, None),
                   headers={"X-Request-Id": full_rid}) as resp:
            for data in _sse_lines(resp):
                if data != b"[DONE]":
                    obj = json.loads(data)
                    if obj.get("object") == "llmlb.replay":
                        ids.extend(obj["tokens"])
    finally:
        watch.close()
    full, full_kv = ids[:c + SHIP_NEW], watch.kv
    if full_kv is None:
        raise AssertionError(f"serve {label}: no KV copy of the "
                             "uninterrupted run")
    # the stream to move, parked after c committed ids
    rid = f"kvmig-{c}"
    host, port = base[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json", "X-Request-Id": rid})
    committed: list[int] = []
    for data in _sse_lines(conn.getresponse()):
        obj = json.loads(data)
        if obj.get("object") == "llmlb.replay":
            committed.extend(obj["tokens"])
            if len(committed) >= c:
                break
    gathers, serializes, parses = [], [], []
    capture = core._capture_kv

    def timed_capture(pages, tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kvp = capture(pages, tokens)
        gathers.append((time.perf_counter() - t0) * 1e3)
        return kvp

    def timer(fn, into):
        def timed(*args):
            t0 = time.perf_counter()
            result = fn(*args)
            into.append((time.perf_counter() - t0) * 1e3)
            return result
        return timed

    serialize, parse = scheduler.serialize_kv_pages, service.parse_kv_payload
    core._capture_kv = timed_capture
    scheduler.serialize_kv_pages = timer(serialize, serializes)
    try:
        t0 = time.perf_counter()
        with _post(base + "/v1/kv/export", {"request_id": rid,
                                            "park": True}) as r:
            out = json.loads(r.read())
        export_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del core._capture_kv
        scheduler.serialize_kv_pages = serialize
    conn.close()  # the client leaves the origin: its copy is cancelled
    # the origin re-admits the parked request until the cancel reaches it;
    # wait for that, so that the adopter's launches below are its own
    _wait_idle(core)
    pages = out["kv_pages"]
    kvp = parse_kv_payload(pages)
    m = len(committed)
    if committed != full[:m] or not c <= m <= c + margin:
        raise AssertionError(f"serve {label}: the moved stream's {m} "
                             "committed ids are not the uninterrupted run's")
    lands = []
    land = adopter._land_kv_pages

    def timed_land(k, fresh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        land(k, fresh)
        torch.cuda.synchronize()
        lands.append((time.perf_counter() - t0) * 1e3)

    adopter._land_kv_pages = timed_land
    service.parse_kv_payload = timer(parse, parses)
    before = adopter.prefill_dispatches
    rows = _RidRows(adopter, rid, m + 1, n + m)
    try:
        with _Uncounted() as landed:
            got, landed_ms = _resume_stream(
                adopter_base, {**body, "committed_ids": committed,
                               "kv_pages": pages}, rid, m)
    finally:
        rows.close()
        del adopter._land_kv_pages
        service.parse_kv_payload = parse
    prefills = adopter.prefill_dispatches - before
    prefill_launches = {k: n for k, n in landed.launches.items()
                        if k not in DECODE_KERNELS}
    if got != full or prefills != 0 or prefill_launches or len(lands) != 1:
        raise AssertionError(
            f"serve {label}: the adopted stream shares {_shared(got, full)} "
            f"of {len(full)} ids with the uninterrupted run; {prefills} "
            f"prefill dispatches, launches {landed.launches} and "
            f"{len(lands)} lands on the adopter")
    where = _kv_first_difference(rows.kv, _kv_head(full_kv, n + m))
    if where is not None:
        raise AssertionError(f"serve {label}: the adopted row's KV rows first "
                             f"differ from the uninterrupted run's at {where}")
    # the replay of the same committed ids, for its latency
    before = adopter.prefill_dispatches
    with _Uncounted() as replayed:
        again, replay_ms = _resume_stream(
            adopter_base, {**body, "committed_ids": committed},
            f"kvrep-{c}", m)
    if again != full or adopter.prefill_dispatches == before:
        raise AssertionError(f"serve {label}: the replayed resume shares "
                             f"{_shared(again, full)} of {len(full)} ids")
    wire = len(pages["data"])
    res = {"committed": m, "tokens": kvp.header.tokens,
           "pages": kvp.header.num_pages, "bytes": kvp.nbytes,
           "wire_bytes": wire, "export_ms": export_ms,
           "gather_ms": gathers[0], "serialize_ms": serializes[0],
           "parse_ms": parses[0], "land_ms": lands[0],
           "first_new_ms": landed_ms, "replay_first_new_ms": replay_ms,
           "adopter_launches": {"landed": landed.launches,
                                "replay": replayed.launches}}
    log(f"serve {label} [{dev['smi']}]: KV migration after {m} committed ids "
        f"({n}-token prompt): POST /v1/kv/export (park) answered in "
        f"{export_ms:.1f} ms (gather {gathers[0]:.2f} ms, serialize "
        f"{serializes[0]:.1f} ms; {kvp.header.num_pages} pages, "
        f"{kvp.nbytes / 2**20:.1f} MiB, {wire / 2**20:.1f} MiB of base64); "
        f"/v1/resume with the pages on a second core: parse "
        f"{parses[0]:.1f} ms, land {lands[0]:.2f} ms, first new token "
        f"{landed_ms:.1f} ms after the POST (the replay of the same ids: "
        f"{replay_ms:.1f} ms); its {len(full)} ids the uninterrupted run's, "
        f"0 prefill dispatches (the landed resume's launches "
        f"{landed.launches}, the replay's {replayed.launches}), its KV rows "
        f"[0, {n + m}) the uninterrupted run's bit for bit")
    return res


def _offload_block(core, label: str, dev: dict, core_kwargs: dict) -> dict:
    """The host-RAM tier on a small engine over the same weights (2 slots of
    512 positions, OFFLOAD_PAGES pages, 2 GiB of host budget): prompt A
    cold (its 384-token head donated), A again (a live hit), B (its pages
    evict A's entry, which spills to the host), A again: the tier lands
    A's head back, and that hit's first-token logits must equal the live
    hit's bit for bit, its tokens the cold run's; the counters must be the
    traffic's. (A's cold run captures the bursts' graph key, so the restored
    run's first token waits for no capture.)"""
    import numpy as np

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    rng = np.random.default_rng(7)
    a, b = (rng.integers(300, core.cfg.vocab_size, OFFLOAD_PROMPT).tolist()
            for _ in range(2))
    small = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=2, slot_capacity=512, eos_id=-1,
                       kv_pages=OFFLOAD_PAGES, kv_offload_bytes=2 << 30,
                       **core_kwargs)
    small.start()
    spy = _LogitSpy(small)
    try:
        t0 = time.perf_counter()
        runs = [_collect(_submit(small, p, 8))[0] for p in (a, a, b)]
        first: list = []
        t1 = time.perf_counter()
        restored = _collect(_submit(small, a, 8), first)[0]
        restore_ms = (first[0] - t1) * 1e3
        wall = time.perf_counter() - t0
        _wait_idle(small)
        live, again = spy.get(a, None)[1:3]
        info, st = small.kv_transfer_info(), small.stats()
    finally:
        spy.close()
        small.stop()
    import torch

    p = st.prefix
    counts = {"ship": info["ship_total"], "restored": info["restored_total"],
              "spills": info["offload"]["spills"],
              "tier_hits": info["offload"]["hits"],
              "hits": p.prefix_hits_total, "misses": p.prefix_misses_total,
              "evictions": p.prefix_evictions_total,
              "insertions": p.prefix_insertions_total}
    # A's donation and B's (each evicted for the other's pages: two
    # spills), and A's restored 384-token head, which its finish then
    # covers; two misses (A cold, B), two hits (live, restored)
    want = {"ship": 2, "restored": 1, "spills": 2, "tier_hits": 1,
            "hits": 2, "misses": 2, "evictions": 2, "insertions": 3}
    if counts != want:
        raise AssertionError(f"serve {label}: offload counters {counts}, the "
                             f"traffic implies {want}")
    if not torch.equal(live, again) or not restored == runs[0] == runs[1]:
        raise AssertionError(
            f"serve {label}: the restored hit's logits differ from the live "
            f"hit's by max |diff| {(live - again).abs().max().item():.3e}, "
            f"or its tokens from the cold run's")
    log(f"serve {label} [{dev['smi']}]: offload tier ({OFFLOAD_PAGES} pages, "
        f"{OFFLOAD_PROMPT}-token prompts): a prefix evicted under page "
        f"pressure spilled to host RAM and restored; the restored hit's "
        f"first-token logits equal the live hit's bit for bit, its 8 tokens "
        f"the cold run's; first token {restore_ms:.1f} ms after submit; "
        f"counters {counts}; {wall:.1f} s")
    return {"counts": counts, "restore_first_ms": restore_ms}


# ------------------------------------------------------ live-stream rebalance

REBALANCE_TOKENS = 64  # the moved stream's greedy ids
REBALANCE_AFTER = 16  # its ids on the origin before the planner ticks
# The reference's own knobs: the planner and the probe tick only when the
# block asks (its loop and the probe loop sleep an hour); one live stream
# of 8 slots (0.125) is above the high band, an idle engine at the low
# band; every request misses a 1 us TTFT target, so goodput is 0 and the
# SLO gate is open. A 1 s stream window: a new stream's last migration
# stamp is 0.0 on the monotonic clock, so with the default 60 s window no
# stream moves on a host up less than a minute (ROADMAP C21).
REBALANCE_ENV = {"LLMLB_REBALANCE": "1", "LLMLB_REBALANCE_INTERVAL": "3600",
                 "LLMLB_HEALTH_CHECK_INTERVAL": "3600",
                 "LLMLB_REBALANCE_HIGH": "0.1", "LLMLB_REBALANCE_LOW": "0.05",
                 "LLMLB_REBALANCE_STREAM_WINDOW": "1",
                 "LLMLB_SLO_TTFT_MS": "0.001", "LLMLB_FAULTS": "[]"}


def _runs_native(pid: int) -> bool:
    """Whether process `pid` has the port's native library of this
    checkout mapped: a gateway's router core, SSE scanner and audit chain
    then run on it (a gateway whose library was missing runs on the Python
    twins and maps none)."""
    from llmlb_tpu_torch import native

    with open(f"/proc/{pid}/maps") as f:
        return str(native.lib_path()) in f.read()


class _ByThread:
    """The port's kernel launches inside the block by the thread that made
    them (each engine launches on its own step-loop thread; a graph replay
    adds its capture's launches there)."""

    def __enter__(self):
        from llmlb_tpu_torch.kernels import build

        self.build, self.counts = build, {}
        launch, add = build.launch, build.add_launches

        def mine() -> dict:
            return self.counts.setdefault(threading.get_ident(), {})

        def counted_launch(name, *args):
            launch(name, *args)
            mine()[name] = mine().get(name, 0) + 1

        def counted_add(counts, times=1):
            add(counts, times)
            for k, n in counts.items():
                mine()[k] = mine().get(k, 0) + times * n

        self._saved = launch, add
        build.launch, build.add_launches = counted_launch, counted_add
        return self

    def __exit__(self, *exc):
        self.build.launch, self.build.add_launches = self._saved

    def of(self, core) -> dict:
        return {k: n for k, n in self.counts.get(core._thread.ident,
                                                 {}).items() if n}


class _StreamIds:
    """By gateway request id, on one core: the committed ids an adopted
    request came in with, the ids the core emitted, and when it emitted
    its first. Wraps the core's submit and _emit until close()."""

    def __init__(self, core):
        from llmlb_tpu_torch.engine.flightrec import gateway_rid

        self.core, self.parked, self.ids, self.first = core, {}, {}, {}
        submit, emit = core.submit, core._emit

        def watched(request):
            if request.parked is not None:
                self.parked[gateway_rid(request.request_id)] = list(
                    request.parked.tokens)
            return submit(request)

        def spy(slot_id, token):
            rid = gateway_rid(core.slots[slot_id].request.request_id)
            self.first.setdefault(rid, time.perf_counter())
            self.ids.setdefault(rid, []).append(token)
            emit(slot_id, token)

        core.submit, core._emit = watched, spy

    def close(self) -> None:
        del self.core.submit, self.core._emit


class _InProcGateway:
    """The port's gateway in this process, on an event loop of its own
    thread, built as `serve` builds it (build_app_state on the primary of
    one worker: health checker, maintenance and rebalancer started) with
    `env` added to the environment while it reads its configuration."""

    def __init__(self, data_dir: str, env: dict):
        import asyncio
        import os

        from llmlb_tpu_torch.gateway.app import create_app
        from llmlb_tpu_torch.gateway.app_state import build_app_state
        from llmlb_tpu_torch.gateway.config import ServerConfig
        from llmlb_tpu_torch.gateway.http import web
        from llmlb_tpu_torch.gateway.worker import WorkerInfo

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        env = {"LLMLB_DATA_DIR": data_dir,
               "LLMLB_LOG_DIR": os.path.join(data_dir, "logs"),
               "LLMLB_ADMIN_PASSWORD": GATEWAY_PASSWORD, **env}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)

        async def up():
            state = await build_app_state(ServerConfig.from_env(),
                                          worker=WorkerInfo(0, 1))
            runner = web.AppRunner(create_app(state), shutdown_timeout=1.0)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            return state, runner

        try:
            self.state, self.runner = self.run(up())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.url = "http://127.0.0.1:%d" % self.runner.addresses[0][1]

    def run(self, coro, timeout: float = 600):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        try:
            self.run(self.runner.cleanup(), 60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


def _moved_stream(gw, inf: dict, content: str, origin_ids: "_StreamIds",
                  act) -> tuple[dict, str]:
    """A greedy REBALANCE_TOKENS chat stream through `gw` on a thread of
    its own; once the origin has emitted REBALANCE_AFTER of its ids,
    `act(rid)` runs. Returns the stream's {text, usage, finish, model}
    and its request id."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_chat, gw.url, content, REBALANCE_TOKENS, True,
                          headers=inf)
        deadline = time.monotonic() + 120
        rid = None
        while time.monotonic() < deadline and not fut.done():
            streams = gw.state.streams  # the gateway's thread writes it
            with streams._lock:
                live = list(streams._streams)
            rid = rid or (live[0] if live else None)
            if rid is not None and len(origin_ids.ids.get(rid, ())) >= \
                    REBALANCE_AFTER:
                break
            time.sleep(0.002)
        if rid is None or fut.done():
            raise AssertionError(
                f"rebalance: the stream ended or never registered before "
                f"{REBALANCE_AFTER} ids (rid {rid})")
        act(rid)
        return fut.result(timeout=600), rid


def _rebalance_block(core, engine, base: str, adopter, adopter_base: str,
                     dev: dict) -> dict:
    """The port's gateway (in this process, on the native core built from
    this checkout) in front of the serving engine and the second one: the
    second is registered first and serves a 4-token warm-up (an SLO miss:
    goodput 0), then the serving engine (unmeasured: it takes the next
    stream). A greedy REBALANCE_TOKENS chat stream starts on the serving
    core; after REBALANCE_AFTER ids the health checker probes both engines
    and the planner ticks twice (hysteresis): one hotspot directive, and
    the pump moves the live stream through POST /v1/kv/export {"park":
    true} and /v1/resume with the pages. The client's stream is one
    stream with the direct path's text and usage; the origin's ids are a
    prefix of the direct ids, the adopter's committed ids plus its own are
    all of them, with no prefill dispatch and no prefill or extend launch
    there; /metrics counts hotspot/success 1 and no resume. Then the second
    engine drains and a second stream, directed to it, is refused: it stays
    on its origin with the direct path's ids, hotspot/refused 1. The
    adopter's launches are taken out of the counts."""
    import os
    import tempfile

    from llmlb_tpu_torch.gateway.token_accounting import (
        StreamingTokenAccumulator,
    )

    t0 = time.perf_counter()
    _wait_idle(core)
    _wait_idle(adopter)
    contents = ["Rebalance check: count the moons of Jupiter.",
                "Rebalance refusal: name the rivers of Europe."]
    spy = _EmitSpy(core)
    try:
        direct = []
        for content in contents:
            direct.append((_chat(base, content, REBALANCE_TOKENS, True),
                           spy.last()))
    finally:
        spy.close()
    ids = (_StreamIds(core), _StreamIds(adopter))
    parks: list[float] = []
    request_park = core.request_park

    def stamped_park(rid):
        parks.append(time.perf_counter())
        request_park(rid)

    core.request_park = stamped_park
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="llmlb-rb-") as data_dir, \
            _ByThread() as by_thread:
        gw = _InProcGateway(data_dir, REBALANCE_ENV)
        try:
            st, rb = gw.state, gw.state.rebalancer
            native = {"router": st.load_manager._rc is not None,
                      "sse": StreamingTokenAccumulator()._native is not None,
                      "mapped": _runs_native(os.getpid())}
            if not all(native.values()) or rb is None:
                raise AssertionError(f"rebalance: the gateway runs on the "
                                     f"Python twins ({native}) or has no "
                                     f"planner ({rb})")
            token = _gw_json(gw.url + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            inf = {"Authorization": "Bearer " + _gw_json(
                gw.url + "/api/api-keys", {"name": "smoke-rb"},
                admin)["api_key"]}
            target = _gw_json(gw.url + "/api/endpoints", {
                "base_url": adopter_base, "name": "rebalance-target"}, admin)
            warm = _chat(gw.url, "Rebalance warm-up.", 4, False, headers=inf)
            origin = _gw_json(gw.url + "/api/endpoints", {
                "base_url": base, "name": "rebalance-origin"}, admin)
            for ep in (target, origin):
                if (ep["endpoint_type"], ep["status"]) != ("tpu", "online"):
                    raise AssertionError(f"rebalance registration: {ep}")
            before = adopter.prefill_dispatches
            plan: dict = {}

            def tick(rid):
                async def probe_and_tick():
                    await st.health_checker.check_all()
                    scores = {ep.id: rb.score(ep) for ep in rb._resumable()}
                    rb.tick()
                    first = rb.directives_total
                    rb.tick()
                    return scores, first
                handle = st.streams._streams[rid]
                plan.update(origin=handle.endpoint_id,
                            adopter_before=by_thread.of(adopter),
                            tick_t=time.perf_counter(),
                            ids_at_tick=len(ids[0].ids.get(rid, ())))
                plan["scores"], plan["first_tick"] = gw.run(probe_and_tick())
                plan["directives"] = rb.directives_total
                plan["tick_ms"] = (time.perf_counter() - plan["tick_t"]) * 1e3
                plan["ids_after_tick"] = len(ids[0].ids.get(rid, ()))

            moved, rid = _moved_stream(gw, inf, contents[0], ids[0], tick)
            prefills = adopter.prefill_dispatches - before
            summary = st.metrics.summary()
            with urllib.request.urlopen(gw.url + "/metrics",
                                        timeout=60) as r:
                metrics = r.read().decode()
            d_out, d_ids = direct[0]
            got_origin = ids[0].ids.get(rid, [])
            committed = ids[1].parked.get(rid)
            adopted = ids[1].ids.get(rid, [])
            # the adopter's launches from the tick on (its warm-up
            # request's prefill was before)
            adopter_launches = {
                k: n - plan["adopter_before"].get(k, 0)
                for k, n in by_thread.of(adopter).items()
                if n != plan["adopter_before"].get(k, 0)}
            bad = [k for k in adopter_launches if k not in DECODE_KERNELS]
            if (plan["origin"] != origin["id"] or plan["first_tick"] != 0
                    or plan["directives"] != 1):
                raise AssertionError(f"rebalance: the stream started on "
                                     f"{plan['origin']} (origin "
                                     f"{origin['id']}); planner {plan}")
            if (moved != d_out or got_origin != d_ids[:len(got_origin)]
                    or committed is None
                    or committed + adopted != d_ids or prefills or bad):
                raise AssertionError(
                    f"rebalance: the moved stream {moved['usage']} against "
                    f"the direct {d_out['usage']}; origin ids "
                    f"{len(got_origin)}, adopter committed "
                    f"{committed and len(committed)} + {len(adopted)} "
                    f"(equal: {(committed or []) + adopted == d_ids}); "
                    f"adopter prefills {prefills}, launches "
                    f"{adopter_launches}; migrations "
                    f"{summary['rebalance_migrations']}, resumes "
                    f"{summary['stream_resumes']}; plan {plan}; adopter "
                    f"requests {list(ids[1].ids)} parked "
                    f"{list(ids[1].parked)}; parks {len(parks)}")
            want = ('llmlb_gateway_rebalance_migrations_total'
                    '{reason="hotspot",outcome="success"} 1')
            if want not in metrics or summary["stream_resumes"] != {} or \
                    summary["rebalance_migrations"] != {"hotspot/success": 1}:
                raise AssertionError(
                    "rebalance: /metrics " + " ".join(
                        ln for ln in metrics.splitlines()
                        if "rebalance" in ln or "resume" in ln))
            park_ms = (ids[1].first[rid] - parks[-1]) * 1e3
            out.update(committed=len(committed), adopted=len(adopted),
                       origin_ids=len(got_origin),
                       ids_at_tick=plan["ids_at_tick"],
                       tick_to_first_ms=(ids[1].first[rid] - plan["tick_t"])
                       * 1e3,
                       park_to_first_adopted_ms=park_ms,
                       scores={("origin" if k == origin["id"] else "target"):
                               round(v, 4) for k, v in plan["scores"].items()},
                       warm_usage=warm["usage"],
                       adopter_launches=adopter_launches, native=native)
            # the refusal: the second engine drains, so it refuses adopts
            _post(adopter_base + "/api/drain", {"grace_s": 0}).read()
            gw.run(st.health_checker.check_all())
            before_ids = len(ids[0].ids)

            def direct_it(rid):
                handle = st.streams._streams[rid]
                plan["refused_origin"] = handle.endpoint_id

                async def mark():
                    return st.streams.apply_directive(
                        handle.endpoint_id, target["id"], "hotspot", 1, 2)
                plan["marked"] = gw.run(mark())

            kept, rid2 = _moved_stream(gw, inf, contents[1], ids[0],
                                       direct_it)
            summary = st.metrics.summary()
            d_out, d_ids = direct[1]
            if (plan["refused_origin"] != origin["id"] or plan["marked"] != 1
                    or kept != d_out or ids[0].ids.get(rid2) != d_ids
                    or rid2 in ids[1].ids or len(ids[0].ids) != before_ids + 1
                    or summary["rebalance_migrations"] != {
                        "hotspot/success": 1, "hotspot/refused": 1}
                    or summary["stream_resumes"] != {}):
                raise AssertionError(
                    f"rebalance refusal: {plan}; kept {kept['usage']} "
                    f"against {d_out['usage']}; origin ids "
                    f"{len(ids[0].ids.get(rid2) or [])}; "
                    f"{summary['rebalance_migrations']} "
                    f"{summary['stream_resumes']}")
        finally:
            del core.request_park
            for spy_ in ids:
                spy_.close()
            gw.close()
    launches = {"origin": by_thread.of(core), "adopter": by_thread.of(adopter)}
    # the adopter's launches are not the main path's
    by_thread.build.add_launches(launches["adopter"], times=-1)
    out.update(launches=launches, seconds=time.perf_counter() - t0)
    log(f"serve bf16 [{dev['smi']}]: rebalance: the port's gateway (native "
        f"router core, SSE scanner and chain hash: {native}) moved a live "
        f"{REBALANCE_TOKENS}-token stream from the serving engine to the "
        f"second one after {out['ids_at_tick']} ids on the planner's own "
        f"ticks (scores {out['scores']}, bands 0.1/0.05, goodput 0): the "
        f"adopter took {out['committed']} committed ids with the shipped "
        f"pages and emitted {out['adopted']}, 0 prefill dispatches; the "
        f"client's text and usage the direct path's; park to first adopted "
        f"token {park_ms:.1f} ms (tick to it {out['tick_to_first_ms']:.1f} "
        f"ms); /metrics hotspot/success 1, no resume; a second stream "
        f"directed to the drained engine was refused and stayed on its "
        f"origin with the direct ids (hotspot/refused 1)")
    log(f"serve bf16 [{dev['smi']}]: rebalance launches: origin "
        f"{launches['origin']}, adopter {launches['adopter']} (taken out of "
        f"the counts)")
    log(f"serve bf16 [{dev['smi']}]: rebalance sub-block took "
        f"{out['seconds']:.1f} s")
    return out


def _kv_ship(core, engine, base: str, label: str, dev: dict,
             core_kwargs: dict, sweep: bool) -> dict:
    """KV shipping on the serving core: a second EngineCore over the same
    params tensors (no weight copy; its own KV pool) behind a server of
    its own takes the migrations of SHIP_AFTER committed ids (16; and 128
    with `sweep`); in bf16 then the rebalance sub-block, the port's
    gateway in front of both servers. The serving core's launches (the
    streams it serves and parks, the export's gather) stay counted; the
    adopter's are taken out and logged on a line of their own."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    adopter = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                         num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                         **core_kwargs)
    adopt_engine = Engine("llama-3-8b", adopter,
                          ByteTokenizer(core.cfg.vocab_size))
    adopter.start()
    server, thread = start_server(adopt_engine)
    adopter_base = "http://%s:%d" % server.server_address[:2]
    out: dict = {}
    try:
        _wait_idle(core)  # the adopter's launches below are its own
        # capture the adopter's decode graph key (window 256, unseeded)
        # first: a key's first burst waits for its capture, which would
        # otherwise land in the first migration's latency
        with _Uncounted() as warm:
            _collect(_submit(adopter, engine.encode_chat(
                [{"role": "user", "content": "warm"}]), 16))
        out["migrations"] = [
            _migration(core, adopter, base, adopter_base, engine.encode_chat,
                       label, c, dev)
            for c in (SHIP_AFTER if sweep else SHIP_AFTER[:1])]
        if label == "bf16":
            # the gateway's planner moves a live stream the same way (its
            # adopter launches are taken out inside; the second engine
            # ends drained)
            out["rebalance"] = _rebalance_block(core, engine, base, adopter,
                                                adopter_base, dev)
        total = dict(warm.launches)
        for mig in out["migrations"]:
            for part in mig["adopter_launches"].values():
                for k, n in part.items():
                    total[k] = total.get(k, 0) + n
        out["adopter_launches"] = total
        log(f"serve {label}: the adopter's launches (its warm-up, landed "
            f"and replayed resumes; not in the main path's counts) {total}; "
            f"its decode graph keys after its landed and replayed rows: "
            f"{sorted(adopter.decode_graph_info()['keys'])}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        adopt_engine.shutdown()
        del adopt_engine, adopter
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- structured outputs

# The structured phase's schemas: tests/engine/test_preemption.py's bounded
# SCHEMA (85 DFA states) and tests/gateway/test_structured_gateway.py's (38):
# with the free row, 124 rows of the 130 the 64 MiB table holds at Llama-3's
# vocabulary (0.49 MiB a row); json_object (1734 states, 848 MiB) never fits.
STRUCT_PREEMPT = {"type": "object",
                  "properties": {"name": {"type": "string", "maxLength": 8},
                                 "n": {"enum": [0, 1, 2, 3]}},
                  "required": ["name", "n"]}
STRUCT_GATEWAY = {"type": "object",
                  "properties": {"city": {"enum": ["sf", "nyc"]},
                                 "celsius": {"type": "boolean"}},
                  "required": ["city", "celsius"]}
# the fused block's rows: (content, schema name or None for a free row)
STRUCT_ROWS = ([(f"Structured {i}: describe the user.", "preempt")
                for i in range(4)]
               + [(f"Structured {i}: the weather in a city.", "gateway")
                  for i in range(2)]
               + [(f"Structured free {i}: say anything.", None)
                  for i in range(2)])
STRUCT_CAPACITY, STRUCT_TOKENS, STRUCT_FREE_TOKENS = 1024, 128, 64
STRUCT_OBJECT_TOKENS = 32  # the json_object request's max_tokens
STRUCT_PARK_AT = 4  # the victim's and the migrated row's tokens before


def _st_spec(schema) -> dict:
    return {"type": "json_schema", "schema": schema}


def _st_request(engine, content: str, spec: dict | None, max_tokens: int,
                rid: str | None = None, **sampling):
    """A request straight to the structured core, its constraint compiled
    by the engine's compiler (an LRU hit after the first)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    sp = SamplingParams(max_tokens=max_tokens, constraint=spec, **sampling)
    req = Request(prompt_ids=engine.encode_chat(
        [{"role": "user", "content": content}]), sampling=sp,
        compiled_constraint=(engine.constraint_compiler.compile_spec(spec)
                             if spec is not None else None))
    if rid is not None:
        req.request_id = rid
    req.events = _StampedEvents()
    return req


class _StampedEvents(queue.SimpleQueue):
    """A request's event queue that stamps each token as the engine puts
    it, on the engine thread at its fetch, not when a reader wakes."""

    def __init__(self):
        super().__init__()
        self.stamps: list[float] = []

    def put(self, item, block=True, timeout=None):
        if item[0] == "token":
            self.stamps.append(time.monotonic())
        super().put(item, block, timeout)


def _st_collect(request) -> tuple[list[int], str, float, list[float]]:
    """(ids, finish reason, TTFT s, the engine's stamps of the ids) of a
    request made by _st_request."""
    ids = []
    while True:
        kind, value = request.events.get(timeout=600)
        if kind == "token":
            ids.append(int(value))
        elif kind == "done":
            break
        else:
            raise RuntimeError(f"engine error: {value}")
    stamps = request.events.stamps
    return ids, value, stamps[0] - request.submitted_at, stamps


# the ids of one fetch are put within the emit loop; fetches are at least
# a decode step (~10 ms) apart
FETCH_GAP_S = 0.002


def _st_fetches(stamps: list[float]) -> list[list]:
    """A stream's stamps grouped by fetch: [ids, stamp of the last]."""
    fetches: list[list] = []
    for t in stamps:
        if fetches and t - fetches[-1][1] < FETCH_GAP_S:
            fetches[-1] = [fetches[-1][0] + 1, t]
        else:
            fetches.append([1, t])
    return fetches


def _st_rate(stamps: list[float], n: int) -> float:
    """Steady decode tokens/s of a stream over the whole fetches among its
    first n ids: the ids after the first fetch over the time from it to
    the last. The first fetch is left out, since it delivers the first
    token together with a whole burst's ids."""
    fetches, total = [], 0
    for c, t in _st_fetches(stamps):
        if total + c > n:
            break
        fetches.append((c, t))
        total += c
    if len(fetches) < 2:
        return 0.0
    return (sum(c for c, _ in fetches[1:])
            / (fetches[-1][1] - fetches[0][1]))


def _st_run(core, requests: list) -> list:
    for r in requests:
        core.submit(r)
    return _concurrent([lambda r=r: _st_collect(r) for r in requests])


def _st_accepted(engine, spec: dict, ids: list[int], what: str,
                 complete: bool = True) -> str:
    """The text of a constrained stream, after walking the port's DFA over
    its ids: every id advances the cursor and, when `complete`, the cursor
    ends accepting and the text is JSON. Returns the text."""
    from llmlb_tpu_torch.structured import ConstraintState

    state = ConstraintState(engine.constraint_compiler.compile_spec(spec))
    for i, t in enumerate(ids):
        if not state.advance(t):
            raise AssertionError(f"structured: {what}: id {i} ({t}) leaves "
                                 "the grammar")
    text = engine.tokenizer.decode(ids)
    if complete:
        if not state.is_accepting:
            raise AssertionError(f"structured: {what}: the grammar did not "
                                 f"accept {text!r}")
        json.loads(text)
    return text


class _BurstModes:
    """Records each decode burst's mode and whether a constrained row was
    decoding in it, and on the card each replay's time on the stream
    (CUDA events around it; a burst computes every slot, so its time does
    not depend on the rows decoding). Wraps the core's burst runner until
    close()."""

    def __init__(self, core):
        import torch

        from llmlb_tpu_torch.engine.decode_graph import key_name

        self.core, self.modes = core, []
        self.replay_ms: dict[str, list[float]] = {}
        run = core._bursts.run
        timed = core.device.type == "cuda"

        def spy(window, seeded, mode):
            constrained = any(s.request is not None and not s.prefilling
                              and s.constraint is not None
                              for s in core.slots)
            self.modes.append((mode, constrained))
            key = (window, seeded, mode)
            replay = timed and key in core._bursts.graphs
            if replay:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            out = run(window, seeded, mode)
            if replay:
                e1.record()
                e1.synchronize()
                self.replay_ms.setdefault(key_name(key), []).append(
                    e0.elapsed_time(e1))
            return out

        core._bursts.run = spy

    def median_ms(self) -> dict[str, float]:
        return {m: sorted(v)[len(v) // 2] for m, v in self.replay_ms.items()}

    def close(self) -> None:
        del self.core._bursts.run


class _OnRowTokens:
    """On the engine thread, once the row serving `rid` holds `n` committed
    tokens (between bursts): call `fn()` once. Wraps _emit_fetched."""

    def __init__(self, core, rid: str, n: int, fn):
        self.core, self.fired = core, False
        emit = core._emit_fetched

        def spy(tokens, active):
            emit(tokens, active)
            if self.fired:
                return
            for slot in core.slots:
                r = slot.request
                if (r is not None and r.request_id == rid
                        and len(slot.out_tokens) >= n):
                    self.fired = True
                    fn()
                    return

        core._emit_fetched = spy

    def close(self) -> None:
        del self.core._emit_fetched


def _structured_block(core, dev: dict) -> dict:
    """Structured outputs on the card (after the bf16 phase's launch
    counts; its launches are logged apart): one EngineCore over the serving
    core's params (no second copy of the weights), 8 paged slots with the
    ByteTokenizer's EOS (256), behind the port's Engine and server.

    1. fused: 8 greedy rows together (4 of the 85-state schema, 2 of the
       38-state one, 2 free): every constrained text parses, the port's DFA
       accepts it, finish "stop", no violation; every burst with a
       constrained row runs the grammar key (one eager burst, then
       replays), no fallback; the free rows give their solo tokens.
    2. seeded: 2 constrained rows at temperature 0.8: the graph core's
       tokens are an eager core's (decode_graphs=False, same params).
    3. fallback: json_object (1734 states) is refused a table row, its
       bursts take the host-mask key (k = 1) and the fallback counter
       rises; its text is a live prefix of the grammar; check 1's
       constrained prompts beside it give check 1's tokens.
    4. a constrained row parked by a priority-0 arrival resumes with its
       cursor, and one parked for a migration lands its exported pages on
       the eager core through adopt_stream: both give check 1's tokens.
    5. HTTP: a streamed json_schema chat, a forced tool call's tool_calls
       deltas and finish_reason "tool_calls", /v1/models and /api/health.
    """
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer(core.cfg.vocab_size)
    eos = tok.eos_id
    out: dict = {}
    st = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                    num_slots=SLOTS, slot_capacity=STRUCT_CAPACITY,
                    eos_id=eos)
    engine = Engine("llama-3-8b", st, tok)
    eager = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=2, slot_capacity=STRUCT_CAPACITY, eos_id=eos,
                       decode_graphs=False, prefix_cache=False)
    adopter = Engine("llama-3-8b", eager, ByteTokenizer(core.cfg.vocab_size))
    st.start()
    eager.start()
    server, thread = start_server(engine)
    base = "http://%s:%d" % server.server_address[:2]
    tables = st._grammar_tables
    registrations = []
    register = tables.register

    def timed_register(tc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = register(tc)
        torch.cuda.synchronize()
        if all(r[0] is not tc for r in registrations):  # first of a schema
            registrations.append((tc, off, (time.perf_counter() - t0) * 1e3))
        return off

    tables.register = timed_register
    try:
        with _Uncounted() as uncounted:
            out.update(_structured_checks(st, engine, eager, adopter, base,
                                          registrations, dev))
        out["launches"] = uncounted.launches
        log(f"structured [{dev['smi']}]: the structured core's and the eager "
            f"core's launches (not counted with the main path): "
            f"{uncounted.launches}")
        return out
    finally:
        del tables.register
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.shutdown()
        adopter.shutdown()
        del engine, adopter, st, eager
        gc.collect()
        torch.cuda.empty_cache()


def _structured_checks(st, engine, eager, adopter, base: str,
                       registrations: list, dev: dict) -> dict:
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    res: dict = {}
    compiler = engine.constraint_compiler
    specs = {"preempt": _st_spec(STRUCT_PREEMPT),
             "gateway": _st_spec(STRUCT_GATEWAY),
             "object": {"type": "json_object"}}
    compile_ms = {}
    for name in ("preempt", "gateway"):
        t0 = time.perf_counter()
        tc = compiler.compile_spec(specs[name])
        compile_ms[name] = ((time.perf_counter() - t0) * 1e3, tc.num_states)
    # 1. fused: 8 rows together
    rows = STRUCT_ROWS

    def batch(which):
        return [_st_request(engine, c, specs[s] if s else None,
                            STRUCT_TOKENS if s else STRUCT_FREE_TOKENS)
                for c, s in which]

    before = st.stats().structured
    modes = _BurstModes(st)  # over checks 1 to 3
    t0 = time.perf_counter()
    fused = _st_run(st, batch(rows))
    wall = time.perf_counter() - t0
    check1 = list(modes.modes)
    after = st.stats().structured
    for (content, s), (ids, reason, _t, _r) in zip(rows, fused):
        if s is None:
            continue
        if reason != "stop":
            raise AssertionError(f"structured: {content!r} ended {reason!r} "
                                 f"after {len(ids)} tokens, not at acceptance")
        _st_accepted(engine, specs[s], ids, content)
    if after.constraint_violations_total != before.constraint_violations_total:
        raise AssertionError(f"structured: violations {after}")
    if after.constrained_burst_fallback_total:
        raise AssertionError(f"structured: a fused block fell back ({after})")
    wrong = [m for m, c in check1 if c and m != "grammar"]
    grammar_runs = sum(1 for m, c in check1 if m == "grammar")
    info = st.decode_graph_info()
    gkeys = {k: v for k, v in info["keys"].items() if k.endswith("/grammar")}
    if wrong or grammar_runs < 2 or not gkeys:
        raise AssertionError(f"structured: constrained bursts ran {wrong}, "
                             f"{grammar_runs} under the grammar key; keys "
                             f"{list(info['keys'])}")
    if st.stats().decode_eager_bursts != len(info["keys"]):
        raise AssertionError("structured: more than one eager burst a key")
    free_solo = [_st_run(st, batch([row]))[0] for row in rows[6:]]
    if [f[0] for f in free_solo] != [f[0] for f in fused[6:]]:
        raise AssertionError("structured: a free row's tokens depend on the "
                             "constrained rows beside it")
    table = st.structured_info()["grammar_table"]
    texts = [engine.tokenizer.decode(ids) for ids, *_ in fused[:6]]
    log(f"structured [{dev['smi']}]: compile ms (states) "
        + ", ".join(f"{k} {v[0]:.1f} ({v[1]})" for k, v in compile_ms.items())
        + "; registrations (states, row, ms, MiB) "
        + str([(tc.num_states, off, round(ms, 2),
                round(tc.num_states * st.cfg.vocab_size * 4 / 2**20, 1))
               for tc, off, ms in registrations])
        + f"; table {table['rows']} rows, {table['bytes'] / 2**20:.1f} MiB of "
        f"{table['budget_bytes'] / 2**20:.0f} MiB (buffer "
        f"{table['allocated_bytes'] / 2**20:.1f} MiB)")
    log(f"structured: fused block of 8 rows in {wall:.2f} s: "
        f"{grammar_runs} grammar bursts, keys "
        + "; ".join(f"{k}: nodes {v['nodes']}, capture {v['capture_s']:.3f} s"
                    for k, v in gkeys.items())
        + f"; constrained texts {texts}; free rows = their solo runs")
    res["compile_ms"] = {k: v[0] for k, v in compile_ms.items()}
    res["fused_ids"] = [ids for ids, *_ in fused]
    res["registrations"] = [(tc.num_states, off, ms)
                            for tc, off, ms in registrations]
    res["grammar_keys"] = {k: {"nodes": v["nodes"],
                               "capture_s": v["capture_s"]}
                           for k, v in gkeys.items()}
    # TTFT and decode rates alone, warm (the best of two): a constrained
    # row (fused) and a free row, the free rate also over the constrained
    # stream's length (its bursts then the same)
    alone_c = [_st_run(st, batch(rows[:1]))[0] for _ in range(2)]
    alone_f = [_st_run(st, batch(rows[6:7]))[0] for _ in range(2)]
    n_c = len(alone_c[0][0])
    ttft_c = min(r[2] for r in alone_c)
    ttft_f = min(r[2] for r in alone_f)
    rate_c = max(_st_rate(r[3], n_c) for r in alone_c)
    rate_f_n = max(_st_rate(r[3], n_c) for r in alone_f)
    rate_f = max(_st_rate(r[3], STRUCT_FREE_TOKENS) for r in alone_f)
    # 2. seeded: graph = eager
    seeded = [dict(temperature=0.8, top_p=0.95, seed=11 + i) for i in range(2)]

    def seeded_batch():
        return [_st_request(engine, rows[i][0], specs["preempt"],
                            STRUCT_TOKENS, **seeded[i]) for i in range(2)]

    graph_ids = [r[0] for r in _st_run(st, seeded_batch())]
    eager_ids = [r[0] for r in _st_run(eager, seeded_batch())]
    if graph_ids != eager_ids:
        raise AssertionError("structured: seeded constrained rows: graph "
                             f"{graph_ids} != eager {eager_ids}")
    for i, ids in enumerate(graph_ids):
        _st_accepted(engine, specs["preempt"], ids, f"seeded row {i}")
    if "256/seeded/grammar" not in st.decode_graph_info()["keys"]:
        raise AssertionError("structured: the seeded rows did not replay the "
                             "seeded grammar key")
    log(f"structured: seeded rows (temperature 0.8): graph = eager, "
        f"{[len(i) for i in graph_ids]} tokens, texts "
        f"{[engine.tokenizer.decode(i) for i in graph_ids]}")
    # 3. the host-mask fallback: json_object misses the table
    t0 = time.perf_counter()
    obj_tc = compiler.compile_spec(specs["object"])
    obj_ms = (time.perf_counter() - t0) * 1e3
    fb0 = st.stats().structured.constrained_burst_fallback_total
    obj = _st_run(st, [_st_request(engine, "Any JSON object, please.",
                                   specs["object"], STRUCT_OBJECT_TOKENS)])[0]
    info = st.structured_info()
    fb1 = st.stats().structured.constrained_burst_fallback_total
    if not info["grammar_fallback"] or info["grammar_table"]["rejected"] < 1:
        raise AssertionError(f"structured: json_object was not refused a "
                             f"table row ({info})")
    if fb1 <= fb0:
        raise AssertionError("structured: the fallback counter did not rise")
    obj_text = _st_accepted(engine, specs["object"], obj[0], "json_object",
                            complete=obj[1] == "stop")
    mixed = _st_run(st, batch(rows[:6]) + [_st_request(
        engine, "Any JSON object, please.", specs["object"],
        STRUCT_OBJECT_TOKENS)])
    fb2 = st.stats().structured.constrained_burst_fallback_total
    if [m[0] for m in mixed[:6]] != [f[0] for f in fused[:6]]:
        raise AssertionError("structured: check 1's rows beside the "
                             "json_object row (host-mask bursts) differ from "
                             "their fused run")
    if mixed[6][0] != obj[0] or fb2 <= fb1:
        raise AssertionError("structured: the json_object row changed in a "
                             "batch, or its bursts did not fall back")
    modes.close()
    burst_ms = modes.median_ms()
    mask_keys = [k for k in st.decode_graph_info()["keys"]
                 if k.endswith("/mask")]
    log(f"structured [{dev['smi']}]: json_object ({obj_tc.num_states} "
        f"states, {obj_tc.num_states * st.cfg.vocab_size * 4 / 2**20:.0f} "
        f"MiB of table) compiled in {obj_ms:.1f} ms and refused a table row "
        f"(budget {info['grammar_table']['budget_bytes'] >> 20} MiB); "
        f"fallback bursts {fb1 - fb0} alone, {fb2 - fb1} beside check 1's "
        f"rows, whose tokens equal their fused run's; keys {mask_keys}; its "
        f"{len(obj[0])} ids {obj[1]!r}, a live prefix: {obj_text!r}")
    # a row's rate on the card alone: a key's steps over its replay
    replay_rate = {k: (1 if k.endswith("/mask") else st.decode_burst) * 1e3
                   / ms for k, ms in burst_ms.items()}
    log(f"structured [{dev['smi']}]: replayed bursts, median ms on the "
        f"stream (8 slots): {burst_ms} (free and grammar keys: "
        f"{st.decode_burst} steps; mask: 1 step); a row's tok/s on the "
        f"card alone (steps / replay ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in replay_rate.items()))
    res["burst_replay_ms"] = burst_ms
    res["decode_tok_s_replay"] = replay_rate
    # 4a. a priority park of a constrained row, resumed with its cursor
    preempt0 = st.stats().preemptions_total
    fillers = [_st_request(engine, f"Filler {i}: keep talking.", None, 160)
               for i in range(SLOTS - 1)]
    victim = _st_request(engine, rows[0][0], specs["preempt"], STRUCT_TOKENS,
                         rid="struct-victim", priority=2)
    hi = _st_request(engine, "Urgent: one line.", None, 8, priority=0)
    trigger = _OnRowTokens(st, "struct-victim", STRUCT_PARK_AT,
                           lambda: st.submit(hi))
    try:
        for r in fillers:
            st.submit(r)
        st.submit(victim)
        vic = _st_collect(victim)
        _st_collect(hi)
    finally:
        trigger.close()
        for r in fillers:
            r.cancel()
    _wait_idle(st)
    parks = st.stats().preemptions_total - preempt0
    if vic[0] != fused[0][0] or vic[1] != "stop" or parks < 1:
        raise AssertionError(f"structured: the parked constrained row shares "
                             f"{_shared(vic[0], fused[0][0])} of "
                             f"{len(fused[0][0])} ids ({parks} parks)")
    # 4b. a migration: parked with an export, landed on the eager core
    rid = "structmig.0123abcd"
    mig = _st_request(engine, rows[1][0], specs["preempt"], STRUCT_TOKENS,
                      rid=rid)
    # the park, then the cancel: the loop parks it (with its export) before
    # it admits anything, and ends it instead of re-admitting it
    trigger = _OnRowTokens(st, rid, STRUCT_PARK_AT,
                           lambda: (st.request_park("structmig"),
                                    mig.cancel()))
    try:
        st.submit(mig)
        payload, t_end = None, time.monotonic() + 60
        while payload is None and time.monotonic() < t_end:
            payload = st.take_kv_export("structmig")
            time.sleep(0.005)
    finally:
        trigger.close()
    if payload is None:
        raise AssertionError("structured: no export of the migrated row")
    committed = list(mig.parked.tokens) if mig.parked else None
    mig.cancel()
    _wait_idle(st)
    restored0 = eager.kv_transfer_info()["restored_total"]
    deltas = list(adopter.adopt_stream(
        mig.prompt_ids, committed, SamplingParams(
            temperature=0.0, max_tokens=STRUCT_TOKENS,
            constraint=specs["preempt"]), kv_pages=payload))
    moved = [t for d in deltas for t in d.token_ids]
    landed = eager.kv_transfer_info()["restored_total"] - restored0
    if (moved != fused[1][0] or deltas[-1].finish_reason != "stop"
            or landed != 1):
        raise AssertionError(f"structured: the migrated row shares "
                             f"{_shared(moved, fused[1][0])} of "
                             f"{len(fused[1][0])} ids ({landed} lands)")
    # the json_object rows cut at max_tokens before acceptance are the only
    # violations (the reference's length rule)
    cut = sum(1 for r in (obj, mixed[6]) if r[1] == "length")
    for c, want in ((st, cut), (eager, 0)):
        if c.stats().structured.constraint_violations_total != want:
            raise AssertionError(f"structured: violations "
                                 f"{c.stats().structured}, {want} expected")
    log(f"structured: a constrained row parked by a priority-0 arrival "
        f"({parks} park) and one migrated after {len(committed)} committed "
        f"ids (its pages landed on the eager core, cursor rebuilt) give "
        f"check 1's {len(vic[0])} and {len(moved)} ids; no violation")
    # 5. HTTP
    chat = {"model": "llama-3-8b", "temperature": 0, "max_tokens": 128,
            "stream": True,
            "messages": [{"role": "user", "content": "Weather as JSON."}]}
    schema_chat = {**chat, "response_format": {"type": "json_schema",
                                               "json_schema": {
                                                   "name": "w",
                                                   "schema": STRUCT_GATEWAY}}}
    tool_chat = {**chat, "tools": [{"type": "function", "function": {
        "name": "get_weather", "parameters": STRUCT_GATEWAY}}],
        "tool_choice": {"type": "function",
                        "function": {"name": "get_weather"}}}

    def sse(body):
        with _post(base + "/v1/chat/completions", body) as resp:
            lines = [bytes(d) for d in _sse_lines(resp)]
        if lines[-1] != b"[DONE]":
            raise AssertionError("structured: a stream without [DONE]")
        chunks = [json.loads(d) for d in lines[:-1]]
        return [c["choices"][0] for c in chunks if c.get("choices")]

    choices = sse(schema_chat)
    text = "".join(c["delta"].get("content") or "" for c in choices)
    if choices[-1]["finish_reason"] != "stop" or set(json.loads(text)) != {
            "city", "celsius"}:
        raise AssertionError(f"structured: json_schema chat {text!r}, "
                             f"{choices[-1]['finish_reason']}")
    choices = sse(tool_chat)
    opener = choices[1]["delta"]["tool_calls"][0]
    args = "".join(c["delta"]["tool_calls"][0]["function"]["arguments"]
                   for c in choices[2:] if "tool_calls" in c["delta"])
    if (opener["function"] != {"name": "get_weather", "arguments": ""}
            or not opener["id"].startswith("call_")
            or opener["type"] != "function"
            or any(c["delta"].get("content") for c in choices[1:])
            or choices[-1]["finish_reason"] != "tool_calls"
            or set(json.loads(args)) != {"city", "celsius"}):
        raise AssertionError(f"structured: tool call stream {choices}")
    with urllib.request.urlopen(base + "/v1/models", timeout=60) as resp:
        caps = json.loads(resp.read())["data"][0]["capabilities"]
    with urllib.request.urlopen(base + "/api/health", timeout=60) as resp:
        health = json.loads(resp.read())["structured"]
    if "structured_outputs" not in caps or not health["enabled"]:
        raise AssertionError(f"structured: /v1/models {caps}, /api/health "
                             f"{health}")
    rate_fb = _st_rate(obj[3], n_c)
    sizes = {name: [c for c, _ in _st_fetches(r[3])] for name, r in (
        ("fused", alone_c[0]), ("free", alone_f[0]), ("fallback", obj))}
    counters = dataclasses.asdict(st.stats().structured)
    keys = st.decode_graph_info()["keys"]
    log(f"structured [{dev['smi']}]: HTTP json_schema chat {text!r} (stop), "
        f"forced tool call arguments {args!r} (tool_calls); /v1/models "
        f"{caps}; alone, warm: TTFT constrained {ttft_c * 1e3:.1f} ms (with "
        f"the activation's fetch), free {ttft_f * 1e3:.1f} ms; steady "
        f"decode tok/s (after the first fetch) over the first {n_c} ids: "
        f"fused {rate_c:.1f}, free {rate_f_n:.1f}, fallback (json_object, "
        f"k = 1) {rate_fb:.1f}; free over {STRUCT_FREE_TOKENS}: "
        f"{rate_f:.1f}; ids a fetch {sizes}; the structured core's keys "
        + "; ".join(f"{k}: nodes {v['nodes']}, capture {v['capture_s']:.3f} s"
                    for k, v in keys.items())
        + f"; counters {counters}")
    res.update({"ttft_constrained_s": ttft_c, "ttft_free_s": ttft_f,
                "decode_tok_s_fused": rate_c, "decode_tok_s_free": rate_f_n,
                "decode_tok_s_free_64": rate_f,
                "decode_tok_s_fallback": rate_fb,
                "json_object_compile_ms": obj_ms, "counters": counters})
    return res


def _structured_dense(core, dev: dict, want: list[list[int]]) -> dict:
    """The dense layout's constrained path (the reference's default there:
    fused decode off, every constrained burst on the host-mask key, k = 1),
    after the dense phase's counts, on an EngineCore of its own over the
    phase's params (2 slots, the ByteTokenizer's EOS): the bf16 block's
    first two constrained prompts give its fused ids (dense = paged,
    fallback = fused)."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer(core.cfg.vocab_size)
    st = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                    num_slots=2, slot_capacity=STRUCT_CAPACITY,
                    eos_id=tok.eos_id, kv_layout="dense", prefix_cache=False)
    engine = Engine("llama-3-8b", st, tok)
    st.start()
    try:
        with _Uncounted() as uncounted:
            spec = _st_spec(STRUCT_PREEMPT)
            t0 = time.perf_counter()
            got = _st_run(st, [_st_request(engine, c, spec, STRUCT_TOKENS)
                               for c, _s in STRUCT_ROWS[:2]])
            wall = time.perf_counter() - t0
        counters = st.stats().structured
        keys = list(st.decode_graph_info()["keys"])
        if st.fused_decode or [g[0] for g in got] != want[:2] or any(
                g[1] != "stop" for g in got):
            raise AssertionError(
                f"structured dense: fused_decode {st.fused_decode}; the rows "
                f"share {[_shared(g[0], w) for g, w in zip(got, want)]} of "
                f"{[len(w) for w in want[:2]]} ids with the paged fused run's")
        if (counters.constraint_violations_total
                or counters.constrained_burst_fallback_total < 1
                or not any(k.endswith("/mask") for k in keys)):
            raise AssertionError(f"structured dense: {counters}, keys {keys}")
        log(f"structured dense [{dev['smi']}]: 2 constrained rows on the "
            f"host-mask key in {wall:.2f} s ({counters.masked_decode_steps_total}"
            f" one-step bursts, keys {keys}) give the paged fused run's ids; "
            f"launches (not counted) {uncounted.launches}")
        return {"wall_s": wall, "launches": uncounted.launches}
    finally:
        engine.shutdown()
        del engine, st
        gc.collect()
        torch.cuda.empty_cache()


# -- speculative decoding (A9) and the prefill chunk budget (A10b) ----------

SPEC_TOKENS = 64  # each spec request's greedy tokens
SPEC_SHORT = 32  # the int8, LoRA and dense phases' spec request
SPEC_TEXT = "Spec row {}: count 1 2 3 4 5 6 7 8 9 and again 1 2 3 4 5 6"
SPEC_ON = {"enabled": True}
SPEC_COUNTERS = ("verify_steps_total", "draft_tokens_total",
                 "accepted_tokens_total", "emitted_tokens_total")
SPEC_PARK_AT = 16  # the parked speculating row's committed tokens
BUDGET = 128  # the budget block's prefill_chunk_budget
BUDGET_CAPACITY = 2048
# the budget block's decoders' prompts: long enough that their bursts run
# at the 1024-token window throughout the measurement (no capture in it)
BUDGET_DECODER_TOKENS = 560


def _spec_prompts(engine, n: int) -> list[list[int]]:
    """n chat prompts of one length (one prefill bucket), each under 128
    tokens, so that no finish donates a prefix and the pool's free count
    comes back whole."""
    prompts = [engine.encode_chat([{"role": "user",
                                    "content": SPEC_TEXT.format(i)}])
               for i in range(n)]
    if len({len(p) for p in prompts}) != 1 or len(prompts[0]) >= PAGE:
        raise AssertionError("the spec prompts must share one length < 128")
    return prompts


class _StubDrafter:
    """A drafter installed by _StubDrafters in place of the prompt-lookup
    one; it lives in this script, not the package. "accept" proposes the
    next ids of a known stream while the row follows it (every draft
    accepted until the row parts from the stream; none after), "reject"
    ids that differ from them (none accepted), "grammar" the lowest ids a
    constraint allows along its own walk from the row's cursor (drafts the
    host never cuts, for a mask key's run; `tc` the row's token DFA)."""

    def __init__(self, mode: str, stream: list[int] | None, vocab: int,
                 tc=None):
        from llmlb_tpu_torch.structured import ConstraintState

        self.mode, self.stream, self.vocab, self.tc = mode, stream, vocab, tc
        self.n, self.parted = 0, False
        self.cursor = ConstraintState(tc) if tc is not None else None

    def append(self, token: int) -> None:
        if self.stream is not None and (self.n >= len(self.stream)
                                        or token != self.stream[self.n]):
            self.parted = True
        if self.cursor is not None:
            self.cursor.advance(token)
        self.n += 1

    def propose(self, k: int) -> list[int]:
        import numpy as np

        if self.mode == "grammar":
            tc, s, out = self.tc, self.cursor.state, []
            for _ in range(k):
                ids = np.flatnonzero(tc.allowed[s])
                ids = ids[ids != tc.eos_id]
                nxt = tc.advance(s, int(ids[0])) if len(ids) else None
                if nxt is None:
                    break
                out.append(int(ids[0]))
                s = nxt
            return out
        d = self.stream[self.n:self.n + k]
        if self.mode == "reject":
            return [(t + 1) % self.vocab for t in d]
        return [] if self.parted else list(d)


class _StubDrafters:
    """Wraps a core's _attach_spec until close(): a request whose id is in
    `stubs` speculates with its stub (a parked row keeps the same one)."""

    def __init__(self, core):
        self.core, self.stubs = core, {}
        attach = core._attach_spec

        def spy(slot_id, request):
            attach(slot_id, request)
            stub = self.stubs.get(request.request_id)
            if stub is not None and core.slots[slot_id].drafter is not None:
                core.slots[slot_id].drafter = stub

        core._attach_spec = spy

    def close(self) -> None:
        del self.core._attach_spec


class _ReplayTimes:
    """Each replay's time on the stream (CUDA events around it) of a
    BurstGraphs' keys, by key name, until close()."""

    def __init__(self, graphs):
        import torch

        from llmlb_tpu_torch.engine.decode_graph import key_name

        self.graphs, self.ms = graphs, {}
        run = graphs.run
        timed = torch.cuda.is_available()

        def spy(window, seeded, mode):
            key = (window, seeded, mode)
            replay = timed and key in graphs.graphs
            if replay:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            out = run(window, seeded, mode)
            if replay:
                e1.record()
                e1.synchronize()
                self.ms.setdefault(graphs.kind + key_name(key), []).append(
                    e0.elapsed_time(e1))
            return out

        graphs.run = spy

    def median_ms(self) -> dict[str, float]:
        return {k: sorted(v)[len(v) // 2] for k, v in self.ms.items()}

    def close(self) -> None:
        del self.graphs.run


def _spec_counts(core) -> dict:
    c = core.stats().spec
    return {k: getattr(c, k) for k in SPEC_COUNTERS}


def _spec_run(core, prompts, max_tokens: int, knob, stubs=None, mode=None,
              streams=None, lora=None, spec=None, engine=None, **sampling):
    """The prompts together on a running core (greedy unless `sampling`
    says otherwise), each speculating per `knob`, with a stub drafter of
    `mode` over `streams` when given, under the constraint `spec` (compiled
    by `engine`'s compiler) when given. Returns (ids each, finish reasons,
    steady tok/s summed over the rows, the spec counters they added)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    reqs = []
    for i, p in enumerate(prompts):
        r = Request(prompt_ids=list(p), sampling=SamplingParams(
            max_tokens=max_tokens, lora=lora, speculative=knob,
            constraint=spec, **sampling),
            compiled_constraint=(engine.constraint_compiler.compile_spec(spec)
                                 if spec is not None else None))
        r.events = _StampedEvents()
        if mode is not None:
            stubs.stubs[r.request_id] = _StubDrafter(
                mode, None if streams is None else streams[i],
                core.cfg.vocab_size, r.compiled_constraint)
        reqs.append(r)
    c0 = _spec_counts(core)
    res = _st_run(core, reqs)
    _wait_idle(core)
    c1 = _spec_counts(core)
    rate = sum(_st_rate(r[3], max_tokens) for r in res)
    return ([r[0] for r in res], [r[1] for r in res], rate,
            {k: c1[k] - c0[k] for k in SPEC_COUNTERS})


def _spec_margins(core, prompts, streams, lora_row: int = 0):
    """Recompute, over scratch KV, the two paths a row's logits take:
    decode steps (M = slots, the split-K decode kernel), as the spec-off
    stream's were computed, and full verify chunks (M = slots * (K+1), the
    extend kernel) feeding the same tokens. Rows are the engine's slots
    (prompts and streams repeated to fill them). Returns (the spec-off
    top-2 margin [rows, T] at each position, the largest |verify - decode|
    logit difference over every row and position, positions where the
    decode path's argmax is not the stream's token, and the share of
    positions where the two paths' logits give another token: greedy,
    and seeded at temperature 0.8, top-p 0.95). An MoE family's rows
    prefill one at a time, as each request's did: its capacity dispatch
    couples the rows of a group."""
    import torch

    from llmlb_tpu_torch.models import family_for
    from llmlb_tpu_torch.ops.sampling import sample_tokens

    n = core.num_slots
    prompts = [prompts[i % len(prompts)] for i in range(n)]
    streams = [streams[i % len(streams)] for i in range(n)]
    t = min(len(s) for s in streams)
    cfg, params, dev = core.cfg, core.params, core.device
    fam = family_for(cfg)  # the family's entry points
    alone = fam.PREFILL_COUPLES_ROWS
    plen = len(prompts[0])
    i32 = dict(dtype=torch.int32, device=dev)
    lens = torch.full((n,), plen, **i32)
    toks = torch.tensor([s[:t] for s in streams], **i32)
    bucket = core._bucket_for(plen)
    ids = torch.zeros((n, bucket), dtype=torch.int64, device=dev)
    ids[:, :plen] = torch.tensor(prompts, device=dev)
    lidx = (torch.full((n,), lora_row, **i32) if core.lora is not None
            else None)
    dense = core.page_pool is None
    rows = plen + t + VERIFY_K1 + 1
    with _Uncounted():
        if dense:
            caps = [fam.init_kv_cache(cfg, n, core.slot_capacity, dev)
                    for _ in range(2)]
            slots = torch.arange(n, device=dev)
            logits0, _, _ = fam.prefill_into_slots(
                params, cfg, ids, lens, slots, *caps[0], lora_idx=lidx)
            fam.prefill_into_slots(params, cfg, ids, lens, slots, *caps[1],
                                   lora_idx=lidx)
        else:
            ppr = -(-rows // PAGE)
            caps = [fam.init_kv_pages(cfg, n * ppr + 1, core.kv_page_size,
                                      dev, quantized=core.quant.kv)
                    for _ in range(2)]
            tables = (torch.arange(n * ppr, **i32) + 1).reshape(n, ppr)
            tables = torch.nn.functional.pad(
                tables, (0, core.pages_per_slot - ppr))
            for pools in caps:
                if alone:
                    logits0 = torch.cat([fam.prefill_into_pages(
                        params, cfg, ids[r:r + 1], lens[r:r + 1],
                        tables[r:r + 1], *pools,
                        lora_idx=None if lidx is None else lidx[r:r + 1])[0]
                        for r in range(n)])
                    continue
                logits0, _, _ = fam.prefill_into_pages(
                    params, cfg, ids, lens, tables, *pools, lora_idx=lidx)
        dec = torch.empty((n, t, cfg.vocab_size), dtype=torch.float32,
                          device=dev)
        dec[:, 0] = logits0
        window = _window(plen + t + 1)
        for j in range(t - 1):
            seq = lens + j
            if dense:
                logits, _, _ = fam.decode_step(
                    params, cfg, toks[:, j], seq, *caps[0], window=window,
                    lora_idx=lidx)
            else:
                logits, _, _ = fam.decode_step_paged(
                    params, cfg, toks[:, j], seq, *caps[0], tables,
                    window=window, lora_idx=lidx)
            dec[:, j + 1] = logits
        diff = 0.0
        ver = torch.empty_like(dec)
        ver[:, 0] = dec[:, 0]
        for j0 in range(0, t - 1, VERIFY_K1):
            c = min(VERIFY_K1, t - 1 - j0)
            chunk = torch.zeros((n, VERIFY_K1), **i32)
            chunk[:, :c] = toks[:, j0:j0 + c]
            clen = torch.full((n,), c, **i32)
            if dense:
                logits, _, _ = fam.verify_step(
                    params, cfg, chunk, clen, lens + j0, None, *caps[1],
                    lora_idx=lidx)
            else:
                logits, _, _ = fam.verify_step_paged(
                    params, cfg, chunk, clen, lens + j0, tables, *caps[1],
                    lora_idx=lidx)
            diff = max(diff, (logits[:, :c] - dec[:, j0 + 1:j0 + 1 + c])
                       .abs().max().item())
            ver[:, j0 + 1:j0 + 1 + c] = logits[:, :c]
        top2 = dec.topk(2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1]).cpu()
        off_path = int((dec.argmax(dim=-1) != toks[:, :t].long()).sum())
        greedy = (dec.argmax(-1) != ver.argmax(-1))[:, 1:].float().mean()
        rows = n * t
        temps = torch.full((rows,), 0.8, device=dev)
        top_ps = torch.full((rows,), 0.95, device=dev)
        top_ks = torch.zeros(rows, **i32)
        seeds = torch.full((rows,), 4321, dtype=torch.int64, device=dev)
        steps = (lens[:, None] - 1 + torch.arange(t, device=dev)).reshape(-1)
        picks = [sample_tokens(x.reshape(rows, -1), None, temps, top_ps,
                               top_ks, seeds=seeds, steps=steps).reshape(n, t)
                 for x in (dec, ver)]
        seeded = (picks[0] != picks[1])[:, 1:].float().mean()
        flips = {"greedy": greedy.item(), "seeded": seeded.item()}
        del dec, ver, caps
    torch.cuda.empty_cache()
    return margins, diff, off_path, flips


def _partings(what: str, streams, ref, margins, diff: float) -> list:
    """Each stream against its spec-off stream: the tokens they share and,
    where they part, the spec-off top-2 margin there; fails unless every
    parting falls at a margin below `diff`. Returns the partings."""
    shared = [_shared(x, s) for x, s in zip(streams, ref)]
    parts = [(i, p, float(margins[i, p])) for i, p in enumerate(shared)
             if p < min(len(streams[i]), len(ref[i]))]
    log(f"  {what}: tokens shared with spec off {shared} of "
        f"{[len(s) for s in ref]}; partings (row, position, spec-off top-2 "
        f"margin) {[(i, p, f'{m:.4f}') for i, p, m in parts]}; largest "
        f"|verify - decode| logit difference {diff:.4f}")
    bad = [x for x in parts if x[2] >= diff]
    if bad:
        raise AssertionError(f"{what}: a parting at a margin not below the "
                             f"verify/decode logit difference {diff:.4f}: "
                             f"{bad}")
    return parts


def _spec_park(core, prompt, stream, stubs) -> dict:
    """A speculating row (the "accept" stub over the spec-off stream) parked
    between steps after SPEC_PARK_AT committed tokens, resumed by the
    engine: its drafter is carried (the same object, its count of tokens
    seen intact). Returns its ids and what was seen."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    r = Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=SPEC_TOKENS, temperature=0.0, speculative=SPEC_ON))
    r.events = _StampedEvents()
    stub = _StubDrafter("accept", stream, core.cfg.vocab_size)
    stubs.stubs[r.request_id] = stub
    seen: dict = {}
    decode = core._decode_active

    def spy():
        did = decode()
        for i, slot in enumerate(core.slots):
            if slot.request is not r or slot.prefilling:
                continue
            if "parked" not in seen and core._parkable(slot) and len(
                    slot.out_tokens) >= SPEC_PARK_AT:
                seen.update(parked=len(slot.out_tokens), n=stub.n,
                            drafter=slot.drafter is stub)
                core._park_slot(i)
            elif "parked" in seen and "resumed" not in seen:
                seen.update(resumed=slot.drafter is stub, n_resumed=stub.n)
        return did

    p0 = core.stats().preemptions_total
    core._decode_active = spy
    try:
        ids, reason, _, _ = _st_run(core, [r])[0]
    finally:
        del core._decode_active
    seen.update(ids=ids, parks=core.stats().preemptions_total - p0)
    if not (seen.get("drafter") and seen.get("resumed")
            and seen["parks"] == 1 and seen["n_resumed"] == seen["n"]):
        what = {k: v for k, v in seen.items() if k != "ids"}
        raise AssertionError(f"spec park: the drafter was not carried: "
                             f"{what}")
    return seen


def _spec_block(core, engine, label: str, dev: dict) -> dict:
    """Speculative decoding on the phase's core, counted with the main
    path (speculation on per request): 1 row, then 8 rows, of SPEC_TOKENS
    greedy tokens with speculation off, on (the prompt-lookup drafter), on
    under the "accept" stub (every draft the spec-off stream's next token)
    and under the "reject" stub; the counters each run added (accept: as
    many accepted as drafted where the streams agree; reject: none); the
    page pool's free count back to its baseline; the parting rule of every
    spec-on stream against spec off (_spec_margins); a parked speculating
    row; steady tok/s and each verify key's replay ms."""
    out: dict = {}
    prompts = _spec_prompts(engine, SLOTS)
    _wait_idle(core)
    free0 = core.page_pool.available() if core.page_pool is not None else None
    stubs = _StubDrafters(core)
    times = _ReplayTimes(core._verifies)
    try:
        runs = {}
        for rows in (1, SLOTS):
            ps = prompts[:rows]
            off = _spec_run(core, ps, SPEC_TOKENS, None)
            runs[f"off/{rows}"] = off
            for name, knob, mode in (("on", SPEC_ON, None),
                                     ("accept", SPEC_ON, "accept"),
                                     ("reject", SPEC_ON, "reject")):
                runs[f"{name}/{rows}"] = _spec_run(
                    core, ps, SPEC_TOKENS, knob, stubs, mode, off[0])
        off8 = runs[f"off/{SLOTS}"][0]
        if runs["off/1"][0][0] != off8[0]:
            raise AssertionError("spec off: row 0 alone and in the batch of "
                                 "8 give different greedy ids")
        margins, diff, off_path, flips = _spec_margins(core, prompts, off8)
        log(f"serve {label}: spec: the scratch decode path's argmax leaves "
            f"the spec-off streams at {off_path} of {SLOTS * SPEC_TOKENS} "
            f"positions; over the same tokens the verify path's logits give "
            f"another greedy token at {flips['greedy']:.4f} of the "
            f"positions and another seeded one (temperature 0.8, top-p "
            f"0.95) at {flips['seeded']:.4f}")
        parts = {}
        for key, (ids, reasons, rate, counts) in runs.items():
            name, rows = key.split("/")
            ref = off8[:int(rows)]
            if name != "off":
                parts[key] = _partings(f"serve {label}: spec {key}", ids, ref,
                                       margins, diff)
            steps = counts["verify_steps_total"]
            emitted = counts["emitted_tokens_total"]
            log(f"serve {label} [{dev['smi']}]: spec {key}: {rate:.1f} tok/s "
                f"steady; counters {counts}; "
                + (f"{emitted / steps:.2f} tokens a verify step, "
                   f"{emitted / steps / int(rows):.2f} a row"
                   if steps else "no verify step"))
        for rows in (1, SLOTS):
            acc = runs[f"accept/{rows}"][3]
            rej = runs[f"reject/{rows}"][3]
            # every draft is accepted but those of the step where a row
            # parts from the stream (at most K each)
            parted = len(parts[f"accept/{rows}"])
            k = VERIFY_K1 - 1
            if acc["verify_steps_total"] <= 0 or not (
                    acc["draft_tokens_total"] - k * parted
                    <= acc["accepted_tokens_total"]
                    <= acc["draft_tokens_total"]):
                raise AssertionError(f"spec accept/{rows}: counters {acc} "
                                     f"with {parted} partings")
            if (rej["accepted_tokens_total"] != 0
                    or rej["verify_steps_total"] <= 0):
                raise AssertionError(f"spec reject/{rows}: counters {rej}")
        if free0 is not None and core.page_pool.available() != free0:
            raise AssertionError(f"spec: the pool's free pages "
                                 f"{core.page_pool.available()} != {free0} "
                                 "after the traffic")
        park = _spec_park(core, prompts[0], off8[0], stubs)
        parts["park"] = _partings(f"serve {label}: spec park", [park["ids"]],
                                  off8[:1], margins, diff)
        log(f"serve {label}: spec park: parked at {park['parked']} committed "
            f"ids, resumed with its drafter (the same stub, {park['n']} ids "
            f"seen at both ends)")
        if free0 is not None and core.page_pool.available() != free0:
            raise AssertionError("spec: pages leaked by the park")
        out.update(
            rates={k: v[2] for k, v in runs.items()},
            counts={k: v[3] for k, v in runs.items()},
            shared={k: [_shared(x, s) for x, s in zip(v[0], off8)]
                    for k, v in runs.items()},
            partings={k: len(v) for k, v in parts.items()},
            logit_diff=diff, flips=flips, replay_ms=times.median_ms(),
            pool_free=free0)
        keys = core.decode_graph_info()["verify"]["keys"]
        out["keys"] = {k: {"capture_s": v["capture_s"],
                           "pool_bytes": v["pool_bytes"], "nodes": v["nodes"],
                           "launches": v["launches"]}
                       for k, v in keys.items()}
        log(f"serve {label} [{dev['smi']}]: spec: verify replay ms "
            f"{out['replay_ms']}; keys {out['keys']}")
        return out
    finally:
        times.close()
        stubs.close()


def _spec_short(core, engine, label: str, dev: dict, lora: bool) -> dict:
    """The int8, LoRA and dense phases' spec request: SPEC_SHORT greedy
    tokens off, then on under the "accept" stub over them (an adapter row
    with LoRA), the parting rule, and the launches of the path's verify
    kernel; the dense phase also runs a constrained (json_object) pair on
    its verify key "mask" (fused decode is off on the dense layout): the
    38-state schema, spec off, then under the "grammar" stub."""
    from llmlb_tpu_torch.ops import cuda_attention as ca

    out: dict = {}
    name = "acme" if lora else None
    prompt = _spec_prompts(engine, 1)
    stubs = _StubDrafters(core)
    try:
        off = _spec_run(core, prompt, SPEC_SHORT, None, lora=name)
        l0 = dict(ca.LAUNCHES)
        on = _spec_run(core, prompt, SPEC_SHORT, SPEC_ON, stubs, "accept",
                       off[0], lora=name)
        launches = {k: v - l0.get(k, 0) for k, v in ca.LAUNCHES.items()
                    if v - l0.get(k, 0)}
        lrow = core.lora.slot_of(name) if lora else 0
        margins, diff, off_path, flips = _spec_margins(core, prompt, off[0],
                                                       lrow)
        out["partings"] = len(_partings(f"serve {label}: spec", on[0], off[0],
                                        margins, diff))
        out.update(counts=on[3], launches=launches, logit_diff=diff,
                   flips=flips, rate_on=on[2], rate_off=off[2])
        if on[3]["verify_steps_total"] <= 0:
            raise AssertionError(f"serve {label}: spec: no verify step")
        if core.page_pool is None:
            spec = _st_spec(STRUCT_GATEWAY)
            coff = _spec_run(core, prompt, SPEC_SHORT, None, spec=spec,
                             engine=engine)
            con = _spec_run(core, prompt, SPEC_SHORT, SPEC_ON, stubs,
                            "grammar", coff[0], spec=spec, engine=engine)
            _st_accepted(engine, spec, con[0][0], "dense spec", False)
            out["constrained"] = dict(
                counts=con[3], shared=_shared(con[0][0], coff[0][0]))
        keys = sorted(core.decode_graph_info()["verify"]["keys"])
        out["keys"] = keys
        if core.page_pool is None and not any(k.endswith("/mask")
                                              for k in keys):
            raise AssertionError(f"serve {label}: no verify mask key: {keys}")
        log(f"serve {label} [{dev['smi']}]: spec: {SPEC_SHORT} ids, "
            f"{off[2]:.1f} tok/s off, {on[2]:.1f} tok/s on (accept stub); "
            f"counters {on[3]}; the request's launches {launches}; verify "
            f"keys {keys}; scratch argmax off the stream at {off_path}"
            + (f"; constrained pair {out['constrained']}"
               if "constrained" in out else ""))
        return out
    finally:
        stubs.close()


def _spec_graphs(core, dev: dict) -> dict:
    """Each verify key's replay against its eager step: two EngineCores over
    the phase's params (8 paged slots, the ByteTokenizer's EOS, each behind
    the port's Engine for its compiler), one capturing its keys, one eager
    (decode_graphs=False). The same requests go to both, speculating under
    the "accept" stub over the eager core's spec-off streams: 4 greedy free
    rows (key free), 4 seeded rows (seeded), 2 rows of a resident schema
    (grammar), and the same 2 with fused decode off (mask, the dense
    layout's default), under the "grammar" stub. Every
    key's replays give the eager steps' tokens; the constrained texts walk
    the port's DFA. Their launches are not the main path's."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer(core.cfg.vocab_size)
    cores = [EngineCore(core.cfg, core.params, device=core.device, seed=0,
                        num_slots=SLOTS, slot_capacity=STRUCT_CAPACITY,
                        eos_id=tok.eos_id, prefix_cache=False,
                        decode_graphs=graphs) for graphs in (True, False)]
    engines = [Engine("llama-3-8b", c, ByteTokenizer(core.cfg.vocab_size))
               for c in cores]
    stubs = [_StubDrafters(c) for c in cores]
    prompts = _spec_prompts(engines[0], SLOTS)
    batches = (("free", prompts[:4], None, {}),
               ("seeded", prompts[:4], None,
                dict(temperature=0.8, top_p=0.95, seed=4321)),
               ("grammar", prompts[:2], _st_spec(STRUCT_GATEWAY), {}),
               ("mask", prompts[:2], _st_spec(STRUCT_GATEWAY), {}))
    out: dict = {}
    for c in cores:
        c.start()
    times = _ReplayTimes(cores[0]._verifies)
    try:
        with _Uncounted() as uncounted:
            for key, ps, spec, sampling in batches:
                # the mask key: the host-mask path, with fused decode off
                # (the dense layout's default) for the resident schema
                for c in cores:
                    c.fused_decode = key != "mask"
                off = _spec_run(cores[1], ps, SPEC_SHORT, None, spec=spec,
                                engine=engines[1], **sampling)
                mode = "grammar" if key == "mask" else "accept"
                runs = [_spec_run(c, ps, SPEC_SHORT, SPEC_ON, s, mode,
                                  off[0], spec=spec, engine=e, **sampling)
                        for c, s, e in zip(cores, stubs, engines)]
                if runs[0][0] != runs[1][0]:
                    shared = [_shared(a, b) for a, b in zip(runs[0][0],
                                                            runs[1][0])]
                    raise AssertionError(
                        f"spec graphs: key {key}: the replays' tokens differ "
                        f"from the eager steps' (shared {shared})")
                if spec is not None:
                    for ids, reason in zip(runs[0][0], runs[0][1]):
                        _st_accepted(engines[0], spec, ids, f"spec {key}",
                                     reason == "stop")
                out[key] = dict(
                    counts=runs[0][3],
                    verify_steps_eager=runs[1][3]["verify_steps_total"],
                    shared_off=[_shared(a, b)
                                for a, b in zip(runs[0][0], off[0])])
                log(f"spec graphs: key {key}: {len(ps)} rows x {SPEC_SHORT} "
                    f"ids, replays = eager steps, token for token; counters "
                    f"{runs[0][3]}; ids shared with spec off "
                    f"{out[key]['shared_off']}")
        info = cores[0].decode_graph_info()["verify"]
        modes = {k.rsplit("/", 1)[-1] for k in info["keys"]}
        seeded = any("/seeded" in k for k in info["keys"])
        if not ({"grammar", "mask"} <= modes and seeded
                and info["replays"] > 0):
            raise AssertionError(f"spec graphs: keys {sorted(info['keys'])}")
        # a constrained row cut short at SPEC_SHORT ids counts as a
        # violation (the grammar did not accept yet); every id above walked
        # the port's DFA
        violations = cores[0].stats().structured.constraint_violations_total
        out.update(violations=violations,keys={k: {"capture_s": v["capture_s"],
                             "pool_bytes": v["pool_bytes"],
                             "nodes": v["nodes"]}
                         for k, v in info["keys"].items()},
                   replay_ms=times.median_ms(), replays=info["replays"],
                   launches=uncounted.launches)
        log(f"spec graphs [{dev['smi']}]: verify keys {out['keys']}; replay "
            f"ms {out['replay_ms']}; {info['replays']} replays; rows cut short "
            f"before their grammar accepted {violations}; launches (not "
            f"counted with the main path) {uncounted.launches}")
        return out
    finally:
        times.close()
        for s in stubs:
            s.close()
        for e in engines:
            e.shutdown()
        del cores, engines
        gc.collect()
        torch.cuda.empty_cache()


def _budget_block(core, prompts, long_prompt, dev: dict) -> dict:
    """A10b on two EngineCores over the phase's params (SLOTS + 1 slots,
    capacity 2048, prefix cache on): prefill_chunk_budget BUDGET, and 0. On
    each, SLOTS rows of BUDGET_DECODER_TOKENS-token prompts decode (at the
    1024 window throughout); a prompt of the long one's length with a head
    of its own runs first beside them (its graph keys captured: the 2048
    window's first burst is eager and captures), then the long prompt
    arrives: the largest gap between one decoder's consecutive fetches
    while it prefills, its TTFT and its prefill dispatches. With the
    budget, C3: the long prompt again on the idle core, a prefix hit, whose
    first-token logits must equal the cold run's (prefilled beside the
    decoders) bit for bit. Their launches are not the main path's."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, \
        SamplingParams

    def req(p, n):
        r = Request(prompt_ids=list(p), sampling=SamplingParams(
            max_tokens=n, temperature=0.0))
        r.events = _StampedEvents()
        return r

    out: dict = {}
    for budget in (0, BUDGET):
        b = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=SLOTS + 1, slot_capacity=BUDGET_CAPACITY,
                       eos_id=-1, prefill_chunk_budget=budget)
        b.start()
        spy = _LogitSpy(b)
        try:
            with _Uncounted():
                decs = [req(p, BUDGET_CAPACITY - PAGE) for p in prompts]
                for r in decs:
                    b.submit(r)
                t_end = time.monotonic() + 120
                while min(len(r.events.stamps) for r in decs) < 2 * 9:
                    if time.monotonic() > t_end:
                        raise AssertionError("budget: the decoders stall")
                    time.sleep(0.005)
                warm = req(_fresh_head(long_prompt, 0), 4)
                b.submit(warm)
                _st_collect(warm)
                d0 = b.prefill_dispatches
                g0 = len(b._bursts.graphs)
                t0 = time.monotonic()
                long = req(long_prompt, 4)
                b.submit(long)
                _, _, ttft, stamps = _st_collect(long)
                dispatches = b.prefill_dispatches - d0
                captures = len(b._bursts.graphs) - g0
                gaps = []
                for r in decs:
                    ts = [t for _, t in _st_fetches(list(r.events.stamps))]
                    before = [t for t in ts if t < t0][-1:]
                    after = [t for t in ts if t > stamps[0]][:1]
                    seq = before + [t for t in ts
                                    if t0 <= t <= stamps[0]] + after
                    gaps += [y - x for x, y in zip(seq, seq[1:])]
                for r in decs:
                    r.cancel()
                _wait_idle(b)
                res = dict(max_gap_ms=max(gaps) * 1e3, ttft_ms=ttft * 1e3,
                           prefill_dispatches=dispatches, captures=captures)
                if budget:
                    h0 = b.stats().prefix.prefix_hits_total
                    hit = req(long_prompt, 4)
                    b.submit(hit)
                    _, _, hit_ttft, _ = _st_collect(hit)
                    if b.stats().prefix.prefix_hits_total != h0 + 1:
                        raise AssertionError("budget: the repeat did not hit")
                    cold, warm = spy.get(long_prompt, None)[-2:]
                    if not torch.equal(cold, warm):
                        raise AssertionError(
                            "budget: C3: the hit's first-token logits are not "
                            "the cold run's (max |diff| "
                            f"{(cold - warm).abs().max().item():.3e})")
                    res.update(hit_ttft_ms=hit_ttft * 1e3, c3="bit for bit")
            out[budget] = res
            log(f"budget [{dev['smi']}]: prefill_chunk_budget {budget}: "
                f"{len(long_prompt)}-token prompt beside {SLOTS} decoders: "
                f"largest decoder fetch gap {res['max_gap_ms']:.1f} ms, TTFT "
                f"{res['ttft_ms']:.1f} ms, {dispatches} prefill dispatches, "
                f"{captures} graph captures inside the window"
                + (f"; its prefix hit on the idle core {hit_ttft * 1e3:.1f} "
                   "ms TTFT, first-token logits the cold run's bit for bit"
                   if budget else ""))
        finally:
            spy.close()
            b.stop()
            del b
            gc.collect()
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- disaggregation

DISAGG_CHATS = 6  # chat prompts served together on each core
DISAGG_DECODERS = 6  # the isolation run's decoders, of DISAGG_DECODER_TOKENS
DISAGG_DECODER_TOKENS = 128
DISAGG_LONGS = 3  # ~1500-token prompts arriving beside the decoders
DISAGG_LONG_TOKENS = 4
DISAGG_HEAD = 60  # _fresh_head offsets of the block's prompts: misses
DISAGG_SEEDED = dict(temperature=0.8, top_p=0.95, seed=4242)
DISAGG_CHAT_TOKENS = 32  # each chat's and each handoff's greedy ids


def _disagg_ids(core, prompts, n: int, **sampling) -> list[list[int]]:
    """The ids of requests submitted together (greedy unless `sampling`
    says otherwise)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    sampling.setdefault("temperature", 0.0)
    reqs = [Request(prompt_ids=list(p),
                    sampling=SamplingParams(max_tokens=n, **sampling))
            for p in prompts]
    for r in reqs:
        core.submit(r)
    return [_collect(r)[0] for r in reqs]


def _disagg_isolation(core, decoders, longs) -> dict:
    """DISAGG_DECODERS greedy decoders; once each has its first fetch, the
    long prompts arrive. The decoders' largest gap between consecutive
    fetches from then to their end, their ITL p50 over it (each fetch's gap
    over its ids), the prefill dispatches by loop over the run, and the
    request ids."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    def req(p, n):
        r = Request(prompt_ids=list(p), sampling=SamplingParams(
            max_tokens=n, temperature=0.0))
        r.events = _StampedEvents()
        return r

    ledger0 = dict(core.prefill_dispatch_by_loop)
    decs = [req(p, DISAGG_DECODER_TOKENS) for p in decoders]
    for r in decs:
        core.submit(r)
    t_end = time.monotonic() + 300
    while min(len(r.events.stamps) for r in decs) < 1:
        if time.monotonic() > t_end:
            raise AssertionError("disagg: the decoders stall")
        time.sleep(0.002)
    t0 = time.monotonic()
    lreqs = [req(p, DISAGG_LONG_TOKENS) for p in longs]
    for r in lreqs:
        core.submit(r)
    outs = [_st_collect(r) for r in decs + lreqs]
    gaps, itls = [], []
    for r in decs:
        fetches = _st_fetches(list(r.events.stamps))
        before = [f for f in fetches if f[1] < t0][-1:]
        seq = before + [f for f in fetches if f[1] >= t0]
        for (_, a), (c, b) in zip(seq, seq[1:]):
            gaps.append(b - a)
            itls.append((b - a) / c)
    ledger = {k: v - ledger0[k] for k, v in core.prefill_dispatch_by_loop.items()}
    return dict(max_gap_ms=max(gaps) * 1e3,
                itl_p50_ms=statistics.median(itls) * 1e3,
                prefill_by_loop=ledger, rids=[r.request_id for r in decs + lreqs],
                ids=[o[0] for o in outs])


def _handoff_http(pre_base: str, dec_base: str, body: dict,
                  land: bool) -> dict:
    """POST /v1/handoff/prefill, then /v1/handoff with the envelope (less
    its KV pages unless `land`), read to its end: the adopted ids, the
    envelope's bytes, the prefill POST's wall, and the first new id's time
    after the adopt POST."""
    t0 = time.perf_counter()
    with _post(pre_base + "/v1/handoff/prefill", body) as resp:
        out = json.loads(resp.read())
    prefill_s = time.perf_counter() - t0
    envelope = out["handoff"]
    if out["finish"] is not None or "kv_pages" not in envelope:
        raise AssertionError(f"disagg: /v1/handoff/prefill answered finish "
                             f"{out['finish']}, keys {sorted(envelope)}")
    nbytes = len(json.dumps(envelope).encode())
    if not land:
        envelope = {k: v for k, v in envelope.items() if k != "kv_pages"}
    committed = len(envelope["committed_ids"])
    ids, finish, first_new = [], None, None
    t0 = time.perf_counter()
    with _post(dec_base + "/v1/handoff", {"handoff": envelope, "stream": True,
                                          "llmlb_replay": True}) as resp:
        for data in _sse_lines(resp):
            if data == b"[DONE]":
                continue
            obj = json.loads(data)
            if obj.get("object") == "llmlb.replay":
                ids.extend(obj["tokens"])
                if first_new is None and len(ids) > committed:
                    first_new = time.perf_counter() - t0
            for c in obj.get("choices") or []:
                finish = c.get("finish_reason") or finish
    return dict(ids=ids, finish=finish, committed=committed,
                envelope_bytes=nbytes, prefill_post_s=prefill_s,
                first_new_s=first_new)


def _disagg_block(core, engine, prompt: list[int], long_prompt: list[int],
                  stats: dict, dev: dict) -> dict:
    """A14 over the phase's params (every engine shares the serving core's
    weights), after its counts. The block's launches are counted from 0,
    the serving core's comparison runs taken back out (_Uncounted), and
    each kernel of the path must launch.

    (a) An in-process `role="split"` EngineCore with the serving defaults
    (8 slots: a prefill pool of 2): its greedy ids for the 124-token and
    the ~1500-token prompt are the serving core's (`stats`), those of
    DISAGG_CHATS chats served together and of one seeded row are the
    serving core's for the same traffic, bit for bit. Then the isolation
    run on it and on the serving core: no prefill dispatch on the decode
    loop or the main loop, and at least decoders + long prompts handoffs;
    the decoders' largest fetch gap and ITL p50 on each, and the staged to
    adopted latency p50 from the flight records.

    (b) A `role="prefill"` and a `role="decode"` engine behind two HTTP
    servers: a chat prefilled on the first (POST /v1/handoff/prefill, one
    committed id) and adopted on the second (POST /v1/handoff), replayed
    (the envelope without its pages: the adopter counts them absent) and
    landed (with them: the adopter runs no prefill dispatch); both give
    the serving core's ids."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.ops import cuda_attention as ca

    out: dict = {}
    chats = [engine.encode_chat([{"role": "user", "content":
                                  f"Disagg chat {i}: a haiku about pages."}])
             for i in range(DISAGG_CHATS)]
    seeded = _fresh_head(prompt, DISAGG_HEAD + 20)
    decoders = [_fresh_head(prompt, DISAGG_HEAD + i)
                for i in range(DISAGG_DECODERS)]
    longs = [_fresh_head(long_prompt, DISAGG_HEAD + 10 + i)
             for i in range(DISAGG_LONGS)]
    chat_msgs = [{"role": "user",
                  "content": "Disagg handoff: tell me about paged attention."}]
    with _Uncounted():
        want_chats = _disagg_ids(core, chats, DISAGG_CHAT_TOKENS)
        want_seeded = _disagg_ids(core, [seeded], DISAGG_CHAT_TOKENS,
                                  **DISAGG_SEEDED)[0]
        want_handoff = _disagg_ids(core, [engine.encode_chat(chat_msgs)],
                                   DISAGG_CHAT_TOKENS)[0]
        _wait_idle(core)
        both = _disagg_isolation(core, decoders, longs)
    ca.reset_launch_counts()

    split = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                       role="split")
    split.start()
    try:
        pools = (len(split.split.prefill_pool), len(split.split.decode_pool))
        got = {
            "124": _disagg_ids(split, [prompt], len(stats["ids"]))[0],
            "long": _disagg_ids(split, [long_prompt],
                                len(stats["long_ids"]))[0],
            "chats": _disagg_ids(split, chats, DISAGG_CHAT_TOKENS),
            "seeded": _disagg_ids(split, [seeded], DISAGG_CHAT_TOKENS,
                                  **DISAGG_SEEDED)[0]}
        want = {"124": stats["ids"], "long": stats["long_ids"],
                "chats": want_chats, "seeded": want_seeded}
        for k in want:
            if got[k] != want[k]:
                raise AssertionError(f"disagg: the split core's {k} ids part "
                                     "from the serving core's")
        h0 = split.metrics.handoff_total["in_process"]
        iso = _disagg_isolation(split, decoders, longs)
        handoffs = split.metrics.handoff_total["in_process"] - h0
        ledger = iso["prefill_by_loop"]
        if (ledger["decode"] or ledger["main"] or not ledger["prefill"]
                or handoffs < DISAGG_DECODERS + DISAGG_LONGS):
            raise AssertionError(f"disagg: prefill dispatches by loop "
                                 f"{ledger}, {handoffs} handoffs")
        if split.decode_dispatch_by_loop["main"] or split.decode_dispatch_by_loop[
                "prefill"]:
            raise AssertionError("disagg: decode dispatches off the decode "
                                 f"loop: {split.decode_dispatch_by_loop}")
        staged = []
        for rid in iso["rids"]:
            tl = split.flightrec.timeline(rid) or {"events": []}
            staged += [e["attrs"]["staged_s"] for e in tl["events"]
                       if e["event"] == "adopted"]
        iso_same = sum(a == b for a, b in zip(iso["ids"], both["ids"]))
        out.update(split_pools=pools, split_handoffs=handoffs,
                   prefill_by_loop=ledger,
                   decode_by_loop=dict(split.decode_dispatch_by_loop),
                   max_gap_ms=iso["max_gap_ms"], itl_p50_ms=iso["itl_p50_ms"],
                   both_max_gap_ms=both["max_gap_ms"],
                   both_itl_p50_ms=both["itl_p50_ms"],
                   staged_p50_ms=statistics.median(staged) * 1e3,
                   staged_n=len(staged))
        log(f"disagg [{dev['smi']}]: split core (prefill pool "
            f"{pools[0]}, decode pool {pools[1]}): greedy ids of the "
            f"{len(prompt)}-token prompt ({len(got['124'])}), the "
            f"{len(long_prompt)}-token prompt ({len(got['long'])}), "
            f"{DISAGG_CHATS} chats served together ({DISAGG_CHAT_TOKENS} "
            "each) and one seeded row are the serving core's bit for bit")
        log(f"disagg [{dev['smi']}]: {DISAGG_DECODERS} decoders x "
            f"{DISAGG_DECODER_TOKENS} ids with {DISAGG_LONGS} "
            f"{len(longs[0])}-token prompts arriving: prefill dispatches by "
            f"loop {ledger}, decode dispatches by loop "
            f"{out['decode_by_loop']}, {handoffs} in-process handoffs; "
            f"largest decoder fetch gap {iso['max_gap_ms']:.1f} ms split, "
            f"{both['max_gap_ms']:.1f} ms both; decoder ITL p50 "
            f"{iso['itl_p50_ms']:.2f} ms split, {both['itl_p50_ms']:.2f} ms "
            f"both; staged to adopted p50 {out['staged_p50_ms']:.1f} ms over "
            f"{len(staged)} handoffs; {iso_same} of "
            f"{len(iso['ids'])} streams the serving core's")
    finally:
        split.stop()
        del split
        gc.collect()
        torch.cuda.empty_cache()

    engines, servers = [], []
    try:
        for role in ("prefill", "decode"):
            e = Engine("llama-3-8b", EngineCore(
                core.cfg, core.params, device=core.device, seed=0,
                num_slots=4, slot_capacity=CAPACITY, eos_id=-1, role=role),
                engine.tokenizer)
            e.core.start()
            engines.append(e)
            servers.append(start_server(e))
        pre_base, dec_base = ("http://%s:%d" % s.server_address[:2]
                              for s, _ in servers)
        adopter = engines[1].core
        body = {"model": "llama-3-8b", "temperature": 0,
                "max_tokens": DISAGG_CHAT_TOKENS, "messages": chat_msgs}
        for land in (False, True):
            name = "landed" if land else "replayed"
            d0 = adopter.prefill_dispatches
            r = _handoff_http(pre_base, dec_base, body, land)
            prefills = adopter.prefill_dispatches - d0
            if (r["ids"], r["finish"]) != (want_handoff, "length"):
                raise AssertionError(
                    f"disagg: the {name} handoff's ids share "
                    f"{_shared(r['ids'], want_handoff)} of "
                    f"{len(want_handoff)} with the serving core's")
            if (prefills == 0) != land:
                raise AssertionError(f"disagg: the {name} adoption ran "
                                     f"{prefills} prefill dispatches")
            out[name] = {k: r[k] for k in ("envelope_bytes", "prefill_post_s",
                                           "first_new_s")}
            out[name]["adopter_prefills"] = prefills
            log(f"disagg [{dev['smi']}]: cross-process handoff, {name}: "
                f"envelope {r['envelope_bytes']} bytes ({r['committed']} "
                f"committed id), POST /v1/handoff/prefill "
                f"{r['prefill_post_s'] * 1e3:.1f} ms, first new id "
                f"{r['first_new_s'] * 1e3:.1f} ms after the POST "
                f"/v1/handoff; {prefills} adopter prefill dispatches; "
                f"{len(r['ids'])} ids the serving core's")
        out["handoff_totals"] = [e.core.metrics.handoff_counts()[0]
                                 for e in engines]
    finally:
        for s, th in servers:
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
        for e in engines:
            e.shutdown()
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(ca.LAUNCHES)
    out["launches"] = launches
    missing = [k for k in BF16_PATH if launches[k] <= 0]
    stray = [k for k, n in launches.items() if k not in BF16_PATH and n]
    log(f"disagg: launches over the block's path {launches}")
    if missing or stray:
        raise AssertionError(f"disagg: kernels never launched {missing}, of "
                             f"another path {stray}")
    return out


# ------------------------------------------------------------ observability

OBS_TOKENS = 1100  # each 8-row decode's greedy ids: 137 bursts, more than
# the 128 records of the throughput window perf_info reads
OBS_DEVICE_TOL = 0.10  # a record's device ms a step against profile_step's
OBS_PROFILE_S = 0.5  # the profile capture's seconds of decode
OBS_FLIGHT_TOKENS = 32  # the recorder on/off stream's greedy ids


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as resp:
        return json.loads(resp.read())


def _obs_prompts(engine, tag: str, n: int = SLOTS,
                 chars: int = 130) -> list[list[int]]:
    """n chat prompts of one length (~40 tokens more than `chars`, one
    prefill group), each with a head of its own (no prefix-cache hit)."""
    prompts = [engine.encode_chat([{"role": "user", "content":
                                    f"{tag} {i:02d}: " + "q" * chars}])
               for i in range(n)]
    if len({len(p) for p in prompts}) != 1:
        raise AssertionError("the observability prompts differ in length")
    return prompts


def _submit_together(core, prompts, max_tokens: int, tag: str) -> list:
    """Submit one greedy request a prompt between two loop iterations, so
    they prefill as one group and decode together; gateway ids
    `{tag}-{i}`."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    reqs = [Request(prompt_ids=list(p), request_id=f"{tag}-{i}.0000abcd",
                    sampling=SamplingParams(temperature=0.0,
                                            max_tokens=max_tokens))
            for i, p in enumerate(prompts)]
    core.call_in_loop(lambda: [core.submit(r) for r in reqs])
    return reqs


def _prom_families(text: str) -> set[str]:
    """Parse Prometheus text: every sample a `name{labels} value` line of a
    family its `# TYPE` declared (histograms with their _bucket, _sum and
    _count); returns the families."""
    families: dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if kind not in ("counter", "gauge", "histogram"):
                raise AssertionError(f"/metrics: bad type line {line!r}")
            families[name] = kind
            continue
        m = re.match(r"^([a-z_]+)(\{[^}]*\})? (\S+)$", line)
        if m is None:
            raise AssertionError(f"/metrics: bad sample line {line!r}")
        float(m.group(3))
        name = m.group(1)
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in families and families.get(base) != "histogram":
            raise AssertionError(f"/metrics: {name} has no # TYPE line")
    return set(families)


def _graph_row(core, ctx: int) -> dict:
    """profile_step's graph row for the serving shape: one burst of 8 steps
    over 8 rows at `ctx` as one graph replay, over pages reserved from the
    core's pool (freed after), on the loop's thread."""
    import torch

    from llmlb_tpu_torch import profile_step as ps

    def run():
        need = core._pages_for_tokens(ctx + ps.BURST + 1)
        pages = core._try_reserve_pages(SLOTS * need)
        if pages is None:
            raise AssertionError("no pages for profile_step's graph row")
        try:
            tables = torch.zeros((SLOTS, core.pages_per_slot),
                                 dtype=torch.int32, device=core.device)
            tables[:, :need] = torch.tensor(pages, dtype=torch.int32,
                                            device=core.device).view(SLOTS,
                                                                     need)
            fns = ps._dispatches(core.cfg, core.params, core.cache_k,
                                 core.cache_v, tables, core.device, ctx, ctx)
            return ps._profile(
                fns[f"decode graph burst={ps.BURST} rows={SLOTS} ctx={ctx}"],
                5)
        finally:
            torch.cuda.synchronize()
            for p in pages:
                core.page_pool.unref(p)
    return core.call_in_loop(run)


def _decode_records(base: str, after: int, rows: int) -> list[dict]:
    """The decode records of `rows` rows since record `after`, oldest
    first, from /api/steps."""
    steps = _get_json(base + "/api/steps?limit=512")
    return [r for r in reversed(steps["records"])
            if r["seq"] > after and r["kind"] == "decode"
            and r["active_slots"] == rows]


def _obs_records(core, engine, base: str, dev: dict) -> dict:
    """8 rows decode OBS_TOKENS ids each while /api/health is polled: the
    records' phases sum to their totals, replays count one dispatch, each
    replayed record's device ms a step agrees with profile_step's graph
    row within OBS_DEVICE_TOL, and the perf block read while the window
    holds only these bursts is available, mfu and bandwidth in (0, 1]."""
    import torch

    # every window key the rows will cross (512 to 2048) captured first,
    # so the measured bursts are replays and the window holds no capture
    for chars in (260, 560, 1060):
        warm = _obs_prompts(engine, "Window warm", 1, chars)[0]
        if len(warm) + 32 < core.slot_capacity:
            _collect(_submit(core, warm, 16))
    seq0 = core.step_stats.seq
    prompts = _obs_prompts(engine, "Observability row")
    samples: list[dict] = []
    done = threading.Event()

    def poll():
        while not done.wait(0.2):
            h = _get_json(base + "/api/health")
            samples.append({"perf": h["perf"],
                            "active": h["engine"]["active_slots"]})
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        reqs = _submit_together(core, prompts, OBS_TOKENS, "obs")
        outs = [_collect(r) for r in reqs]
    finally:
        done.set()
        poller.join(timeout=30)
    wall = time.perf_counter() - t0
    if any(len(ids) != OBS_TOKENS for ids, _ in outs):
        raise AssertionError("an observability row ended early")
    recs = _decode_records(base, seq0, SLOTS)
    if len(recs) < OBS_TOKENS // core.decode_burst - 2:
        raise AssertionError(f"only {len(recs)} 8-row decode records")
    for r in recs:
        if abs(r["total_s"] - sum(r["phases_s"].values())) > 1e-5:
            raise AssertionError(f"record {r['seq']}: phases do not sum to "
                                 f"total_s {r['total_s']}")
    replayed = [r for r in recs if r["dispatches"] == 1]
    eager = [r for r in recs if r["dispatches"] != 1]
    if not replayed or any(r["dispatches"] != core.decode_burst
                           for r in eager):
        raise AssertionError(f"decode records' dispatches "
                             f"{sorted({r['dispatches'] for r in recs})}")
    if any(r["device_ms"] is None for r in recs):
        raise AssertionError("a decode record has no device time")
    # the records at the 256 window: context n + 8 (i + 1) after burst i
    n = len(prompts[0])
    first = [(r, n + core.decode_burst * (i + 1)) for i, r in enumerate(recs)
             if n + core.decode_burst * (i + 1) + 1 <= 256
             and r["dispatches"] == 1]
    ctx = round(sum(c for _, c in first) / len(first))
    row = _graph_row(core, ctx)
    want = row["device_ms"] / core.decode_burst
    per_step = [r["device_ms"] / core.decode_burst for r, _ in first]
    worst = max(abs(x - want) / want for x in per_step)
    log(f"serve bf16 [{dev['smi']}]: observability: {len(recs)} 8-row decode "
        f"records ({len(replayed)} replays, {len(eager)} eager with "
        f"{core.decode_burst} dispatches) in {wall:.1f} s; phases sum to "
        f"total_s; a replay's device ms a step at the 256 window "
        f"{min(per_step):.3f}..{max(per_step):.3f} against profile_step's "
        f"graph row at ctx {ctx} {want:.3f} (wall "
        f"{row['wall_ms'] / core.decode_burst:.3f}, launches "
        f"{row['launches']:.0f} a replay): worst {worst * 100:.2f}% "
        f"(limit {OBS_DEVICE_TOL * 100:.0f}%)")
    if worst > OBS_DEVICE_TOL:
        raise AssertionError(f"a record's device ms is {worst * 100:.1f}% "
                             "off profile_step's graph row")
    ph = {p: sum(r["phases_s"][p] for r in replayed) / len(replayed)
          for p in replayed[0]["phases_s"]}
    total = sum(r["total_s"] for r in replayed) / len(replayed)
    dev_ms = sum(r["device_ms"] for r in replayed) / len(replayed)
    log(f"serve bf16: observability: a replayed 8-row burst's mean total "
        f"{total * 1e3:.2f} ms: " + ", ".join(
            f"{p} {v * 1e3:.3f}" for p, v in ph.items())
        + f" ms; device {dev_ms:.2f} ms")
    # the perf block, read while the 8 rows decode with a window of their
    # bursts only (128 records of 64 ids)
    full = [s for s in samples if s["active"] == SLOTS
            and s["perf"].get("window_tokens") == 128 * SLOTS
            * core.decode_burst]
    if not full:
        raise AssertionError(f"no /api/health sample with a full window of "
                             f"8-row bursts among {len(samples)}")
    perf = full[-1]["perf"]
    log(f"serve bf16 [{dev['smi']}]: observability: /api/health perf while "
        f"8 rows decode: {json.dumps(perf)}")
    if not (perf["available"] and 0 < perf["mfu"] <= 1
            and 0 < perf["hbm_bw_utilization"] <= 1):
        raise AssertionError(f"perf block out of (0, 1]: {perf}")
    # the gpu block against torch's own figures, read at the same point
    # (the engine idle between the two reads)
    props = torch.cuda.get_device_properties(core.device)
    for _ in range(5):
        before = torch.cuda.memory_allocated(core.device)
        gpu = _get_json(base + "/api/health")["gpu"]
        after = torch.cuda.memory_allocated(core.device)
        if before == after:
            break
    if gpu["hbm_total_bytes"] != props.total_memory or not (
            gpu["hbm_used_bytes"] == before == after):
        raise AssertionError(f"gpu block {gpu} against total "
                             f"{props.total_memory}, allocated {before} / "
                             f"{after}")
    log(f"serve bf16: observability: gpu block {json.dumps(gpu)} = torch's "
        "total_memory and memory_allocated")
    return {"records": len(recs), "replays": len(replayed),
            "device_ms_step": per_step, "graph_row_ms_step": want,
            "graph_row_ctx": ctx, "device_tol_worst": worst,
            "burst_total_ms": total * 1e3, "burst_device_ms": dev_ms,
            "phases_ms": {p: v * 1e3 for p, v in ph.items()}, "perf": perf,
            "gpu": gpu}


def _obs_profile(core, engine, base: str) -> dict:
    """POST /api/profile for OBS_PROFILE_S of 8-row decode at contexts
    ~300..460 (the 512 window: two key splits a row, so the combine kernel
    runs): the capture zips to an artifact whose Chrome trace is searched
    for the paged decode's split and combine kernels, which run inside
    graph replays."""
    import io
    import zipfile

    reqs = _submit_together(core, _obs_prompts(engine, "Profiled row",
                                               chars=260), 160, "prof")
    first = reqs[0].events.get(timeout=600)  # decoding has begun
    with _post(base + "/api/profile", {"action": "start",
                                       "seconds": OBS_PROFILE_S}) as resp:
        started = json.loads(resp.read())
    t0 = time.perf_counter()
    while True:  # stopped, and its trace written
        status = _get_json(base + "/api/profile")
        if (not status["recording"] and status["captures"]
                and status["captures"][0]["capture_id"]
                == started["capture_id"]):
            break
        if time.perf_counter() - t0 > 300:
            raise AssertionError("the profile capture never completed")
        time.sleep(0.1)
    capture = status["captures"][0]
    if "error" in capture:
        raise AssertionError(f"profile capture failed: {capture}")
    with urllib.request.urlopen(base + capture["download"],
                                timeout=600) as resp:
        blob = resp.read()
    outs = [_collect(r) for r in reqs]
    if first[0] != "token" or any(f != "length" for _, f in outs):
        raise AssertionError("a profiled row did not finish")
    trace = json.loads(zipfile.ZipFile(io.BytesIO(blob)).read("trace.json"))
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    graph_launches = sum(1 for e in trace["traceEvents"]
                         if e.get("name") == "cudaGraphLaunch")
    seen = {m: sum(1 for k in kernels if m in k) for m in PAGED_DECODE_MARKS}
    log(f"serve bf16: observability: /api/profile capture {OBS_PROFILE_S} s "
        f"of 8-row decode ({capture['duration_s']} s held): trace "
        f"{capture['bytes']} bytes, zip {len(blob)} bytes; "
        f"{len(trace['traceEvents'])} events, {len(kernels)} kernels, "
        f"{graph_launches} cudaGraphLaunch calls; the paged decode's "
        f"kernels inside the replays: {seen}")
    if not all(seen.values()):
        log("serve bf16: observability: FINDING: the capture shows "
            f"{graph_launches} graph replays without the paged decode's "
            f"kernels {[m for m, n in seen.items() if not n]} inside them")
    return {"trace_bytes": capture["bytes"], "zip_bytes": len(blob),
            "kernels": len(kernels), "graph_launches": graph_launches,
            "decode_kernels": seen, "held_s": capture["duration_s"]}


def _observability_block(core, engine, base: str, dev: dict) -> dict:
    """The step records, the perf and gpu blocks, /metrics, a flight
    record, the recorder's off switch, a verify record, a profile capture
    and the dispatch check, on the bf16 core over its server (after the
    launch counts)."""
    from llmlb_tpu_torch.engine import dispatch_check
    from llmlb_tpu_torch.engine.flightrec import FlightRecorder

    out = _obs_records(core, engine, base, dev)
    # one request's flight record, in seq order
    tl = _get_json(base + "/api/requests/obs-0/timeline")
    names = [e["event"] for e in tl["events"]]
    seqs = [e["seq"] for e in tl["events"]]
    if (names[:2] != ["admitted", "queued"] or "prefill_chunk" not in names
            or names[-1] != "finished" or seqs != sorted(seqs)):
        raise AssertionError(f"timeline of obs-0: {names}")
    log(f"serve bf16: observability: the timeline of obs-0: {names}")
    # /metrics: Prometheus text, every family the reference's (each is
    # in docs/monitoring/README.md, which documents every series the
    # reference renders; the CPU tests hold the families to its render)
    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    families = _prom_families(text)
    docs = (REPO / "docs" / "monitoring" / "README.md").read_text()
    unknown = sorted(f for f in families if f not in docs)
    if unknown or "llmlb_engine_mfu_ratio" not in families:
        raise AssertionError(f"/metrics families not the reference's: "
                             f"{unknown}")
    log(f"serve bf16: observability: /metrics parses: {len(families)} "
        f"families, {len(text.splitlines())} lines, each one the "
        "reference renders")
    # a verify record with its draft phase
    seq0 = core.step_stats.seq
    prompt = _spec_prompts(engine, 1)[0]
    _collect(_submit(core, prompt, SPEC_SHORT, speculative=SPEC_ON))
    steps = _get_json(base + "/api/steps?limit=64")["records"]
    verify = [r for r in steps if r["seq"] > seq0 and r["kind"] == "verify"]
    if not verify or not all(r["phases_s"]["draft"] > 0 for r in verify):
        raise AssertionError(f"no verify record with a draft phase: "
                             f"{[r['kind'] for r in steps[:8]]}")
    v = verify[0]
    log(f"serve bf16: observability: {len(verify)} verify records, e.g. "
        f"draft {v['phases_s']['draft'] * 1e3:.3f} ms, total "
        f"{v['total_s'] * 1e3:.2f} ms, dispatches {v['dispatches']}, device "
        f"{v['device_ms']:.2f} ms")
    # the recorder off: the same greedy ids (a prompt under 128 tokens: no
    # prefix-cache hit)
    short = engine.encode_chat([{"role": "user", "content":
                                 "Recorder check: say something."}])
    on = _timed_core_request(core, short, OBS_FLIGHT_TOKENS)[0]
    real = core.flightrec
    core.flightrec = FlightRecorder(enabled=False)
    try:
        off = _timed_core_request(core, short, OBS_FLIGHT_TOKENS)[0]
    finally:
        core.flightrec = real
    if on != off:
        raise AssertionError(f"the recorder off changes the stream after "
                             f"{_shared(on, off)} ids")
    log(f"serve bf16: observability: {OBS_FLIGHT_TOKENS} greedy ids equal "
        "with the flight recorder on and off")
    out["profile"] = _obs_profile(core, engine, base)
    t0 = time.perf_counter()
    findings = dispatch_check.run_check("cuda")
    if findings:
        raise AssertionError(f"dispatch check: {findings}")
    log(f"serve bf16: observability: dispatch check passed on the card in "
        f"{time.perf_counter() - t0:.1f} s (int8 KV, an adapter, "
        "speculation and a JSON-schema row; one model step a decode or "
        "verify record after its key's warm-up)")
    out["verify"] = {k: v[k] for k in ("total_s", "dispatches", "device_ms")}
    return out


def phase_serve(dev: dict, label: str, path: tuple[str, ...],
                bf16_ids: list[int] | None = None,
                bf16_long_ids: list[int] | None = None,
                ckpt: dict | None = None,
                structured_ids: list[list[int]] | None = None,
                **core_kwargs) -> dict:
    """Serve Llama-3-8B at full width and depth, random weights from seed 0
    (with `ckpt`, the same weights loaded from the written checkpoint),
    through the HTTP server, then time requests on its core. `core_kwargs`
    pick the path (quantize="all", kv_layout="dense", lora_dir=...).
    Returns the metrics, the greedy ids of the timed prompts (124 and ~1500
    tokens) and the kernel launches of this run."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.ops import cuda_attention as ca

    lora = "lora_dir" in core_kwargs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    load = None
    if ckpt is not None:
        engine, load = _checkpoint_engine(label, ckpt, core_kwargs, dev)
    else:
        engine = Engine.from_preset("llama-3-8b", device="cuda", seed=0,
                                    num_slots=SLOTS, slot_capacity=CAPACITY,
                                    eos_id=-1, **core_kwargs)
    core = engine.core
    torch.cuda.synchronize()
    kv_info = core.kv_cache_info()
    log(f"serve {label}: llama-3-8b random weights (seed 0"
        f"{', from the checkpoint' if ckpt is not None else ''}) on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"(params {core.param_bytes / 2**30:.2f} GiB, KV "
        f"{kv_info['hbm_bytes'] / 2**30:.2f} GiB {kv_info['layout']} "
        f"{kv_info['kv_dtype']}); decode burst {core.decode_burst}")
    if core_kwargs.get("quantize") == "all" and kv_info["kv_dtype"] != "int8":
        raise AssertionError(f"quantize=all serves a {kv_info['kv_dtype']} "
                             "KV pool")
    if kv_info["layout"] != core_kwargs.get("kv_layout", "paged"):
        raise AssertionError(f"the engine serves the {kv_info['layout']} "
                             "layout")
    server, thread = start_server(engine)
    base = "http://%s:%d" % server.server_address[:2]
    stats: dict = {"checkpoint": load} if load is not None else {}
    try:
        ca.reset_launch_counts()
        long_text = " ".join(f"w{i % 97}" for i in range(380))  # ~1500 tokens
        # the long prompt's timed runs: two with heads of their own (misses),
        # then two hits on the first
        long_prompts = [engine.encode_chat([{"role": "user", "content":
                                             _first_word(long_text, j)}])
                        for j in (1, 2)]
        # the prefix cache first, while it is empty
        block = _prefix_block(core, label, lora)
        stats["prefix_counts"] = block["counts"]

        def hits() -> int:
            return core.stats().prefix.prefix_hits_total

        # the main path, over HTTP; with adapters, a mix of the base model,
        # the `lora` field and the `model:adapter` suffix
        first = _chat(base, "Tell me about paged attention.", 32, True)

        def request(i: int) -> dict:
            content = f"Request {i}: write a haiku about GPUs and TPUs."
            if lora and i % 3 == 1:
                return _chat(base, content, 32, i % 2 == 0, lora="acme")
            if lora and i % 3 == 2:
                return _chat(base, content, 32, i % 2 == 0,
                             model="llama-3-8b:beta")
            return _chat(base, content, 32, stream=i % 2 == 0)

        results = _concurrent([lambda i=i: request(i) for i in range(4)])
        long = _chat(base, long_text, 32, False,
                     lora="beta" if lora else None)
        before = hits()
        # dense (alignment 32): a hit on 32 of its tokens, which must give
        # the cold run's text all the same
        again = _chat(base, "Tell me about paged attention.", 32, True)
        for r in [first, long, again, *results]:
            assert r["usage"]["completion_tokens"] == 32, r["usage"]
            assert r["finish"] == "length", r["finish"]
        assert long["usage"]["prompt_tokens"] > 1024, long["usage"]
        assert again["text"] == first["text"], (first, again)
        if lora:
            assert results[2]["model"] == "llama-3-8b", results[2]["model"]
            with urllib.request.urlopen(base + "/v1/models",
                                        timeout=60) as resp:
                ids = [m["id"] for m in json.loads(resp.read())["data"]]
            assert {"llama-3-8b:acme", "llama-3-8b:beta"} <= set(ids), ids
        log(f"serve {label}: 4 concurrent chats"
            + (" (base, lora field, model:adapter suffix)" if lora else "")
            + f" + {long['usage']['prompt_tokens']}-token prompt"
            + (" with adapter beta" if lora else "")
            + f" + repeat over HTTP ok; repeat text identical "
            f"({'a prefix-cache hit' if hits() != before else 'a miss'})")

        # token-level determinism and timing on the same core
        prompt = engine.encode_chat([{"role": "user",
                                      "content": "x" * 100}])
        before = hits()
        spy = _LogitSpy(core)
        try:
            ids1, ttft1, rate1 = _timed_core_request(core, prompt, 64)
            if hits() != before:
                raise AssertionError("the timed prompt's first run was a hit")
            ids2, ttft2, rate2 = _timed_core_request(core, prompt, 64)
            ttft = min(ttft1, ttft2)
            if ids1 != ids2:
                raise AssertionError(f"greedy token ids differ between "
                                     f"identical runs (shared "
                                     f"{_shared(ids1, ids2)} of 64)")
            if hits() != before:
                # dense (32-token alignment): the repeat took 96 tokens from
                # the cache and ran its 28-token suffix through flash_extend
                # at the cold run's bucket (128), where the cold run ran
                # flash_prefill; the TTFT is the miss's
                ttft = ttft1
                err = _hit_within(label, "the timed prompt",
                                  *spy.get(prompt, None)[1::-1])
                log(f"serve {label}: the timed prompt's repeat hit the cache; "
                    f"its logits within the bf16 limit of the cold "
                    f"prefill's (max |diff| {err:.3e}); its 64 greedy ids "
                    "the cold run's")
        finally:
            spy.close()
        # heads of their own: misses, as the 8 were before the cache
        agg, d8, e8 = _fresh_batch(core, prompt)
        # the long prompt's TTFT: its chunks run the extend kernel; two
        # misses (heads of their own), then two hits on the first
        spy = _LogitSpy(core)
        long_name = "beta" if lora else None
        try:
            before = hits()
            long_runs = [_timed_miss(core, p, long_name)
                         for p in long_prompts]
            if hits() != before:
                raise AssertionError("a miss timing of the long prompt hit")
            hit_runs = [_timed_core_request(core, long_prompts[0],
                                            LONG_TOKENS, long_name)
                        for _ in range(2)]
            if hits() != before + 2:
                raise AssertionError("the long prompt's repeats did not hit")
        finally:
            spy.close()
        long_prompt = long_prompts[0]
        if hit_runs[0][0] != hit_runs[1][0]:
            raise AssertionError("two identical hits of the long prompt give "
                                 "different ids")
        cold_logits, *hit_logits = spy.get(long_prompt, long_name)[-3:]
        errs = [_hit_within(label, "long prompt", h, cold_logits)
                for h in hit_logits]
        fastest = min(long_runs, key=lambda r: r[1])
        stats.update({"ttft_s": ttft, "decode_tok_s_1": max(rate1, rate2),
                      "tok_s_8": agg, "tok_s_8_dispatches": d8,
                      "tok_s_8_evictions": e8, "ids": ids1,
                      "ttft_long_s": fastest[1], "long_split": fastest[2],
                      "long_ids": long_runs[0][0],
                      "ttft_long_hit_s": min(r[1] for r in hit_runs)})
        log(f"serve {label} [{dev['smi']}]: single-request TTFT "
            f"{stats['ttft_s'] * 1e3:.1f} ms ({len(prompt)}-token prompt), "
            f"{stats['ttft_long_s'] * 1e3:.1f} ms ({len(long_prompt)}-token "
            f"prompt{', adapter beta' if lora else ''}, a miss), "
            f"{stats['ttft_long_hit_s'] * 1e3:.1f} ms (the same prompt, a "
            f"prefix-cache hit), decode "
            f"{stats['decode_tok_s_1']:.1f} tok/s; 8 concurrent x 64 "
            f"tokens: {agg:.1f} tok/s incl. prefill")
        log(f"serve {label}: long prompt: hit logits within the bf16 limit of the cold run's (max |diff| "
            f"{max(errs):.3e}); hit and cold streams share "
            f"{_shared(hit_runs[0][0], long_runs[0][0])} of {LONG_TOKENS} "
            "tokens, the two hits all")
        if bf16_long_ids is not None:
            log(f"serve {label}: the first "
                f"{_shared(stats['long_ids'], bf16_long_ids)} of {LONG_TOKENS} "
                f"greedy tokens of the {len(long_prompt)}-token prompt agree "
                "with the bf16 paged run")
        if bf16_ids is not None:
            agree = _shared(ids1, bf16_ids)
            log(f"serve {label}: the first {agree} of {len(ids1)} greedy "
                "tokens of the timed prompt agree with the bf16 paged run")
            if lora and ids1 != bf16_ids:
                raise AssertionError("an adapter-free request differs from the "
                                     "LoRA-free engine's: the identity row "
                                     "must add exactly 0.0")
            if core_kwargs.get("kv_layout") == "dense" and ids1 != bf16_ids:
                raise AssertionError(
                    f"the dense stream parts from the paged bf16 one after "
                    f"{agree} of {len(ids1)} greedy tokens; "
                    f"{_dense_paged_report(core, prompt)}")
        if lora:
            acme, _, _ = _timed_core_request(core, prompt, 64, lora="acme")
            if acme == ids1:
                raise AssertionError("adapter acme changed no greedy token")
            # a mixed batch against each row's solo run: every row's tokens
            # are its solo run's (a row's prefill and decode do not depend
            # on the rows it shares a dispatch with)
            mix = [None, "acme", "beta", "acme"]
            solo = [_timed_core_request(core, prompt[:-1] + [i], 32, name)[0]
                    for i, name in enumerate(mix)]
            batch = _concurrent([lambda i=i, name=name: _timed_core_request(
                core, prompt[:-1] + [i], 32, name)[0]
                for i, name in enumerate(mix)])
            shared = [_shared(a, b) for a, b in zip(batch, solo)]
            log(f"serve {label}: acme's greedy ids share the first "
                f"{_shared(acme, ids1)} of 64 with the base model's; mixed "
                f"batch {mix} rows share {shared} of 32 tokens with their "
                "solo runs")
            if shared != [32] * len(mix):
                raise AssertionError(f"mixed batch {mix}: rows share {shared} "
                                     "of 32 tokens with their solo runs")
            info = core.lora_info()
            if info["active"] != {}:
                raise AssertionError(f"adapter refcounts left: {info['active']}")
            log(f"serve {label}: resident {info['resident']}, loads "
                f"{info['loads_total']}, refcounts drained to {{}}")
        # the later slices' traffic, counted with the main path: a priority
        # park, /v1/resume, and in bf16 the endpoints (the offload tier,
        # page exhaustion and the drain run on engines of their own after
        # the counts)
        block_s: dict[str, float] = {}
        over = _timed(block_s, "priority_park", _priority_park, core, prompt,
                      label, lora, dev, label == "bf16")
        over["resume_http"] = _timed(block_s, "resume_http", _resume_http,
                                     base, label, lora, dev)
        if label == "bf16":
            over.update(_timed(block_s, "endpoints", _endpoints, base, core,
                               dev))
            over["gateway"] = _timed(block_s, "gateway", _gateway_block,
                                     engine, base, dev)
        # speculative decoding on this core, per request, counted with the
        # main path: the whole block in bf16, one stub request elsewhere
        if label == "bf16":
            over["spec"] = _timed(block_s, "spec", _spec_block, core, engine,
                                  label, dev)
        else:
            over["spec"] = _timed(block_s, "spec", _spec_short, core, engine,
                                  label, dev, lora)
        # KV shipping on the paged layout (the dense one ships no pages, as
        # in the reference), the serving core's side counted with the main
        # path; the LoRA phase's traffic is the earlier slices'
        ship = core.page_pool is not None and not lora
        if ship:
            over["kv_ship"] = _timed(block_s, "kv_ship", _kv_ship, core,
                                     engine, base, label, dev, core_kwargs,
                                     label == "bf16")
        stats["overload"] = over
        nan_rows = core.nan_logit_rows()
        launches = dict(ca.LAUNCHES)
        stats["launches"] = launches
        log(f"serve {label}: launches over the main path {launches}; NaN "
            f"logit rows {nan_rows}")
        if nan_rows:
            raise AssertionError(f"{nan_rows} logit rows had NaN")
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        stray = [k for k, n in launches.items() if k not in path and n]
        if stray:
            raise AssertionError(f"kernels of another path launched: {stray}")
        if label == "bf16":
            # step records, perf, gpu, /metrics, a flight record, a
            # profile capture and the dispatch check, after the counts
            over["observability"] = _timed(block_s, "observability",
                                           _observability_block, core, engine,
                                           base, dev)
        if hasattr(core, "decode_graph_info"):  # not in trees before graphs
            _graph_counters(core, label, dev)
            stats.update(_graph_vs_eager(core, prompt, label, lora, dev,
                                         core_kwargs))
            stats["graphs"] = _graph_counters(core, label, dev)
        stats.update(_cache_off_engine(core, label, lora, dev, core_kwargs,
                                       block, long_prompts[0], prompt, stats))
        # C1, on this configuration's weights, with the engine idle
        prompts = [prompt] + [engine.encode_chat(
            [{"role": "user", "content": f"Prompt {i}: " + "y" * (70 + 3 * i)}])
            for i in range(1, max(GROUPS))]
        lora_rows = None
        if lora:
            lora_rows = [core.lora.slot_of(n) for n in
                         ("beta", "acme", None, "beta", "acme", None, "beta",
                          "acme")]
        phase_batch_invariance(core, prompts, label, lora_rows)
        # the offload tier, page exhaustion and the drain (one-way, so
        # last) on small engines of their own, after the counts
        if ship:
            over["kv_ship"]["offload"] = _timed(
                block_s, "offload", _offload_block, core, label, dev,
                core_kwargs)
        if label == "bf16":
            # structured outputs on an engine of their own over these params
            over["structured"] = _timed(block_s, "structured",
                                        _structured_block, core, dev)
            # each verify key's replay against its eager step, and the
            # prefill chunk budget, on engines of their own
            over["spec_graphs"] = _timed(block_s, "spec_graphs", _spec_graphs,
                                         core, dev)
            over["budget"] = _timed(
                block_s, "budget", _budget_block, core,
                [_fresh_head(long_prompts[0][:BUDGET_DECODER_TOKENS], i + 1)
                 for i in range(SLOTS)], long_prompts[0], dev)
            # disaggregation: a split core and two role engines over these
            # params, their launches counted from 0 as the block's path
            over["disagg"] = _timed(block_s, "disagg", _disagg_block, core,
                                    engine, prompt, long_prompts[0], stats,
                                    dev)
        if structured_ids is not None:
            over["structured"] = _timed(block_s, "structured",
                                        _structured_dense, core, dev,
                                        structured_ids)
        small = _small_engine_blocks(core, prompt, label, dev, core_kwargs)
        over.update(small)
        drain = small["drain"]
        block_s.update(small["block_s"])
        over["block_s"] = block_s
        log(f"serve {label} [{dev['smi']}]: drain: POST /api/drain (grace 0) "
            f"with an armed stream at {drain['committed']} ids: its row "
            f"parked ({drain['parked']}), its socket {drain['stream_end']} "
            f"without [DONE] {drain['drain_cut_s'] * 1e3:.1f} ms after the "
            f"POST; a new chat 503 with Retry-After {drain['retry_after']}; "
            "/api/health says draining")
        log(f"serve {label}: this slice's blocks took {block_s} s "
            f"({sum(block_s.values()):.1f} s)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.shutdown()
        del engine, core
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def phase_serve_lora(dev: dict, bf16_ids: list[int]) -> dict:
    """The LoRA path: a temporary adapter directory with the two ADAPTERS,
    written by the port's save_adapter, served by the paged bf16 engine."""
    import tempfile

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.lora import save_adapter

    cfg = get_preset("llama-3-8b")
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as lora_dir:
        t0 = time.perf_counter()
        for name, rank, targets in ADAPTERS:
            save_adapter(lora_dir, name, cfg, rank=rank, targets=targets,
                         scale=ADAPTER_SCALE)
        log(f"serve lora: adapters {[a[0] for a in ADAPTERS]} written in "
            f"{time.perf_counter() - t0:.1f} s")
        return phase_serve(dev, "lora", LORA_PATH, bf16_ids=bf16_ids,
                           lora_dir=lora_dir)


# The Mixtral phase: Mixtral-8x7B at full width and depth, int8 weights.
MIXTRAL_PATH = BF16_PATH + ("lora_delta",)
# its adapters, attention-only (an MoE engine pools no expert targets)
MIXTRAL_ADAPTERS = (("acme", 8), ("beta", 16))
MIX_TOKENS = 32  # greedy ids of its timed and HTTP requests
MIX_BF16_LAYERS = 8  # depth of the bf16 check at full width
# tokens of the prefix pair's prompt past its two full chunks: a chunk of at
# most the smallest bucket (32), which runs in the exact regime (B * T <= 4 E)
PAIR_TAIL = 20


class _Drops:
    """While open, counts the (token, choice) pairs the capacity dispatch
    drops, per layer call, by calling the plain routing (ops/moe.py
    capacity_drops, a host read) on the router logits each call of
    models/mixtral.py's moe_dispatch_combine gets; with `check`, each call
    is also held bit for bit against the one-hot plain version on the same
    inputs (the card's index copies and gathers give its bits)."""

    def __init__(self, check: bool = False):
        from llmlb_tpu_torch.models import mixtral
        from llmlb_tpu_torch.ops.moe import capacity_drops

        self.calls: list[int] = []
        self.tokens: list[int] = []  # each call's B * T (padding in)
        self.checked = 0
        orig = self.orig = mixtral.moe_dispatch_combine

        def spy(x, logits, *w, num_selected, capacity, token_valid=None,
                **kw):
            import torch

            self.calls.append(capacity_drops(logits, num_selected, capacity,
                                             token_valid))
            self.tokens.append(logits.shape[0])
            out = orig(x, logits, *w, num_selected=num_selected,
                       capacity=capacity, token_valid=token_valid, **kw)
            if check:
                plain = orig(x, logits, *w, num_selected=num_selected,
                             capacity=capacity, token_valid=token_valid,
                             indexed=False, **kw)
                if not torch.equal(out, plain):
                    raise AssertionError(
                        "moe_dispatch_combine: the card's index form differs "
                        "from the one-hot plain version (max |diff| "
                        f"{(out.float() - plain.float()).abs().max().item():.3e})")
                self.checked += 1
            return out

        mixtral.moe_dispatch_combine = spy

    def take(self) -> list[int]:
        """The drops of each layer call since the last take."""
        out, self.calls, self.tokens = self.calls, [], []
        return out

    def close(self) -> None:
        from llmlb_tpu_torch.models import mixtral

        mixtral.moe_dispatch_combine = self.orig


def _mix_request(core, prompt: list[int], n: int, lora: str | None = None):
    """One greedy request on the core: (ids, TTFT s, steady decode tok/s
    over the ids after the first fetch, as _st_rate rates them)."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    req = Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=n, temperature=0.0, lora=lora))
    req.events = _StampedEvents()
    core.submit(req)
    ids, _, ttft, stamps = _st_collect(req)
    return ids, ttft, _st_rate(stamps, n)


def _mix_together(core, rows, n: int) -> list[list[int]]:
    """Requests (prompt, adapter, sampling) submitted between two loop
    iterations, so they prefill as one group on any core (an MoE prefill
    group's rows share the capacity dispatch); their ids."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    reqs = [Request(prompt_ids=list(p), sampling=SamplingParams(
        max_tokens=n, lora=name, **{"temperature": 0.0, **sp}))
        for p, name, sp in rows]
    core.call_in_loop(lambda: [core.submit(r) for r in reqs])
    return [_collect(r)[0] for r in reqs]


def _moe_decode_invariance(core, prompts: list[list[int]],
                           lora_rows: list[int]) -> None:
    """Decode is exact MoE, so a row's decode logits do not depend on the
    rows beside it. Over scratch pages, SLOTS rows each prefilled alone (as
    the engine prefills a lone request), then one decode step of every row,
    the same step with rows 1.. idle (token 0 at length 0, no adapter), and
    with their tokens and adapters rotated: row 0's logits equal bit for
    bit. Its launches are not the main path's."""
    import torch

    from llmlb_tpu_torch.models import family_for

    fam, cfg = family_for(core.cfg), core.cfg
    i32 = dict(dtype=torch.int32, device="cuda")
    with _Uncounted():
        ck, cv = fam.init_kv_pages(cfg, 1 + 2 * SLOTS, PAGE, "cuda")
        tables = (torch.arange(2 * SLOTS, **i32) + 1).reshape(SLOTS, 2)
        lidx = torch.tensor(lora_rows, **i32)
        lens = torch.tensor([len(p) for p in prompts], **i32)
        toks = []
        for r, p in enumerate(prompts):
            ids = torch.zeros((1, 128), dtype=torch.int64, device="cuda")
            ids[0, :len(p)] = torch.tensor(p, device="cuda")
            logits = fam.prefill_into_pages(core.params, cfg, ids,
                                            lens[r:r + 1], tables[r:r + 1],
                                            ck, cv, lora_idx=lidx[r:r + 1])[0]
            toks.append(int(logits[0].argmax()))
        toks = torch.tensor(toks, **i32)

        def step(t, n, li):
            return fam.decode_step_paged(core.params, cfg, t, n, ck, cv,
                                         tables, window=256,
                                         lora_idx=li)[0][0].clone()

        full = step(toks, lens, lidx)
        idle = [x.clone() for x in (toks, lens, lidx)]
        for x in idle:
            x[1:] = 0
        alone = step(*idle)
        rot = [x.clone() for x in (toks, lidx)]
        for x, src in zip(rot, (toks, lidx)):
            x[1:] = src[1:].roll(1)
        rotated = step(rot[0], lens, rot[1])
        torch.cuda.synchronize()
    for what, other in (("with the others idle", alone),
                        ("with the others' tokens and adapters rotated",
                         rotated)):
        if not torch.equal(other, full):
            raise AssertionError(
                f"batch_invariance mixtral: row 0's decode logits in the "
                f"batch of {SLOTS} and {what} differ (max |diff| "
                f"{(other - full).abs().max().item():.3e})")
    log(f"batch_invariance mixtral: row 0's decode logits (exact MoE) "
        f"bit-identical in the batch of {SLOTS}, with the others idle and "
        f"with their tokens and adapters rotated (adapter rows {lora_rows})")


def _mix_graph_vs_eager(core, prompt: list[int], dev: dict,
                        core_kwargs: dict) -> dict:
    """On the same weights, an engine with decode_graphs=False: the
    GRAPH_ROWS workload (greedy and seeded rows with the adapters), submitted
    together on each core so that both prefill the same group, gives the
    same ids on the serving core, whose bursts replay one window key's
    graph, as on the eager one."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    eager = EngineCore(core.cfg, core.params, device="cuda", seed=0,
                       num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                       decode_graphs=False, prefix_cache=False, **core_kwargs)
    eager.start()
    try:
        rows = [(_fresh_head(prompt, 16 + i), name, sp)
                for i, (sp, name) in enumerate(GRAPH_ROWS)]
        replays = core.stats().decode_graph_replays
        keys0 = set(core.decode_graph_info()["keys"])
        graph_ids = _mix_together(core, rows, MIX_TOKENS)
        replayed = core.stats().decode_graph_replays - replays
        eager_ids = _mix_together(eager, rows, MIX_TOKENS)
        keys = sorted(core.decode_graph_info()["keys"])
        same = [_shared(a, b) for a, b in zip(graph_ids, eager_ids)]
        log(f"serve mixtral: graph = eager: rows (greedy, greedy acme, "
            f"seeded beta, seeded acme) share {same} of {MIX_TOKENS} ids; "
            f"the graph core replayed {replayed} bursts for them (keys "
            f"{keys}, new {sorted(set(keys) - keys0)}), the eager core "
            f"{eager.stats().decode_graph_replays}")
        if graph_ids != eager_ids:
            raise AssertionError(f"serve mixtral: graph and eager bursts give "
                                 f"different ids (shared {same})")
        if replayed < 1 or eager.stats().decode_graph_replays:
            raise AssertionError("serve mixtral: the comparison did not set "
                                 "replays against eager bursts")
        return {"graph_eager_shared": same}
    finally:
        eager.stop()
        del eager
        gc.collect()
        torch.cuda.empty_cache()


MIX_SPLIT_TOKENS = 16  # greedy ids of the split core's request


def _mix_split(core, prompt: list[int], ids: list[int], dev: dict,
               core_kwargs: dict) -> dict:
    """A14's MoE handoff: one greedy request of MIX_SPLIT_TOKENS ids through
    a `role="split"` core over the phase's params (int8 weights, the two
    adapters' pools), after the phase's counts. Its ids must be the phase
    core's for the same prompt served alone (`ids`): both prefill it in a
    group of one. Its launches are its own (_Uncounted), and must cover
    the path's kernels but the extend (a one-shot prompt)."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore

    split = EngineCore(core.cfg, core.params, device=core.device, seed=0,
                       num_slots=SLOTS, slot_capacity=CAPACITY, eos_id=-1,
                       role="split", **core_kwargs)
    split.start()
    try:
        with _Uncounted() as unc:
            got, ttft, _ = _mix_request(split, prompt, MIX_SPLIT_TOKENS)
        ledger = dict(split.prefill_dispatch_by_loop)
        handoffs = split.metrics.handoff_total["in_process"]
    finally:
        split.stop()
        del split
        gc.collect()
        torch.cuda.empty_cache()
    if got != ids[:MIX_SPLIT_TOKENS]:
        raise AssertionError(f"serve mixtral: the split core's ids share "
                             f"{_shared(got, ids)} of {MIX_SPLIT_TOKENS} with "
                             "the phase core's")
    missing = [k for k in MIXTRAL_PATH
               if k != "paged_flash_extend" and unc.launches.get(k, 0) <= 0]
    if ledger["decode"] or handoffs != 1 or missing:
        raise AssertionError(f"serve mixtral: split prefill dispatches by "
                             f"loop {ledger}, {handoffs} handoffs, kernels "
                             f"never launched {missing}")
    log(f"serve mixtral [{dev['smi']}]: a split core's {MIX_SPLIT_TOKENS} "
        f"greedy ids of the {len(prompt)}-token prompt are the phase core's "
        f"(one in-process handoff, prefill dispatches by loop {ledger}, TTFT "
        f"{ttft * 1e3:.1f} ms); its launches {unc.launches}")
    return {"ttft_s": ttft, "prefill_by_loop": ledger,
            "launches": unc.launches}


def phase_serve_mixtral(dev: dict) -> dict:
    """Serve Mixtral-8x7B at full width and depth (32 layers, 8 experts,
    top-2) with int8 weights, random from seed 0 and filled as int8 a matrix
    at a time, over HTTP with two attention adapters; see the module
    docstring. Returns the metrics and the launches of this run."""
    import gc
    import tempfile
    import urllib.error

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.lora import save_adapter
    from llmlb_tpu_torch.models import mixtral
    from llmlb_tpu_torch.ops import cuda_attention as ca

    cfg = get_preset("mixtral-8x7b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    block_s: dict[str, float] = {}
    stats: dict = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as lora_dir:
        for name, rank in MIXTRAL_ADAPTERS:
            save_adapter(lora_dir, name, cfg, rank=rank, scale=ADAPTER_SCALE)
        core_kwargs = dict(quantize="weights", lora_dir=lora_dir)
        t0 = time.perf_counter()
        engine = Engine.from_preset("mixtral-8x7b", device="cuda", seed=0,
                                    num_slots=SLOTS, slot_capacity=CAPACITY,
                                    eos_id=-1, **core_kwargs)
        core = engine.core
        torch.cuda.synchronize()
        kv = core.kv_cache_info()
        quant = core.quant_info()
        stats.update(
            weights_gib=core.param_bytes / 2**30,
            weights_bf16_gib=quant["param_bytes_bf16"] / 2**30,
            kv_gib=kv["hbm_bytes"] / 2**30, init_s=core.init_seconds,
            engine_s=time.perf_counter() - t0,
            peak_gib_init=torch.cuda.max_memory_allocated() / 2**30)
        log(f"serve mixtral [{dev['smi']}]: mixtral-8x7b random weights (seed "
            f"0), int8 experts and projections filled a matrix at a time in "
            f"{stats['init_s']:.1f} s (engine {stats['engine_s']:.1f} s); "
            f"weights {stats['weights_gib']:.2f} GiB (bf16 would be "
            f"{stats['weights_bf16_gib']:.2f} GiB), KV "
            f"{stats['kv_gib']:.2f} GiB {kv['layout']} {kv['kv_dtype']}, peak "
            f"{stats['peak_gib_init']:.2f} GiB allocated; decode burst "
            f"{core.decode_burst}")
        if core.family is not mixtral or not quant["weights_int8"] or (
                kv["kv_dtype"] != "bfloat16" or kv["layout"] != "paged"):
            raise AssertionError(f"serve mixtral: family {core.family}, "
                                 f"quant {quant}, KV {kv}")
        if core.lora.targets != ("wq", "wk", "wv", "wo"):
            raise AssertionError(f"adapter pools over {core.lora.targets}")
        server, thread = start_server(engine)
        base = "http://%s:%d" % server.server_address[:2]
        try:
            ca.reset_launch_counts()
            t_main = time.perf_counter()
            model = "mixtral-8x7b"
            first = _chat(base, "Tell me about mixture-of-experts routing.",
                          MIX_TOKENS, True, model=model)
            chats = _concurrent([
                lambda: _chat(base, "Request 1: a haiku about experts.",
                              MIX_TOKENS, False, model=model),
                lambda: _chat(base, "Request 2: a haiku about routers.",
                              MIX_TOKENS, True, model=model, lora="acme"),
                lambda: _chat(base, "Request 3: a haiku about capacity.",
                              MIX_TOKENS, False, model=f"{model}:beta")])
            for r in [first, *chats]:
                assert r["usage"]["completion_tokens"] == MIX_TOKENS, r
                assert r["finish"] == "length", r["finish"]
            with urllib.request.urlopen(base + "/v1/models",
                                        timeout=60) as resp:
                entries = json.loads(resp.read())["data"]
            caps = entries[0]["capabilities"]
            if "embeddings" in caps or "lora" not in caps:
                raise AssertionError(f"/v1/models capabilities {caps}")
            try:
                _post(base + "/v1/embeddings", {"input": "hello"}).close()
                raise AssertionError("/v1/embeddings answered 200 on MoE")
            except urllib.error.HTTPError as e:
                refusal = (e.code, json.loads(e.read())["error"]["message"])
            if refusal[0] != 400 or "not supported" not in refusal[1]:
                raise AssertionError(f"/v1/embeddings: {refusal}")
            log(f"serve mixtral: 4 chats over HTTP (base, lora field, "
                f"model:adapter) ok; /v1/models capabilities {caps}; "
                f"/v1/embeddings {refusal[0]} {refusal[1]!r}")
            block_s["http"] = time.perf_counter() - t_main

            # the timed prompt (124 tokens), twice: the ids must agree
            t1 = time.perf_counter()
            prompt = engine.encode_chat([{"role": "user",
                                          "content": "x" * 100}])
            runs = [_mix_request(core, prompt, MIX_TOKENS) for _ in range(2)]
            ids = runs[0][0]
            if runs[1][0] != ids:
                raise AssertionError("serve mixtral: greedy ids differ between "
                                     "identical runs (shared "
                                     f"{_shared(ids, runs[1][0])})")
            acme = _mix_request(core, prompt, MIX_TOKENS, lora="acme")
            if acme[0] == ids:
                raise AssertionError("serve mixtral: adapter acme changed no "
                                     "greedy id")
            stats.update(ttft_s=min(r[1] for r in runs),
                         decode_tok_s_1=max(r[2] for r in runs),
                         acme_shared=_shared(acme[0], ids))
            block_s["timed"] = time.perf_counter() - t1

            # a prefix hit against its cold run, their drops counted (this
            # warms the 2048 window key), then the long prompt with a head of
            # its own, a miss, timed. The pair's prompt is the long one cut
            # to two full chunks and PAIR_TAIL tokens: the cold run's last
            # chunk and the hit's suffix then run in the exact regime, so
            # the tokens the hit recomputes were dropped in neither run and
            # the hit is held to the cold run's logits (the full chunks
            # before them drop pairs, and the hit reads their KV pages).
            t1 = time.perf_counter()
            long_text = " ".join(f"w{i % 97}" for i in range(380))
            long_prompts = [engine.encode_chat([{"role": "user", "content":
                                                 _first_word(long_text, j)}])
                            for j in (1, 2)]
            chunk = core.prefill_buckets[-1]
            pair = long_prompts[1][:2 * chunk + PAIR_TAIL]
            hits0 = core.stats().prefix.prefix_hits_total
            spy, drops = _LogitSpy(core), _Drops()
            try:
                cold_ids, cold_ttft, _ = _timed_core_request(
                    core, pair, LONG_TOKENS)
                cold_drops = drops.take()
                hit_ids, hit_ttft, _ = _timed_core_request(
                    core, pair, LONG_TOKENS)
                hit_drops = drops.take()
            finally:
                drops.close()
                spy.close()
            if core.stats().prefix.prefix_hits_total != hits0 + 1:
                raise AssertionError("serve mixtral: the pair's repeat did "
                                     "not hit")
            cold_logits, hit_logits = spy.get(pair, None)[-2:]
            layers = cfg.num_layers
            per_dispatch = [sum(cold_drops[i:i + layers])
                            for i in range(0, len(cold_drops), layers)]
            # one capacity call per layer for each full chunk and none for
            # the tail or the hit: the regimes the comparison relies on
            if len(cold_drops) != 2 * layers or hit_drops:
                raise AssertionError(
                    f"serve mixtral: {len(cold_drops)} capacity calls in the "
                    f"cold run (want {2 * layers}), {len(hit_drops)} in the "
                    "hit (want 0)")
            err = _hit_within("mixtral", "the pair's hit", hit_logits,
                              cold_logits)
            stats["prefix"] = dict(
                cold_drops=per_dispatch, max_abs_diff=err,
                bitwise=bool(torch.equal(hit_logits, cold_logits)),
                shared=_shared(hit_ids, cold_ids))
            log(f"serve mixtral: prefix hit against its cold run "
                f"({len(pair)} tokens: chunks of {chunk}, {chunk} and "
                f"{PAIR_TAIL}; the hit's suffix one extend): dropped (token, "
                f"choice) pairs over {layers} layers: the full chunks "
                f"{per_dispatch}, the tail and the hit's suffix none (exact "
                f"regime); first-token logits max |diff| {err:.3e} (within "
                f"the bf16 limit, held; bit for bit: "
                f"{stats['prefix']['bitwise']}); ids share "
                f"{stats['prefix']['shared']} of {LONG_TOKENS}; TTFT cold "
                f"{cold_ttft * 1e3:.1f} ms, hit {hit_ttft * 1e3:.1f} ms "
                "(both with the drop count's host reads)")
            miss = _timed_miss(core, long_prompts[0], None)
            stats.update(ttft_long_s=miss[1], long_split=miss[2])
            block_s["long"] = time.perf_counter() - t1

            # 8 x 64, heads of their own
            t1 = time.perf_counter()
            agg, d8, _ = _fresh_batch(core, prompt)
            stats.update(tok_s_8=agg, tok_s_8_dispatches=d8)
            block_s["batch8"] = time.perf_counter() - t1
            log(f"serve mixtral [{dev['smi']}]: TTFT {stats['ttft_s'] * 1e3:.1f}"
                f" ms ({len(prompt)}-token prompt), "
                f"{stats['ttft_long_s'] * 1e3:.1f} ms "
                f"({len(long_prompts[0])}-token prompt, a miss: "
                f"{_split_text(miss[2])}); one-stream decode "
                f"{stats['decode_tok_s_1']:.2f} tok/s (ids after the first "
                f"fetch); 8 concurrent x 64: {agg:.1f} tok/s incl. prefill "
                f"({d8} prefill dispatches); acme shares "
                f"{stats['acme_shared']} of {MIX_TOKENS} ids with the base")

            # one speculative request (the accept stub) against spec off
            t1 = time.perf_counter()
            spec = _spec_short(core, engine, "mixtral", dev, True)
            stats["spec"] = {k: spec[k] for k in ("counts", "partings",
                                                  "logit_diff", "rate_on",
                                                  "rate_off")}
            block_s["spec"] = time.perf_counter() - t1

            # C1 on decode (exact MoE), on this core's weights
            t1 = time.perf_counter()
            rows = [core.lora.slot_of(n) for n in
                    ("acme", "beta", None, "acme", "beta", None, "acme",
                     "beta")]
            _moe_decode_invariance(
                core, [prompt] + [_fresh_head(prompt, 40 + i)
                                  for i in range(SLOTS - 1)], rows)
            block_s["invariance"] = time.perf_counter() - t1

            nan_rows = core.nan_logit_rows()
            launches = dict(ca.LAUNCHES)
            stats["launches"] = launches
            log(f"serve mixtral: launches over the main path {launches}; NaN "
                f"logit rows {nan_rows}")
            if nan_rows:
                raise AssertionError(f"{nan_rows} logit rows had NaN")
            missing = [k for k in MIXTRAL_PATH if launches[k] <= 0]
            if missing:
                raise AssertionError("kernels never launched on the mixtral "
                                     f"path: {missing}")
            stray = [k for k, n in launches.items()
                     if k not in MIXTRAL_PATH and n]
            if stray:
                raise AssertionError(f"kernels of another path launched: "
                                     f"{stray}")
            graphs = _graph_counters(core, "mixtral", dev)
            stats["graph_pool_mib"] = {k: v["pool_bytes"] / 2**20
                                       for k, v in graphs["keys"].items()}
            t1 = time.perf_counter()
            stats.update(_mix_graph_vs_eager(core, prompt, dev, core_kwargs))
            block_s["graph_eager"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            stats["split"] = _mix_split(core, prompt, ids, dev, core_kwargs)
            block_s["split"] = time.perf_counter() - t1
            stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            stats["block_s"] = {k: round(v, 1) for k, v in block_s.items()}
            log(f"serve mixtral: peak {stats['peak_gib']:.2f} GiB allocated; "
                f"blocks took {stats['block_s']} s")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            engine.shutdown()
            del engine, core
            gc.collect()
            torch.cuda.empty_cache()
    return stats


class _PlainCheck:
    """While open, every call of the attention kernels a bf16 MoE model with
    int8 KV pools runs (flash_prefill, paged_flash_extend_quant,
    paged_flash_decode_quant) is also run through its plain version on the
    same inputs and held within the bf16 limit; the largest error of each
    is kept."""

    NAMES = ("flash_prefill", "paged_flash_extend_quant",
             "paged_flash_decode_quant")

    def __init__(self):
        from llmlb_tpu_torch.ops import cuda_attention as ca

        self.errs: dict[str, float] = {}
        self.saved = {n: getattr(ca, n) for n in self.NAMES}
        for name in self.NAMES:
            kernel = self.saved[name]
            plain = getattr(ca, name + "_reference")

            def spy(*args, kernel=kernel, plain=plain, name=name, **kw):
                got = kernel(*args, **kw)
                want = plain(*args, **kw)
                # queries past a row's prompt or chunk are undefined
                rows = (None if name == "paged_flash_decode_quant"
                        else args[-1].tolist())
                err, ok = _within(got, want, 0.0, BF16_REL, rows)
                if not ok:
                    raise AssertionError(
                        f"mixtral bf16: {name} disagrees with its plain "
                        f"version (max_abs_err {err:.3e})")
                self.errs[name] = max(self.errs.get(name, 0.0), err)
                return got

            setattr(ca, name, spy)

    def close(self) -> None:
        from llmlb_tpu_torch.ops import cuda_attention as ca

        for name, fn in self.saved.items():
            setattr(ca, name, fn)


def phase_mixtral_bf16(dev: dict) -> dict:
    """Mixtral-8x7B at full width and MIX_BF16_LAYERS layers in bf16, with
    int8 KV pools (quantize="kv"): a prefill group of 4 rows x 512 in the
    capacity regime, an extend of 4 rows x 128 (capacity) and a decode
    step (exact). Every capacity dispatch is held bit for bit against the
    one-hot plain version on the same inputs, with its drops counted; every
    attention call (flash_prefill, paged_flash_extend_quant,
    paged_flash_decode_quant) within the bf16 limit of its plain version on
    the same inputs."""
    import dataclasses
    import gc

    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.models import mixtral

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_preset("mixtral-8x7b"),
                              num_layers=MIX_BF16_LAYERS)
    t0 = time.perf_counter()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    gib = sum(p.numel() * p.element_size() for p in params.values()) / 2**30
    init_s = time.perf_counter() - t0
    rows, bucket, chunk, ppn = 4, 512, 128, 6
    i32 = dict(dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (rows, bucket), generator=gen,
                        device="cuda")
    lens = torch.tensor([512, 300, 457, 129], **i32)
    tables = (torch.arange(rows * ppn, **i32) + 1).reshape(rows, ppn)
    ck, cv = mixtral.init_kv_pages(cfg, rows * ppn + 1, PAGE, "cuda",
                                   quantized=True)
    ext = torch.randint(0, cfg.vocab_size, (rows, chunk), generator=gen,
                        device="cuda")
    ext_lens = torch.tensor([128, 77, 5, 100], **i32)
    drops, plain = _Drops(check=True), _PlainCheck()
    try:
        logits = [mixtral.prefill_into_pages(params, cfg, ids, lens, tables,
                                             ck, cv)[0]]
        d_prefill = sum(drops.take())
        logits.append(mixtral.prefill_extend_pages(
            params, cfg, ext, ext_lens, lens, tables, ck, cv)[0])
        d_extend = sum(drops.take())
        seq = lens + ext_lens
        logits.append(mixtral.decode_step_paged(
            params, cfg, logits[-1].argmax(-1).to(torch.int32), seq, ck, cv,
            tables, window=_window(int(seq.max()) + 1))[0])
        torch.cuda.synchronize()
    finally:
        drops.close()
        plain.close()
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    if not finite or drops.checked != 2 * MIX_BF16_LAYERS:
        raise AssertionError(f"mixtral bf16: finite {finite}, capacity "
                             f"dispatches checked {drops.checked}")
    log(f"mixtral bf16 [{dev['smi']}]: {MIX_BF16_LAYERS} layers at full width "
        f"({gib:.2f} GiB bf16, init {init_s:.1f} s), int8 KV pools: prefill "
        f"{rows} x {bucket} (lens {lens.tolist()}) and extend {rows} x "
        f"{chunk} (lens {ext_lens.tolist()}) in the capacity regime, "
        f"{drops.checked} dispatches bit for bit the one-hot plain version's, "
        f"dropped (token, choice) pairs: prefill {d_prefill}, extend "
        f"{d_extend}; a decode step (exact); attention max_abs_err against "
        f"plain {plain.errs}")
    del params, ck, cv
    gc.collect()
    torch.cuda.empty_cache()
    return {"drops": [d_prefill, d_extend], "attention_err": plain.errs,
            "init_s": init_s, "gib": gib}


# ----------------------------------------------------------------- multimodal

# openai/whisper-large-v3's config.json: the fields
# WhisperConfig.from_hf_config reads (1.55 B parameters, fp32 as served)
WHISPER_LARGE_V3 = {"vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
                    "encoder_layers": 32, "decoder_layers": 32,
                    "encoder_attention_heads": 20,
                    "decoder_attention_heads": 20,
                    "max_source_positions": 1500, "max_target_positions": 448,
                    "decoder_start_token_id": 50258, "eos_token_id": 50257}
MM_AUDIO_S = 10.0  # the chirp's seconds (1000 mel frames, bucket 1024)
MM_ASR_TOKENS = 64
MM_CHECK_LAYERS = 2  # the card-versus-CPU whisper check's depth
MM_TTS_TEXT = ("The port speaks: a quick brown fox jumps over the lazy dog "
               "while the card renders every frame of its mel spectrogram, "
               "then Griffin-Lim turns the magnitudes back into a waveform "
               "of sixteen thousand samples a second.")[:200]
MM_PROMPT = "a red square on a blue field"
MM_STEPS, MM_SEED = 20, 1234
MM_IMAGE_SEEDS = (MM_SEED, 7, 42, 2024)  # the card-vs-CPU image readings
MM_MEL_SEEDS = (1, 2, 3)  # seeded tone mixes beside the chirp
# fp32 on both sides: sums in another order. Whisper's encoder states are
# layer-normed (~unit scale), its logits ~N(0, 1): 1e-4 and 1e-3 are ~100x
# the sum-order error of 1280- and 5120-term fp32 sums. The log-mel keeps
# bins down to 1e-8 of the peak power, where a float32 FFT's error (~1e-7
# of the peak amplitude) is ~1e-3 of the bin's amplitude: (log10 + 4) / 4
# moves by up to ~1e-3 / ln(10) / 2, so 1e-3. The TTS mel (|x| up to ~3)
# and the vocoder's audio (peak 0.95): 1e-4 (the port and the reference
# differed by 3.3e-6 and 1.3e-6 on the CPU at TtsConfig()). One UNet call
# on the same inputs: 1e-4 of its largest |eps|. A whole DDIM run
# amplifies: x0 = (x - sqrt(1 - a) eps) / sqrt(a) divides by sqrt(alpha_bar)
# ~ 0.0064 at its first steps, and on the CPU a 1e-6 relative change of
# every UNet output moved the final image by 1.1e-3.
# Readings on an H100 (PERF.md, section 6), fp32 / the TF32 control: the mel
# over four signals 8.0e-5..1.16e-4 / 1.36e-4 (TF32 products: this check
# cannot tell them apart); encoder states 3.7e-6 / 6.17e-4 (TF32
# convolutions); one UNet call 3.24e-6 / 9.16e-4; the image at four seeds
# 7.1e-3..2.55e-2 / 1.48. The image limit, 0.1, is 3.9x the largest fp32
# reading and 15x under TF32's.
MM_MEL_ATOL, MM_WHISPER_ENC_ATOL, MM_WHISPER_LOGIT_ATOL = 1e-3, 1e-4, 1e-3
MM_TTS_ATOL, MM_EPS_REL, MM_IMAGE_ATOL = 1e-4, 1e-4, 0.1
MM_NOISE_ATOL = 1e-6  # _threefry.normal's stated bound


def _chirp(seconds: float, rate: int = 16000):
    """A 200 Hz -> 4 kHz linear chirp at half scale (float32)."""
    import numpy as np

    t = np.arange(int(seconds * rate)) / rate
    f0, f1 = 200.0, 4000.0
    phase = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * seconds))
    return (0.5 * np.sin(phase)).astype(np.float32)


def _mel_signal(seed: int, seconds: float = MM_AUDIO_S, rate: int = 16000):
    """Three seeded tones (100 Hz - 6 kHz, amplitudes 0.01 - 0.3) over a
    noise floor 60 dB below them: a wide dynamic range, as speech has."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(a * np.sin(2 * np.pi * f * t + ph) for a, f, ph in zip(
        rng.uniform(0.01, 0.3, 3), rng.uniform(100, 6000, 3),
        rng.uniform(0, 2 * np.pi, 3)))
    return (x + 1e-3 * rng.standard_normal(t.size)).astype(np.float32)


def _max_diff(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def _tf32_defaults() -> None:
    """PyTorch's own TF32 switches, as a server process starts with them:
    cuDNN's on, cuBLAS's off. phase_device turned both off for the
    kernels' checks; the multimodal models must keep their convolutions in
    fp32 by themselves (models/_common.py fp32_convolutions)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


@contextlib.contextmanager
def _tf32_control(convs_of=None, matmul: bool = False):
    """The control a card-vs-CPU limit is read against: cuDNN's fp32
    convolutions in TF32 with the model module `convs_of`'s fp32 guard
    lifted, and (matmul) cuBLAS's fp32 products in TF32; the switches and
    the guard restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    guard = convs_of.fp32_convolutions if convs_of else None
    if convs_of:
        convs_of.fp32_convolutions = lambda x: None
        torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        if convs_of:
            convs_of.fp32_convolutions = guard
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _mm_whisper(dev: dict) -> tuple:
    """(a): Whisper-large-v3 at full width and depth, random from seed 0."""
    import dataclasses

    import torch

    from llmlb_tpu_torch.engine.asr import AsrEngine, decode_wav
    from llmlb_tpu_torch.engine.tts import encode_wav
    from llmlb_tpu_torch.models import whisper
    from llmlb_tpu_torch.models._common import param_bytes

    smi = dev["smi"]
    _tf32_defaults()
    cfg = whisper.WhisperConfig.from_hf_config(WHISPER_LARGE_V3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    asr = AsrEngine.from_random(cfg, model_id="whisper-large-v3", seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gib = param_bytes(asr.params) / 2**30
    wav = encode_wav(_chirp(MM_AUDIO_S))
    asr.transcribe_wav_bytes(wav, max_tokens=4)  # warm-up: cuBLAS, cuFFT
    t0 = time.perf_counter()
    text = asr.transcribe_wav_bytes(wav, max_tokens=MM_ASR_TOKENS)
    wall = time.perf_counter() - t0
    tm, ids = asr.last_timings, asr.last_tokens
    if text != " ".join(map(str, ids)) or not ids:
        raise AssertionError(f"multimodal asr: text {text!r}, ids {ids}")
    steps_ms = [s * 1e3 for s in tm["step_s"]]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"multimodal asr [{smi}]: whisper-large-v3 ({whisper.num_params(cfg)} "
        f"params, {gib:.2f} GiB fp32, init {init_s:.1f} s): a "
        f"{MM_AUDIO_S:.0f} s chirp -> {len(ids)} ids in {wall * 1e3:.1f} ms "
        f"(real-time factor {wall / MM_AUDIO_S:.4f}); mel "
        f"{tm['mel_s'] * 1e3:.2f} ms, encoder {tm['encoder_s'] * 1e3:.2f} ms, "
        f"decoder step ms min {min(steps_ms):.2f} / median "
        f"{statistics.median(steps_ms):.2f} / max {max(steps_ms):.2f} "
        f"(the whole decoder re-run a token, lengths padded to 8..128); "
        f"peak {peak:.2f} GiB")
    # the greedy ids are the argmax of one teacher-forced pass over them
    audio, rate = decode_wav(wav)
    mel = asr._mel_for(audio)
    enc = whisper.encode_audio(asr.params, cfg, mel[None])
    prompt = whisper.prompt_tokens(cfg)
    seq = torch.tensor([prompt + ids], device="cuda")
    logits = whisper.decoder_logits(asr.params, cfg, seq, enc)[0]
    tail = logits[len(prompt) - 1:]
    forced = tail.argmax(-1).tolist()
    want = ids + ([cfg.eot_token] if len(ids) < MM_ASR_TOKENS else [])
    top2 = tail.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    if forced[:len(want)] != want:
        raise AssertionError(f"multimodal asr: greedy ids {want} are not the "
                             f"teacher-forced argmax {forced}")
    log(f"multimodal asr: the {len(ids)} greedy ids are the teacher-forced "
        f"pass's argmax; smallest top-2 margin {margin:.5f}")
    # the log-mel over the chirp and seeded tone mixes, and the chirp's
    # with the filterbank product in TF32 (the control)
    mel_errs = []
    for a in [audio] + [_mel_signal(s) for s in MM_MEL_SEEDS]:
        a = torch.from_numpy(a)
        mel_errs.append(_max_diff(
            whisper.log_mel_spectrogram(a.cuda(), cfg.n_mels),
            whisper.log_mel_spectrogram(a, cfg.n_mels)))
    with _tf32_control(matmul=True):
        mel_tf32 = _max_diff(
            whisper.log_mel_spectrogram(torch.from_numpy(audio).cuda(),
                                        cfg.n_mels),
            whisper.log_mel_spectrogram(torch.from_numpy(audio), cfg.n_mels))
    mel_err = max(mel_errs)
    del enc, logits
    torch.cuda.empty_cache()

    # full width, MM_CHECK_LAYERS layers: the card against the CPU
    small = dataclasses.replace(cfg, encoder_layers=MM_CHECK_LAYERS,
                                decoder_layers=MM_CHECK_LAYERS)
    p_cpu = whisper.init_params(small, torch.Generator().manual_seed(1), "cpu")
    p_gpu = whisper.params_from_numpy(p_cpu, small, "cuda")
    m = mel.cpu()[None]
    enc_c = whisper.encode_audio(p_cpu, small, m)
    enc_g = whisper.encode_audio(p_gpu, small, m.cuda())
    toks = torch.zeros((1, 8), dtype=torch.int64)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    first_c = whisper.decoder_logits(p_cpu, small, toks, enc_c)[0, len(prompt) - 1]
    first_g = whisper.decoder_logits(p_gpu, small, toks.cuda(),
                                     enc_g)[0, len(prompt) - 1]
    enc_err, logit_err = _max_diff(enc_g, enc_c), _max_diff(first_g, first_c)
    with _tf32_control(convs_of=whisper):
        enc_tf32 = _max_diff(whisper.encode_audio(p_gpu, small, m.cuda()),
                             enc_c)
    ok = (mel_err <= MM_MEL_ATOL and enc_err <= MM_WHISPER_ENC_ATOL
          and logit_err <= MM_WHISPER_LOGIT_ATOL
          and int(first_g.argmax()) == int(first_c.argmax()))
    log(f"multimodal asr: card vs CPU at full width, {MM_CHECK_LAYERS} "
        f"layers: mel max_abs_err {mel_err:.3g} (limit {MM_MEL_ATOL}; "
        f"{len(mel_errs)} signals "
        f"{', '.join(f'{e:.3g}' for e in mel_errs)}; TF32 products "
        f"{mel_tf32:.3g}), encoder states "
        f"{enc_err:.3g} (limit {MM_WHISPER_ENC_ATOL}; TF32 convolutions "
        f"{enc_tf32:.3g}), first-step logits "
        f"{logit_err:.3g} (limit {MM_WHISPER_LOGIT_ATOL}), argmax "
        f"{int(first_g.argmax())} / {int(first_c.argmax())}")
    if not ok:
        raise AssertionError("multimodal asr: the card's whisper is not the "
                             "CPU's within the stated limits")
    del p_gpu, enc_g
    torch.cuda.empty_cache()
    return {"asr_wall_s": wall, "rtf": wall / MM_AUDIO_S,
            "mel_ms": tm["mel_s"] * 1e3, "encoder_ms": tm["encoder_s"] * 1e3,
            "decoder_step_ms_median": statistics.median(steps_ms),
            "asr_tokens": len(ids), "whisper_gib": gib,
            "whisper_peak_gib": peak, "asr_margin": margin,
            "whisper_err": [mel_err, enc_err, logit_err],
            "mel_errs": mel_errs, "mel_tf32": mel_tf32,
            "encoder_tf32": enc_tf32}, asr


def _mm_tts(dev: dict) -> dict:
    """(b): TTS at TtsConfig(), random from seed 0."""
    import numpy as np
    import torch

    from llmlb_tpu_torch.engine.asr import decode_wav
    from llmlb_tpu_torch.engine.tts import TtsEngine
    from llmlb_tpu_torch.models import tts

    cfg = tts.TtsConfig()
    eng = TtsEngine.from_random(cfg, model_id="tts", seed=0, device="cuda")
    eng.synthesize("warm up")
    wav1 = eng.synthesize(MM_TTS_TEXT)
    tm = dict(eng.last_timings)
    t0 = time.perf_counter()
    wav2 = eng.synthesize(MM_TTS_TEXT)
    wall = time.perf_counter() - t0
    if wav1 != wav2:
        raise AssertionError("multimodal tts: two card runs of one text gave "
                             "different WAV bytes")
    audio, rate = decode_wav(wav1)
    rate_x = tm["audio_s"] / (tm["mel_s"] + tm["vocoder_s"])
    log(f"multimodal tts [{dev['smi']}]: TtsConfig() ({len(MM_TTS_TEXT)} "
        f"chars, bucket 256, 2048 frames): mel {tm['mel_s'] * 1e3:.2f} ms, "
        f"Griffin-Lim (24 rounds) {tm['vocoder_s'] * 1e3:.2f} ms, "
        f"{tm['audio_s']:.2f} s of audio: {rate_x:.1f} s of audio a second "
        f"(request wall {wall * 1e3:.1f} ms); two runs' WAV bytes equal")
    data = MM_TTS_TEXT.encode()
    ids = np.zeros((1, 256), np.int32)
    ids[0, :len(data)] = np.frombuffer(data, np.uint8)
    args = (torch.from_numpy(ids), torch.tensor([len(data)]),
            torch.tensor([tts.voice_id("alloy")]))
    p_cpu = tts.params_from_numpy(eng.params, cfg, "cpu")
    mel_g = tts.synthesize_mel(eng.params, cfg, *(a.cuda() for a in args))[0]
    mel_c = tts.synthesize_mel(p_cpu, cfg, *args)[0]
    audio_g = tts.griffin_lim(mel_g)
    audio_c = tts.griffin_lim(mel_g.cpu())
    mel_err, audio_err = _max_diff(mel_g, mel_c), _max_diff(audio_g, audio_c)
    log(f"multimodal tts: card vs CPU: mel max_abs_err {mel_err:.3g}, "
        f"Griffin-Lim audio of the same mel {audio_err:.3g} (limit "
        f"{MM_TTS_ATOL} each); WAV {len(audio)} samples at {rate} Hz")
    if mel_err > MM_TTS_ATOL or audio_err > MM_TTS_ATOL:
        raise AssertionError("multimodal tts: the card is not the CPU within "
                             "the stated limit")
    return {"engine": eng, "tts_mel_ms": tm["mel_s"] * 1e3,
            "tts_vocoder_ms": tm["vocoder_s"] * 1e3,
            "tts_audio_s_per_s": rate_x, "tts_err": [mel_err, audio_err]}


def _mm_image(dev: dict) -> dict:
    """(c): DDIM at DiffusionConfig(), 20 steps, random from seed 0."""
    import numpy as np
    import torch

    from llmlb_tpu_torch.engine.image import ImageEngine, to_uint8
    from llmlb_tpu_torch.models import diffusion

    _tf32_defaults()
    cfg = diffusion.DiffusionConfig()
    eng = ImageEngine.from_random(cfg, model_id="diffusion", seed=0,
                                  sample_steps=MM_STEPS, device="cuda")
    eng.sample(MM_PROMPT, 1, seed=0)  # warm-up: cuDNN's algorithm choice
    per_image, images = {}, {}
    for n in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images[n] = eng.sample(MM_PROMPT, n, seed=MM_SEED)
        torch.cuda.synchronize()
        per_image[n] = (time.perf_counter() - t0) / n
    noise_g = diffusion.initial_noise(cfg, MM_SEED, 4, "cuda")
    noise_c = diffusion.initial_noise(cfg, MM_SEED, 4, "cpu")
    noise_err = _max_diff(noise_g, noise_c)
    noise_eq = float((noise_g.cpu() == noise_c).float().mean())
    cpu = ImageEngine(cfg, diffusion.params_from_numpy(eng.params, cfg, "cpu"),
                      sample_steps=MM_STEPS, device="cpu")
    t0 = time.perf_counter()
    want = cpu.sample(MM_PROMPT, 1, seed=MM_SEED)
    cpu_s = time.perf_counter() - t0
    # one UNet call (the first step's, conditional and not) on the same
    # inputs on both sides: no sampler between them
    ids, lens = cpu.prompt_ids(MM_PROMPT)
    ids, lens = ids.expand(2, -1), torch.cat([lens, torch.zeros_like(lens)])
    t = torch.full((2,), diffusion._ddim_schedule(cfg, MM_STEPS)[0][0],
                   dtype=torch.int32)
    x = noise_c[:1].expand(2, -1, -1, -1)
    eps_c = diffusion.unet_eps(cpu.params, cfg, x, t, ids, lens)
    eps_g = diffusion.unet_eps(eng.params, cfg, x.cuda(), t.cuda(),
                               ids.cuda(), lens.cuda())
    eps_rel = _max_diff(eps_g, eps_c) / float(eps_c.abs().max())
    img_errs = [_max_diff(images[1], want)] + [
        _max_diff(eng.sample(MM_PROMPT, 1, seed=s),
                  cpu.sample(MM_PROMPT, 1, seed=s))
        for s in MM_IMAGE_SEEDS if s != MM_SEED]
    img_err = max(img_errs)
    with _tf32_control(convs_of=diffusion):  # the control
        eps_tf32 = _max_diff(diffusion.unet_eps(
            eng.params, cfg, x.cuda(), t.cuda(), ids.cuda(), lens.cuda()),
            eps_c) / float(eps_c.abs().max())
        img_tf32 = _max_diff(eng.sample(MM_PROMPT, 1, seed=MM_SEED), want)
    px = np.abs(to_uint8(images[1]).astype(int)
                - to_uint8(want).astype(int)).max()
    png = eng.generate(MM_PROMPT, 1, seed=MM_SEED)[0]
    log(f"multimodal image [{dev['smi']}]: DiffusionConfig() (64 px, base "
        f"64, mults (1, 2, 4)), {MM_STEPS} DDIM steps with guidance: "
        f"{per_image[1]:.3f} s an image at n = 1, {per_image[4]:.3f} s an "
        f"image at n = 4 (the CPU: {cpu_s:.2f} s at n = 1); starting noise "
        f"card vs CPU max_abs_err {noise_err:.3g} (limit {MM_NOISE_ATOL}), "
        f"{noise_eq:.4f} of draws bit for bit; one UNet call vs the CPU's "
        f"{eps_rel:.3g} of its largest |eps| (limit {MM_EPS_REL}; TF32 "
        f"convolutions {eps_tf32:.3g}); n = 1 images vs the CPU's "
        f"{img_err:.3g} (limit {MM_IMAGE_ATOL}; seeds {MM_IMAGE_SEEDS}: "
        f"{', '.join(f'{e:.3g}' for e in img_errs)}; TF32 convolutions "
        f"{img_tf32:.3g}), seed {MM_SEED}'s pixels within {px} levels; "
        f"PNG {len(png)} bytes")
    if noise_err > MM_NOISE_ATOL or eps_rel > MM_EPS_REL or \
            img_err > MM_IMAGE_ATOL or png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("multimodal image: the card is not the CPU "
                             "within the stated limits")
    return {"engine": eng, "image_s_n1": per_image[1],
            "image_s_n4": per_image[4], "image_err": img_err,
            "image_errs": img_errs, "image_tf32": img_tf32,
            "eps_rel": eps_rel, "eps_tf32": eps_tf32,
            "noise_err": noise_err, "noise_bit_equal": noise_eq}


def _mm_http(dev: dict, asr, tts_eng, image) -> dict:
    """(d): the port's server in-process with the three services beside
    the bf16 Llama-3-8B serving core; /v1/models, the three routes, and a
    404 from a server without them; then the port's gateway in front of
    it (_mm_gateway)."""
    import base64
    import io
    import wave

    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tts import encode_wav

    import torch

    engine = Engine.from_preset("llama-3-8b", device="cuda", eos_id=-1)
    _tf32_defaults()
    srv, thread = start_server(engine, asr=asr, tts=tts_eng, image=image)
    bare, bare_thread = start_server(engine)
    base = "http://%s:%d" % srv.server_address[:2]
    bare_base = "http://%s:%d" % bare.server_address[:2]
    times = {}
    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
            caps = {m["id"]: m["capabilities"]
                    for m in json.loads(r.read())["data"]}
        want = {asr.model_id: ["audio_transcription"],
                tts_eng.model_id: ["audio_speech"],
                image.model_id: ["image_generation"]}
        if any(caps.get(k) != v for k, v in want.items()) or \
                "llama-3-8b" not in caps:
            raise AssertionError(f"multimodal http: /v1/models {caps}")
        t0 = time.perf_counter()
        req = urllib.request.Request(
            base + "/v1/audio/speech", headers={"Content-Type":
                                                "application/json"},
            data=json.dumps({"input": "Hello from the card.",
                             "voice": "nova"}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            speech, ctype = r.read(), r.headers.get("Content-Type")
        times["speech_s"] = time.perf_counter() - t0
        with wave.open(io.BytesIO(speech), "rb") as wf:
            frames = wf.getnframes()
            if ctype != "audio/wav" or wf.getframerate() != 16000 or not frames:
                raise AssertionError("multimodal http: speech is no WAV")
        boundary = "chip-smoke-boundary"
        form = (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="file"; filename="chirp.wav"\r\nContent-Type: '
                "audio/wav\r\n\r\n").encode() + encode_wav(_chirp(2.0))
        form += (f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="model"\r\n\r\n{asr.model_id}\r\n'
                 f"--{boundary}--\r\n").encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(
            base + "/v1/audio/transcriptions", data=form,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=300) as r:
            text = json.loads(r.read())["text"]
        times["transcription_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _post(base + "/v1/images/generations",
                   {"prompt": MM_PROMPT, "n": 2}, timeout=300) as r:
            body = json.loads(r.read())
        times["images_s"] = time.perf_counter() - t0
        pngs = [base64.b64decode(d["b64_json"]) for d in body["data"]]
        if len(pngs) != 2 or any(p[:8] != b"\x89PNG\r\n\x1a\n" for p in pngs):
            raise AssertionError("multimodal http: images are no PNGs")
        absent = []
        for path, payload in (("/v1/audio/speech", {"input": "x"}),
                              ("/v1/images/generations", {"prompt": "x"})):
            try:
                with _post(bare_base + path, payload, timeout=60) as r:
                    absent.append(r.status)
            except urllib.error.HTTPError as e:
                absent.append(e.code)
        if absent != [404, 404]:
            raise AssertionError(f"multimodal http: absent services {absent}")
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("multimodal http: the served convolutions "
                                 "left cuDNN's TF32 on")
        times["gateway"] = _mm_gateway(dev, base, form, boundary, speech,
                                       text, pngs, want)
    finally:
        for s, th in ((srv, thread), (bare, bare_thread)):
            s.shutdown()
            s.server_close()
            th.join(timeout=10)
        engine.shutdown()
    log(f"multimodal http [{dev['smi']}]: /v1/models lists the three "
        f"services beside llama-3-8b (bf16); speech {times['speech_s']:.2f} s "
        f"({frames} samples), transcription of 2 s {times['transcription_s']:.2f}"
        f" s ({len(text.split())} ids), 2 images {times['images_s']:.2f} s; "
        "a server without them answers 404, 404; the served convolutions "
        "turned cuDNN's TF32 off (PyTorch's default on before them)")
    return times


def _mm_gateway(dev: dict, base: str, form: bytes, boundary: str,
                speech: bytes, text: str, pngs: list[bytes],
                want: dict) -> dict:
    """The port's gateway (a subprocess) in front of the multimodal server:
    the registration syncs its four models with their capabilities; speech
    through it gives the direct request's WAV bytes, the 2 s chirp's
    transcription the direct text, and images two PNGs, equal to the
    direct ones where two direct calls are equal."""
    import base64
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="llmlb-gw-mm-") as data_dir:
        proc, gw = _start_gateway(data_dir, [])
        try:
            token = _gw_json(gw + "/api/auth/login", {
                "username": "admin", "password": GATEWAY_PASSWORD})["token"]
            admin = {"Authorization": f"Bearer {token}"}
            key = _gw_json(gw + "/api/api-keys", {"name": "mm"},
                           admin)["api_key"]
            inf = {"Authorization": f"Bearer {key}"}
            ep = _gw_json(gw + "/api/endpoints", {
                "base_url": base, "name": "multimodal"}, admin)
            synced = {m["model_id"]: m["capabilities"]
                      for m in ep.get("models") or []}
            if ep["endpoint_type"] != "tpu" or len(synced) != 4 or any(
                    synced.get(k) != v for k, v in want.items()) or \
                    "chat_completion" not in synced.get("llama-3-8b", []):
                raise AssertionError(f"multimodal gateway: registration "
                                     f"{ep['endpoint_type']} {synced}")
            req = urllib.request.Request(
                gw + "/v1/audio/speech", headers={
                    "Content-Type": "application/json", **inf},
                data=json.dumps({"input": "Hello from the card.",
                                 "voice": "nova"}).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                via_speech = r.read()
            t1 = time.perf_counter()
            req = urllib.request.Request(
                gw + "/v1/audio/transcriptions", data=form, headers={
                    "Content-Type":
                    f"multipart/form-data; boundary={boundary}", **inf})
            with urllib.request.urlopen(req, timeout=300) as r:
                via_text = json.loads(r.read())["text"]
            transcription_s = time.perf_counter() - t1
            with _post(base + "/v1/images/generations",
                       {"prompt": MM_PROMPT, "n": 2}, timeout=300) as r:
                again = [base64.b64decode(d["b64_json"])
                         for d in json.loads(r.read())["data"]]
            with _post(gw + "/v1/images/generations",
                       {"prompt": MM_PROMPT, "n": 2}, headers=inf,
                       timeout=300) as r:
                via_pngs = [base64.b64decode(d["b64_json"])
                            for d in json.loads(r.read())["data"]]
        finally:
            proc.terminate()
            code = proc.wait(timeout=60)
        if code != 0:
            raise AssertionError(f"the multimodal gateway exited with {code}")
    if via_speech != speech:
        raise AssertionError("multimodal gateway: speech differs from the "
                             "direct request's WAV bytes")
    if via_text != text:
        raise AssertionError(f"multimodal gateway: transcription {via_text!r}"
                             f" against the direct {text!r}")
    if len(via_pngs) != 2 or any(p[:8] != b"\x89PNG\r\n\x1a\n"
                                 for p in via_pngs):
        raise AssertionError("multimodal gateway: images are no PNGs")
    direct_equal = again == pngs
    if direct_equal and via_pngs != pngs:
        raise AssertionError("multimodal gateway: images differ from the "
                             "direct ones, which two direct calls repeat")
    out = {"wall_s": time.perf_counter() - t0,
           "transcription_s": transcription_s,
           "images_direct_repeat": direct_equal,
           "images_equal_direct": via_pngs == pngs}
    log(f"multimodal gateway [{dev['smi']}]: the port's gateway in front of "
        f"the server synced its 4 models with their capabilities; speech "
        f"through it is the direct WAV bytes, the 2 s chirp's transcription "
        f"the direct text ({transcription_s:.2f} s), images 2 PNGs "
        + ("equal to the direct ones (two direct calls repeat)"
           if direct_equal else "(two direct calls differ, so not compared "
           "by bytes)")
        + f"; the sub-phase {out['wall_s']:.1f} s")
    return out


def phase_multimodal(dev: dict) -> dict:
    """Whisper-large-v3 transcription, TTS with Griffin-Lim and DDIM image
    generation on the card, each held against the CPU, then served over
    HTTP beside the bf16 serving core."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out, asr = _mm_whisper(dev)
    tts_out = _mm_tts(dev)
    image_out = _mm_image(dev)
    tts_eng, image = tts_out.pop("engine"), image_out.pop("engine")
    out.update(tts_out)
    out.update(image_out)
    out["http"] = _mm_http(dev, asr, tts_eng, image)
    del asr, tts_eng, image
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ids() -> dict:
    """The greedy ids of the bf16 serve phase's timed prompts (the 124-token
    chat, 64 ids; the 1503-token prompt, LONG_TOKENS ids) on a one-card
    engine of the serve phases' configuration, random weights of seed 0
    (which the serve phase's checkpoint holds bit for bit), graphs on."""
    from llmlb_tpu_torch.engine.service import Engine

    engine = Engine.from_preset("llama-3-8b", device="cuda", seed=0,
                                num_slots=SLOTS, slot_capacity=CAPACITY,
                                eos_id=-1)
    try:
        long_text = " ".join(f"w{i % 97}" for i in range(380))
        prompt = engine.encode_chat([{"role": "user", "content": "x" * 100}])
        long_prompt = engine.encode_chat([{"role": "user", "content":
                                           _first_word(long_text, 1)}])
        ids = _timed_core_request(engine.core, prompt, 64)[0]
        long_ids = _timed_core_request(engine.core, long_prompt,
                                       LONG_TOKENS)[0]
    finally:
        engine.shutdown()
    return {"ids": ids, "long_ids": long_ids, "prompt_tokens":
            [len(prompt), len(long_prompt)]}


# --------------------------------------------------- multi-device (A18)

MD_TOKENS = 16  # greedy ids of each request of the multi-device phase
# the one-card references and the ranks' engines alike: greedy, no prefix
# cache, eager bursts (a gloo mesh's collectives cannot be captured); the
# 1503-token prompt's ring pass runs at the CP bucket 2048
MD_KW = dict(num_slots=4, slot_capacity=2048, eos_id=-1, seed=0,
             prefix_cache=False, decode_graphs=False)
MD_CHATS = ("Describe a page table in one line.", "What does a ring pass?",
            "Name three primes.")
MD_MIX_WORDS = 150  # the Mixtral prompt: ~600 tokens, chunked at 512
# A rank's result is held as accurate as one card's: its RMS-relative
# distance from the fp32 computation of the same weights at most twice one
# card's own (a bf16 run of a 32-layer random model lies ~1-2% from fp32,
# and a tp mesh rounds its products at other points than one card; a wrong
# head, expert or position is off by ~100%). MD_FLOOR keeps the ratio
# finite where one card matches fp32 closely.
MD_ACCURACY = 2.0
MD_FLOOR = 2.0**-9
MD_PATH = {"tp": BF16_PATH, "sp": ("flash_prefill", "paged_flash_decode"),
           "ep": BF16_PATH, "dp": BF16_PATH, "moe_dp": BF16_PATH,
           "lora": ("flash_prefill", "paged_flash_decode", "lora_delta")}
# the LoRA sub-phase's rows: (chat, adapter); the last row's adapter loads
# cold while the others decode
MD_LORA_ROWS = ((0, None), (1, "acme"), (2, "beta"))
# each sub-phase's mesh, and the chats it sends over HTTP first (lora: one,
# with an adapter; moe_dp none: its group is queued before the loop starts)
MD_SUBS = ("tp", "sp", "ep", "dp", "moe_dp", "lora")
# the depth of the Llama sub-phases of MD_SUBS and MD_LEADER_SUBS and their
# one-card references (full width): the whole script then keeps headroom
# under its time limit (the leader's actions ran at full depth until the
# gateway's rebalance block and native build joined the proof)
MD_CUT_LAYERS = 8
MD_HTTP = {"tp": 3, "sp": 1, "ep": 1, "dp": 3, "moe_dp": 0, "lora": 1}
# the MoE dp sub-phase's group: MD_MOE_ROWS prompts of ~200 tokens (bucket
# 256), one prefill group over both dp groups in the capacity regime
MD_MOE_ROWS, MD_MOE_WORDS = 4, 55
# then the ep sub-phase's prompts (by index): the long one, the chat, the
# long one again, in slots 0, 1 and 2 (dp groups 0, 0, 1)
MD_MOE_AFTER = (1, 0, 1)
# the leader's actions on one host's ranks (A18c): two sub-phases at tp=2
# over Llama-3-8B; the leader's host tier, counted over whole pages
MD_LEADER_SUBS = ("leader", "split")
MD_OFFLOAD_BYTES = 512 << 20
MD_RESUME_TOKENS, MD_RESUME_AT = 24, 16  # the chat and its committed ids
MD_MIGRATE_AT = 8  # the migrated row's committed ids before its park
MD_PARK_TOKENS, MD_PARK_AFTER = 16, 6  # the priority park's victim
# the embeddings' two inputs: a chat's ids and the long prompt's head
MD_EMBED_LENS = (None, 600)


def _md_prompts() -> dict:
    """The phase's prompts (token ids through the chat template): the three
    chats and the 1503-token prompt (Llama), a chat and a ~600-token prompt
    (Mixtral)."""
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer(128256)

    def chat(text):
        return tok.encode(tok.apply_chat_template(
            [{"role": "user", "content": text}]))

    long_text = " ".join(f"w{i % 97}" for i in range(380))
    mix_text = " ".join(f"m{i % 89}" for i in range(MD_MIX_WORDS))
    return {"llama": [chat(c) for c in MD_CHATS] + [chat(long_text)],
            "mixtral": [chat(MD_CHATS[0]), chat(mix_text)],
            # the moe_dp sub-phase's group (short, repetitive rows: an
            # expert's share of the batch's tokens passes its capacity)
            "moe_dp": [chat(f"Row {i}: " + " ".join(
                f"d{j * (i + 1) % 7}" for j in range(MD_MOE_WORDS)))
                for i in range(MD_MOE_ROWS)],
            # the dp sub-phase's prefix-hit prompt: the long prompt at the
            # same length with a head of its own
            "dp_q": chat(_first_word(long_text, 7)),
            "lora": [chat(MD_CHATS[i]) for i, _ in MD_LORA_ROWS],
            # the leader sub-phase's: the migrated row (~600 tokens), the
            # priority park's rows, the embeddings' inputs
            "migrate_text": "Migrate: " + " ".join(
                f"g{i % 83}" for i in range(MD_MIX_WORDS)),
            "park": [chat(f"Priority row {i}: count the planets.")
                     for i in range(5)],
            "embed": [chat(MD_CHATS[1]),
                      chat(long_text)[:MD_EMBED_LENS[1]]]}


def _md_cfg(sub: str):
    import dataclasses

    from llmlb_tpu_torch.engine.presets import get_preset

    if sub in ("ep", "moe_dp"):
        return dataclasses.replace(get_preset("mixtral-8x7b"),
                                   num_layers=MIX_BF16_LAYERS)
    return dataclasses.replace(get_preset("llama-3-8b"),
                               num_layers=MD_CUT_LAYERS)


class _KVSpy:
    """The KV of one prompt as its slot's pages hold it when the slot
    activates (after its last chunk, or the ring pass): [L, n, K, D] K and
    V on the host. Wraps the core's _activate_group until close()."""

    def __init__(self, core, prompt: list[int]):
        self.core, self.kv = core, None
        # a spy set before this one (an instance attribute) comes back on
        # close()
        self.prev = core.__dict__.get("_activate_group")
        activate = core._activate_group

        def spy(group, slot_ids, lens, logits):
            for slot_id, request, n in group:
                if request.prompt_ids == prompt:
                    self.slot = slot_id
                    pages = core._slot_pages[slot_id]
                    self.kv = [c[:, pages].flatten(1, 2)[:, :n].cpu()
                               for c in (core.cache_k, core.cache_v)]
            activate(group, slot_ids, lens, logits)

        core._activate_group = spy

    def close(self) -> None:
        if self.prev is None:
            del self.core._activate_group
        else:
            self.core._activate_group = self.prev


def _md_lora_idx(core, adapter: str | None):
    """A one-row adapter index for the entry points (None without a pool)."""
    import torch

    if core.lora is None:
        return None
    return torch.tensor([core.lora.slot_of(adapter)], dtype=torch.int32,
                        device="cuda")


def _md_group(core, prompts: list[list[int]]):
    """The rows of one prefill dispatch of `prompts` as the scheduler lays
    out a group: the count padded to a power of two by repeating the last
    row, at the bucket of the longest (one prompt: its own length); (ids
    [B, T], lens [B]) on the card."""
    import torch

    rows = list(prompts)
    while len(rows) & (len(rows) - 1):
        rows.append(rows[-1])
    t = (core._bucket_for(max(map(len, rows))) if len(prompts) > 1
         else len(rows[0]))
    ids = torch.zeros((len(rows), t), dtype=torch.int64, device="cuda")
    for i, p in enumerate(rows):
        ids[i, :len(p)] = torch.tensor(p, device="cuda")
    return ids, torch.tensor([len(p) for p in rows], dtype=torch.int32,
                             device="cuda")


def _md_margins(core, prompts: list[list[int]], streams: list[list[int]],
                adapter: str | None = None) -> list:
    """One card's top-2 logit margins along greedy streams: the prompts
    prefilled in one dispatch into a scratch pool (`_md_group`: a group
    queued together, whose capacity dispatch couples its rows in an MoE),
    then each stream's ids (but the last) as one verify chunk, logits at
    every position (with the row's adapter, on a LoRA engine)."""
    import torch

    cfg, fam = core.model_cfg, core.family
    ids, lens = _md_group(core, prompts)
    t = len(streams[0]) - 1
    ps = core.kv_page_size
    per = -(-(ids.shape[1] + t + 1) // ps)
    b = ids.shape[0]
    ck, cv = fam.init_kv_pages(cfg, b * per + 1, ps, "cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    tables = torch.arange(1, b * per + 1, **i32).view(b, per)
    lidx = _md_lora_idx(core, adapter)
    lidx = None if lidx is None else lidx.expand(b).contiguous()
    first, _, _ = fam.prefill_into_pages(core.params, cfg, ids, lens, tables,
                                         ck, cv, lora_idx=lidx)
    tail = [streams[min(i, len(streams) - 1)][:-1] for i in range(b)]
    rest, _, _ = fam.verify_step_paged(
        core.params, cfg, torch.tensor(tail, device="cuda"),
        torch.full((b,), t, **i32), lens, tables, ck, cv, lora_idx=lidx)
    logits = torch.cat([first[:, None], rest], dim=1)[:len(prompts)]
    top2 = logits.topk(2, dim=-1).values
    return list((top2[..., 0] - top2[..., 1]).cpu())


def _md_encode(core, params, cfg, batch: list[list[int]]) -> list:
    """Each input's embedding vector as the service computes it (its row
    padded to its own power-of-two bucket, 16 and up), on the host."""
    import torch

    out = []
    for ids in batch:
        bucket = 16
        while bucket < len(ids):
            bucket *= 2
        row = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
        row[0, :len(ids)] = torch.tensor(ids, device="cuda")
        out.append(core.family.encode(
            params, cfg, row, torch.tensor([len(ids)], dtype=torch.int32,
                                           device="cuda"))[0].cpu())
    return out


def _md_fp32(core, prompts: list[list[int]], kv_of: int | None,
             adapters=None, embed=(), together=()):
    """The fp32 computation of the same weights, the yardstick both the
    one-card run and the ranks are measured by: the bf16 leaves widened to
    fp32 a leaf at a time (the engine's own leaves go as they widen, so it
    is spent after), each prompt prefilled alone in one fp32 dispatch
    (with its adapter of `adapters`, on a LoRA engine), then the
    `together` prompts in one dispatch (`_md_group`); their last-position
    logits, with `kv_of` that prompt's KV [L, n, K, D] fp32 on the host,
    and the embedding vectors of the `embed` inputs."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(core.model_cfg, dtype=torch.float32)
    fam, params = core.family, {}
    for name in list(core.params):
        params[name] = core.params.pop(name).float()
    ps = core.kv_page_size
    i32 = dict(dtype=torch.int32, device="cuda")
    logits, kv = [], None
    for i, p in enumerate(prompts):
        pages = -(-len(p) // ps)
        ck, cv = fam.init_kv_pages(cfg, pages + 1, ps, "cuda")
        out, _, _ = fam.prefill_into_pages(
            params, cfg, torch.tensor([p], device="cuda"),
            torch.tensor([len(p)], **i32),
            torch.arange(1, pages + 1, **i32)[None], ck, cv,
            lora_idx=_md_lora_idx(core, adapters[i] if adapters else None))
        logits.append(out[0].cpu())
        if i == kv_of:
            kv = [c[:, 1:].flatten(1, 2)[:, :len(p)].cpu() for c in (ck, cv)]
        del ck, cv
    if together:
        ids, lens = _md_group(core, together)
        b, per = ids.shape[0], -(-ids.shape[1] // ps)
        ck, cv = fam.init_kv_pages(cfg, b * per + 1, ps, "cuda")
        out, _, _ = fam.prefill_into_pages(
            params, cfg, ids, lens,
            torch.arange(1, b * per + 1, **i32).view(b, per), ck, cv)
        logits += list(out[:len(together)].cpu())
        del ck, cv
    vectors = _md_encode(core, params, cfg, embed)
    del params
    return logits, kv, vectors


def _md_reference(sub: str, prompts: list[list[int]], kv_of: int | None,
                  adapters=None, lora_dir: str | None = None, embed=(),
                  together=()):
    """The one-card run a sub-phase is held against: a one-rank engine of
    MD_KW over `prompts` submitted together (each with its adapter of
    `adapters`, served from `lora_dir`), then the `together` prompts
    queued at once from the step loop's thread, so they prefill in one
    dispatch, with their capacity drops a layer (`_Drops`); each prompt's
    first-step logits and MD_TOKENS greedy ids, the top-2 margins along
    each stream, with `kv_of` that prompt's KV, and the fp32
    computation's logits and KV (`_md_fp32`), and the embedding vectors
    of the `embed` inputs, one card's and the fp32 computation's. The
    engine is freed after."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import (EngineCore, Request,
                                                  SamplingParams)

    adapters = adapters or [None] * len(prompts)
    t0 = time.perf_counter()
    core = EngineCore(_md_cfg(sub), None, device="cuda", lora_dir=lora_dir,
                      **MD_KW)
    spy = _LogitSpy(core)
    kv = _KVSpy(core, prompts[kv_of]) if kv_of is not None else None
    core.start()
    try:
        reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
            temperature=0.0, max_tokens=MD_TOKENS, lora=a)))
            for p, a in zip(prompts, adapters)]
        ids = [_md_drain(r) for r in reqs]
        drops = []
        if together:
            counter = _Drops()
            try:
                late = core.call_in_loop(lambda: [core.submit(Request(
                    prompt_ids=list(p), sampling=SamplingParams(
                        temperature=0.0, max_tokens=MD_TOKENS)))
                    for p in together])
                ids += [_md_drain(r) for r in late]
            finally:
                counter.close()
            drops = counter.take()
    finally:
        core.stop()
        if kv is not None:
            kv.close()
        spy.close()
    ref = {"ids": ids, "drops": drops,
           "logits": [spy.get(p, a)[0].cpu()
                      for p, a in zip(list(prompts) + list(together),
                                      adapters + [None] * len(together))],
           "margins": [_md_margins(core, [p], [i], a)[0]
                       for p, i, a in zip(prompts, ids, adapters)],
           "kv": kv.kv if kv is not None else None,
           "embed": _md_encode(core, core.params, core.model_cfg, embed)}
    if together:
        ref["margins"] += _md_margins(core, list(together), ids[len(prompts):])
    ref["fp32"], ref["fp32_kv"], ref["fp32_embed"] = _md_fp32(
        core, prompts, kv_of, adapters, embed, together)
    ref["seconds"] = time.perf_counter() - t0
    del core, spy
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _md_drain(req, timeout: float = 600) -> list[int]:
    ids = []
    while True:
        kind, value = req.events.get(timeout=timeout)
        if kind == "token":
            ids.append(int(value))
        elif kind == "done":
            return ids
        else:
            raise RuntimeError(f"engine error: {value}")


def _md_kernel_checks() -> None:
    """Kernels #1-#3 against their plain versions at a tp=2 rank's shapes:
    half the heads (16 q, 4 KV), through the phase's check helper."""
    import torch

    from llmlb_tpu_torch.ops import cuda_attention as ca

    h, kv = H // 2, KV // 2
    gen = torch.Generator(device="cuda").manual_seed(18)
    bf16 = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    plens_host = [512, 300, 129, 1]
    plens = torch.tensor(plens_host, dtype=torch.int32, device="cuda")
    q, k, v = randn((4, 512, h, D)), randn((4, 512, kv, D)), randn(
        (4, 512, kv, D))
    _check(f"flash_prefill bf16 [4,512,{h},128] kv {kv} (a tp=2 rank)",
           ca.flash_prefill(q, k, v, plens),
           ca.flash_prefill_reference(q, k, v, plens), rel=BF16_REL,
           rows=plens_host)
    ppn = 2048 // PAGE
    kp, vp = _pool(torch, gen, 4 * ppn + 1, bf16, kv=kv)
    tables = (torch.randperm(4 * ppn, generator=gen, device="cuda") + 1
              ).reshape(4, ppn).to(torch.int32).contiguous()
    lens = torch.tensor([1519, 1000, 77, 1], dtype=torch.int32, device="cuda")
    qd = randn((4, h, D))
    _check(f"paged_flash_decode bf16 [4,{h},128] kv {kv} (a tp=2 rank)",
           ca.paged_flash_decode(qd, kp, vp, tables, lens, pages=ppn),
           ca.paged_flash_decode_reference(qd, kp, vp, tables, lens,
                                           pages=ppn), rel=BF16_REL)
    qe = randn((1, 512, h, D))
    start = torch.tensor([1024], dtype=torch.int32, device="cuda")
    chunk = torch.tensor([479], dtype=torch.int32, device="cuda")
    _check(f"paged_flash_extend bf16 [1,512,{h},128] kv {kv} start 1024 "
           "(a tp=2 rank)",
           ca.paged_flash_extend(qe, kp, vp, tables[:1].contiguous(), start,
                                 chunk),
           ca.paged_flash_extend_reference(qe, kp, vp, tables[:1].contiguous(),
                                           start, chunk),
           rel=BF16_REL, rows=[479])
    torch.cuda.synchronize()


def _md_lora_checks() -> None:
    """Kernel #6 against its plain version at a tp=2 rank's shapes of
    Llama-3-8B, rank 16, decode (4, 1) and chunk (4, 128) rows: the
    column-parallel targets (wq, wk, wv, wg, wu: IN whole, OUT halved)
    add the delta into the output in place (mode b, bit for bit against y
    + mode a rounded); the row-parallel ones (wo, wd: IN halved) give the
    fp32 partial delta (mode a) that joins the partial product."""
    import torch

    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.lora import lora_target_dims
    from llmlb_tpu_torch.ops import lora

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(19)
    idx = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device="cuda")
    dims = lora_target_dims(get_preset("llama-3-8b"), ("wq", "wk", "wv", "wo",
                                                        "wg", "wu", "wd"))
    for tgt, (in_dim, out_dim) in dims.items():
        row_parallel = tgt in ("wo", "wd")
        if row_parallel:
            in_dim //= 2
        else:
            out_dim //= 2
        a = (torch.randn((3, in_dim, 16), generator=gen, device="cuda")
             * in_dim**-0.5).to(bf16)
        b = (torch.randn((3, 16, out_dim), generator=gen, device="cuda")
             * 0.25).to(bf16)
        a[0], b[0] = 0, 0
        for t in (1, 128):
            x = torch.randn((4, t, in_dim), generator=gen,
                            device="cuda").to(bf16)
            tag = (f"lora_delta bf16 {tgt} x [4,{t},{in_dim}] -> {out_dim} "
                   f"(a tp=2 rank, {'row' if row_parallel else 'column'}"
                   "-parallel)")
            got = lora.lora_delta(x, a, b, idx)
            _check(tag + " mode (a)", got,
                   lora.lora_delta_reference(x, a, b, idx), rel=LORA_REL)
            if not row_parallel:
                y = torch.randn((4, t, out_dim), generator=gen,
                                device="cuda").to(bf16)
                fused = lora.lora_delta_add(y.clone(), x, a, b, idx)
                if not torch.equal(fused, y + got.to(bf16)):
                    raise AssertionError(f"{tag}: mode (b) is not y + "
                                         "delta.to(dtype) bit for bit")
    torch.cuda.synchronize()


def _md_mirror(core) -> list:
    """The requests a rank queues from the tick plans (a follower's are its
    shadows), in plan order."""
    seen = []
    apply = core._apply_plan

    def apply_and_keep(plan, local):
        before = core.pending.qsize()
        apply(plan, local)
        with core.pending.mutex:
            seen.extend(list(core.pending.queue)[before:])

    core._apply_plan = apply_and_keep
    return seen


def _md_sub(sub: str, rank: int, prompts: dict) -> dict:
    """One sub-phase on this rank: a lockstep engine over the sub-phase's
    mesh (tp=2, sp=2, ep=2, dp=2, dp=2 over Mixtral or tp=2 with two
    adapters), the leader serving HTTP (the chats) and then the
    sub-phase's prompts on its core (dp: then the prefix hit across
    groups; moe_dp: its group queued before the loop starts, then the
    Mixtral prompts of MD_MOE_AFTER; lora: the last row's adapter loaded cold
    mid-run); every rank's launches, the ids of every request it
    mirrored, and on the leader the first-step logits and, for sp and dp,
    the long prompt's KV as the pages hold it (dp: a digest on every
    rank; moe_dp: every rank's capacity drops a layer of the group's
    dispatch)."""
    import gc

    import torch

    from llmlb_tpu_torch.engine.scheduler import (EngineCore, Request,
                                                  SamplingParams)
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    import hashlib

    cfg = _md_cfg(sub)
    axes = {"tp": MeshConfig(tp=2), "sp": MeshConfig(sp=2, tp=1),
            "ep": MeshConfig(ep=2, tp=1), "dp": MeshConfig(dp=2, tp=1),
            "moe_dp": MeshConfig(dp=2, tp=1), "lora": MeshConfig(tp=2)}[sub]
    kw = dict(MD_KW)
    if sub == "dp":
        kw["prefix_cache"] = True  # the cross-group hit
    if sub == "lora":
        kw["lora_dir"] = prompts["lora_dir"]
    t0 = time.perf_counter()
    core = EngineCore(cfg, None, device="cuda", mesh_config=axes, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    moe = sub in ("ep", "moe_dp")
    engine = Engine("mixtral" if moe else "llama-3-8b", core,
                    ByteTokenizer(cfg.vocab_size))
    seen = _md_mirror(core)
    passes = [0]
    ring = core._cp_prefill_into_slot

    def counted(*args):
        passes[0] += 1
        return ring(*args)

    core._cp_prefill_into_slot = counted
    leader = rank == 0
    held = {"lora": prompts["lora"], "ep": prompts["mixtral"],
            "moe_dp": prompts["moe_dp"] + [prompts["mixtral"][i]
                                           for i in MD_MOE_AFTER]}.get(
                sub, prompts["llama"])
    adapters = ([a for _, a in MD_LORA_ROWS] if sub == "lora"
                else [None] * len(held))
    spy = _LogitSpy(core) if leader or sub == "dp" else None
    # the long prompt's KV as the pages hold it: the leader's for sp, every
    # rank's for dp (the exchange's copy against its writer's)
    kv = (_KVSpy(core, held[-1])
          if (leader and sub == "sp") or sub == "dp" else None)
    drops = _Drops() if sub == "moe_dp" else None
    # the MoE layers' gathers over dp: their share of the collectives
    gathers = {"calls": 0, "bytes": 0, "seconds": 0.0}
    gather = core.mesh.gather_batch

    def timed_gather(parts, rows):
        before = dict(core.mesh.stats)
        got = gather(parts, rows)
        for k in gathers:
            gathers[k] += core.mesh.stats[k] - before[k]
        return got

    core.mesh.gather_batch = timed_gather
    ca.reset_launch_counts()
    core.mesh.stats.update(calls=0, bytes=0, seconds=0.0)
    t1 = time.perf_counter()

    def submit(rows):
        return [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
            temperature=0.0, max_tokens=MD_TOKENS, lora=a))) for p, a in rows]

    # the MoE group rides the first tick plan, so every rank prefills it in
    # one dispatch (the one-card reference queues it at once too)
    group = (submit([(p, None) for p in prompts["moe_dp"]])
             if leader and sub == "moe_dp" else None)
    core.start()
    http = []

    def wait(reqs, until=lambda r: r.finished_at is not None):
        t_end = time.monotonic() + 600
        while not all(until(r) for r in reqs):
            if time.monotonic() > t_end:
                raise AssertionError(f"multi-device {sub}: requests did "
                                     "not finish")
            time.sleep(0.005)

    if leader:
        server, _ = start_server(engine)
        base = "http://%s:%d" % server.server_address[:2]
        try:
            for c in MD_CHATS[:MD_HTTP[sub]]:
                out = _chat(base, c, 8, False, model=engine.model_id,
                            lora="acme" if sub == "lora" else None)
                http.append(out["usage"]["completion_tokens"])
            # their ids stay in the events, read with every rank's below
            if sub == "lora":
                # the last row's adapter loads cold while the others decode
                first = submit(list(zip(held, adapters))[:-1])
                wait(first, lambda r: r.events.qsize() >= 2)
                wait(first + submit([(held[-1], adapters[-1])]))
            elif sub == "moe_dp":
                # then the long prompt in slots 0 (group 0) and 2 (group
                # 1), the chat between: chunks (#3) on every rank
                wait(group)
                wait(submit([(p, None) for p in held[MD_MOE_ROWS:]]))
            else:
                wait(submit(zip(held, adapters)))
            if sub == "dp":
                # a prefix hit across dp groups: the fresh long prompt
                # cold, alone (slot 0, group 0, which writes its pages and
                # donates its head), then again beside two chats (slots 0
                # and 1): it lands in slot 2, group 1, and hits
                wait(submit([(prompts["dp_q"], None)]))
                wait(submit([(held[0], None), (held[1], None),
                             (prompts["dp_q"], None)]))
        finally:
            server.shutdown()
            engine.shutdown()  # the stop rides the plan to the followers
    else:
        core._thread.join()
        engine.shutdown()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    if drops is not None:
        drops.close()
    streams = []
    for r in seen:
        ids = []
        while not r.events.empty():
            kind, value = r.events.get()
            if kind == "token":
                ids.append(int(value))
        streams.append(ids)
    h = MD_HTTP[sub]
    out = {"launches": dict(ca.LAUNCHES), "streams": streams, "http": http,
           "held": streams[h:h + len(held)],
           "init_s": init_s, "serve_s": serve_s,
           "collectives": dict(core.mesh.stats), "mesh": dict(core.mesh.shape),
           "backend": core.mesh.backend,
           "local": (core.model_cfg.num_heads, core.model_cfg.num_kv_heads,
                     core.model_cfg.intermediate_size,
                     tuple(core.params["we_gate"].shape[:2])
                     if moe else None),
           "param_gib": core.param_bytes / 2**30, "ring_passes": passes[0]}
    if leader:
        out["logits"] = [spy.get(p, a)[0].cpu()
                         for p, a in zip(held, adapters)]
        out["kv"] = kv.kv if kv is not None else None
    if sub == "dp":
        # the long prompt's pages on this rank (its group wrote them, or
        # the dp exchange copied them), and the hit prompt's two runs
        out["kv_sha"] = [hashlib.sha256(t.view(torch.uint8).numpy()
                                        .tobytes()).hexdigest()
                         for t in kv.kv]
        out["kv_writer"] = core._slot_groups[kv.slot]
        q = spy.get(prompts["dp_q"], None)
        out["q_logits_equal"] = len(q) == 2 and torch.equal(q[0], q[1])
        out["q_ids"] = [streams[h + len(held)], streams[-1]]
        out["prefix"] = dataclasses.asdict(core.stats().prefix)
        out["dp_slots"] = [core._slot_groups.count(g) for g in range(2)]
    if sub == "moe_dp":
        # the group's dispatch is the engine's first in the capacity regime
        out["drops"] = drops.calls[:cfg.num_layers]
        out["drop_tokens"] = drops.tokens[:cfg.num_layers]
        out["gathers"] = gathers
    if sub == "lora":
        out["lora_rows"] = {n: core.lora.slot_of(n)
                            for n in core.lora.resident_names()}
        out["lora_info"] = {k: v for k, v in core.lora_info().items()
                            if k in ("loads_total", "evictions_total",
                                     "active")}
        out["pool_shapes"] = {k: tuple(v.shape) for k, v in core.params.items()
                              if "_lora_" in k and k.startswith(("wk", "wd"))}
    # the engine goes with this frame (its spies and wrappers point at it)
    del engine, core, spy, kv, ring, counted, seen, drops, gather
    gc.collect()
    return out


class _MdRecorder:
    """What every rank of a leader's-actions sub-phase records, each on its
    own core: the ids each request emitted (by engine request id), its
    parks (gateway id, reason, committed ids), the sha256 of its own KV
    rows at a migration park and after each wire payload lands, and #1's
    launches inside the encode forwards. Wraps the core's methods as
    instance attributes."""

    def __init__(self, core):
        from llmlb_tpu_torch.engine.flightrec import gateway_rid
        from llmlb_tpu_torch.ops import cuda_attention as ca

        self.ids: dict[str, list[int]] = {}
        self.parks: list = []
        # a migration park's rows, copied on the card and hashed after the
        # sub-phase (not in the park's wait for its export)
        self.park_rows: list = []
        self.land_sha: list = []
        self.encode_prefills = 0
        # ms from a migration's park request to its export held (leader)
        self.park_to_export_ms: list[float] = []
        asked: list[float] = []
        emit, park, request_park = (core._emit, core._park_slot,
                                    core.request_park)
        spill, land, encode = (core._spill_parked_slot, core._land_kv_pages,
                               core._encode)

        def on_emit(slot_id, token):
            rid = core.slots[slot_id].request.request_id
            self.ids.setdefault(rid, []).append(int(token))
            emit(slot_id, token)

        def on_park(slot_id, reason="preempt"):
            slot = core.slots[slot_id]
            self.parks.append((gateway_rid(slot.request.request_id), reason,
                               len(slot.out_tokens)))
            park(slot_id, reason)

        def on_request_park(gateway_id):
            asked.append(time.perf_counter())
            request_park(gateway_id)

        def on_spill(slot_id, request, reason):
            if reason == "migrate":
                tokens = int(core._seq_lens[slot_id])
                self.park_rows.append(_md_rows(
                    core, core._slot_pages[slot_id], tokens))
            spill(slot_id, request, reason)
            if reason == "migrate" and asked:
                self.park_to_export_ms.append(
                    (time.perf_counter() - asked.pop(0)) * 1e3)

        def on_land(kvp, fresh):
            land(kvp, fresh)
            if kvp.source == "wire":
                self.land_sha.append(_md_sha(_md_rows(core, fresh,
                                                      kvp.header.tokens)))

        def on_encode(ids, lens):
            before = ca.LAUNCHES.get("flash_prefill", 0)
            out = encode(ids, lens)
            self.encode_prefills += ca.LAUNCHES.get("flash_prefill",
                                                    0) - before
            return out

        core._emit, core._park_slot = on_emit, on_park
        core._spill_parked_slot, core._land_kv_pages = on_spill, on_land
        core._encode, core.request_park = on_encode, on_request_park


def _md_rows(core, pages: list[int], tokens: int) -> list:
    """A copy on the card of this rank's K and V rows [0, tokens) over
    `pages`."""
    return [c[:, pages].flatten(1, 2)[:, :tokens].contiguous()
            for c in (core.cache_k, core.cache_v)]


def _md_sha(rows: list) -> list[str]:
    """sha256 of each of `rows` (`_md_rows`)."""
    import hashlib

    import torch

    return [hashlib.sha256(r.view(torch.uint8).cpu().numpy().tobytes())
            .hexdigest() for r in rows]


def _md_engine(rank: int, **extra):
    """A lockstep tp=2 Llama-3-8B engine of MD_KW (and `extra`) with the
    service over it, its recorder, and its launch and collective counts
    from 0; (core, engine, recorder, init seconds)."""
    import torch

    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.service import Engine
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmlb_tpu_torch.ops import cuda_attention as ca
    from llmlb_tpu_torch.parallel.mesh import MeshConfig

    cfg = _md_cfg("leader")
    t0 = time.perf_counter()
    core = EngineCore(cfg, None, device="cuda", mesh_config=MeshConfig(tp=2),
                      **{**MD_KW, **extra})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = Engine("llama-3-8b", core, ByteTokenizer(cfg.vocab_size))
    rec = _MdRecorder(core)
    ca.reset_launch_counts()
    core.mesh.stats.update(calls=0, bytes=0, seconds=0.0)
    return core, engine, rec, init_s


def _md_result(core, rec, init_s: float, serve_s: float) -> dict:
    from llmlb_tpu_torch.ops import cuda_attention as ca

    return {"launches": dict(ca.LAUNCHES), "ids": rec.ids,
            "parks": rec.parks,
            "park_sha": [_md_sha(rows) for rows in rec.park_rows],
            "land_sha": rec.land_sha, "encode_prefills": rec.encode_prefills,
            "park_to_export_ms": rec.park_to_export_ms,
            "collectives": dict(core.mesh.stats), "init_s": init_s,
            "serve_s": serve_s, "mesh": dict(core.mesh.shape),
            "backend": core.mesh.backend,
            "offload": (core.kv_offload.info() if core.kv_offload is not None
                        else None),
            "ledger": (dict(core.prefill_dispatch_by_loop),
                       dict(core.decode_dispatch_by_loop))}


def _md_submit(core, prompts: list, max_tokens: int, priority: int = 1,
                 rids=None) -> list:
    """Submit greedy requests to the core; returns them."""
    from llmlb_tpu_torch.engine.scheduler import Request, SamplingParams

    reqs = []
    for i, p in enumerate(prompts):
        req = Request(prompt_ids=list(p), sampling=SamplingParams(
            temperature=0.0, max_tokens=max_tokens, priority=priority))
        if rids is not None:
            req.request_id = rids[i]
        reqs.append(core.submit(req))
    return reqs


def _md_wait(reqs, n: int, what: str) -> None:
    """Until every request holds n ids (or ended)."""
    t_end = time.monotonic() + 600
    while not all(r.events.qsize() >= n or r.finished_at for r in reqs):
        if time.monotonic() > t_end:
            raise AssertionError(f"multi-device {what}: requests stalled")
        time.sleep(0.005)


def _md_combined(core, prompts: dict, what: str) -> list:
    """The split sub-phase's traffic on `core`: two chats decoding when the
    1503-token prompt arrives; their ids."""
    chats = _md_submit(core, prompts["llama"][:2], MD_TOKENS)
    _md_wait(chats, 2, what)
    long = _md_submit(core, prompts["llama"][-1:], MD_TOKENS)
    return [_md_drain(r) for r in chats + long]


def _md_leader(rank: int, prompts: dict) -> dict:
    """The leader sub-phase on this rank: a tp=2 engine with the host tier;
    the leader serves HTTP and drives the blocks (the rank raises where
    the leader's own ids part), every rank records (`_MdRecorder`)."""
    import http.client

    import torch

    from llmlb_tpu_torch.engine.server import start_server

    # bursts of 2 steps: /v1/kv/export polls for its park for 2 s, and a
    # tp=2 step of a gloo mesh on one card takes ~0.2 s of host round
    # trips (the park waits for the burst in flight, then the ~620-token
    # row's heads are gathered and base64-encoded; the recorder logs that
    # wait as `park_to_export_ms`)
    core, engine, rec, init_s = _md_engine(
        rank, kv_offload_bytes=MD_OFFLOAD_BYTES, decode_burst=2)
    t1 = time.perf_counter()
    core.start()
    out: dict = {}
    if rank == 0:
        server, _ = start_server(engine)
        base = "http://%s:%d" % server.server_address[:2]
        secs = out["block_s"] = {}
        try:
            t = time.perf_counter()
            out["combined"] = _md_combined(core, prompts, "leader")
            secs["combined"] = time.perf_counter() - t
            # a streamed chat, then its resume with 16 committed ids
            t = time.perf_counter()
            body = _armed("Resume on the mesh: count to ten.",
                          MD_RESUME_TOKENS, None)
            full, _ = _stream_ids(base, "/v1/chat/completions", body)
            again, _ = _stream_ids(base, "/v1/resume", {
                **body, "committed_ids": full[:MD_RESUME_AT]})
            if len(full) != MD_RESUME_TOKENS or again != full:
                raise AssertionError(
                    f"multi-device leader: /v1/resume after {MD_RESUME_AT} "
                    f"committed ids gives {_shared(again, full)} of the "
                    f"uninterrupted {len(full)} ids")
            secs["resume"] = time.perf_counter() - t
            # a migration: the row parked by /v1/kv/export, then resumed
            # with its pages landed
            t = time.perf_counter()
            body = _armed(prompts["migrate_text"], MD_RESUME_TOKENS, None)
            full_m, _ = _stream_ids(base, "/v1/chat/completions", body)
            host, port = base[len("http://"):].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=600)
            conn.request("POST", "/v1/chat/completions", json.dumps(body),
                         {"Content-Type": "application/json",
                          "X-Request-Id": "mdmig"})
            committed: list[int] = []
            for data in _sse_lines(conn.getresponse()):
                obj = json.loads(data)
                if obj.get("object") == "llmlb.replay":
                    committed.extend(obj["tokens"])
                    if len(committed) >= MD_MIGRATE_AT:
                        break
            t_exp = time.perf_counter()
            with _post(base + "/v1/kv/export", {"request_id": "mdmig",
                                                "park": True}) as r:
                pages = json.loads(r.read())["kv_pages"]
            export_ms = (time.perf_counter() - t_exp) * 1e3
            conn.close()
            _wait_idle(core)
            moved, _ = _stream_ids(base, "/v1/resume", {
                **body, "committed_ids": committed, "kv_pages": pages})
            if moved != full_m or committed != full_m[:len(committed)]:
                raise AssertionError(
                    f"multi-device leader: the migrated row gives "
                    f"{_shared(moved, full_m)} of the uninterrupted "
                    f"{len(full_m)} ids")
            out["migrate"] = {"committed": len(committed),
                              "tokens": pages["tokens"],
                              "b64_mib": len(pages["data"]) / 2**20,
                              "export_ms": export_ms}
            secs["migrate"] = time.perf_counter() - t
            # a priority park into the tier, restored from it
            t = time.perf_counter()
            solo = _md_drain(_md_submit(core, prompts["park"][:1],
                                          MD_PARK_TOKENS, 2)[0])
            victim = _md_submit(core, prompts["park"][:1], MD_PARK_TOKENS,
                                  2)[0]
            others = _md_submit(core, prompts["park"][1:4], MD_PARK_TOKENS)
            _md_wait([victim], MD_PARK_AFTER, "leader")
            hi = _md_submit(core, prompts["park"][4:], 8, 0)
            ids = _md_drain(victim)
            for r in others + hi:
                _md_drain(r)
            tier = core.kv_offload.info()
            if ids != solo or tier["hits"] < 1:
                raise AssertionError(
                    f"multi-device leader: the parked row gives "
                    f"{_shared(ids, solo)} of its solo {len(solo)} ids; "
                    f"tier {tier}")
            secs["park"] = time.perf_counter() - t
            # embeddings of two inputs
            t = time.perf_counter()
            with _post(base + "/v1/embeddings", {
                    "model": "llama-3-8b", "input": prompts["embed"]}) as r:
                out["embed"] = [d["embedding"]
                                for d in json.loads(r.read())["data"]]
            secs["embed"] = time.perf_counter() - t
            # last, the drain: two rows decoding, a grace of 0.5 s
            t = time.perf_counter()
            rids = [f"mddrain{i}.{i:08x}" for i in range(2)]
            rows = _md_submit(core, prompts["park"][1:3], 256, rids=rids)
            _md_wait(rows, 4, "leader")
            with _post(base + "/api/drain", {"grace_s": 0.5}) as r:
                json.loads(r.read())
            server.drain.wait(60)
            exports = [core.take_kv_export(f"mddrain{i}") for i in range(2)]
            out["drain"] = {"info": server.drain.info(),
                            "exports": [e and e["tokens"] for e in exports]}
            if any(e is None for e in exports):
                raise AssertionError(f"multi-device leader: the drain's "
                                     f"exports {out['drain']}")
            secs["drain"] = time.perf_counter() - t
        finally:
            server.shutdown()
            engine.shutdown()  # the stop rides the plan to the followers
    else:
        core._thread.join()
        engine.shutdown()
    torch.cuda.synchronize()
    out.update(_md_result(core, rec, init_s, time.perf_counter() - t1))
    return out


def _md_split(rank: int, prompts: dict) -> dict:
    """The split sub-phase on this rank: a tp=2 engine with --role split
    (2 prefill and 2 decode slots); the leader drives the combined
    sub-phase's traffic."""
    import torch

    core, engine, rec, init_s = _md_engine(rank, role="split",
                                           disagg_prefill_slots=2)
    t1 = time.perf_counter()
    core.start()
    out: dict = {}
    if rank == 0:
        try:
            out["combined"] = _md_combined(core, prompts, "split")
        finally:
            engine.shutdown()
    else:
        core._thread.join()
        engine.shutdown()
    torch.cuda.synchronize()
    out.update(_md_result(core, rec, init_s, time.perf_counter() - t1))
    return out


def md_rank_main(rank: int, world: int, port: int, backend: str, src: str,
                 dst: str) -> None:
    """A rank of the multi-device phase: joins the world through the
    port's LLMLB_* variables (`init_from_env`), runs the sub-phases of
    MD_SUBS, then MD_LEADER_SUBS, in order and pickles its results to
    `dst`."""
    import gc
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from llmlb_tpu_torch.parallel.distributed import init_from_env

    os.environ.update(LLMLB_COORDINATOR=f"127.0.0.1:{port}",
                      LLMLB_NUM_HOSTS=str(world), LLMLB_HOST_ID=str(rank),
                      LLMLB_MESH_BACKEND=backend, LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert init_from_env("cuda")
    with open(src, "rb") as f:
        prompts = pickle.load(f)
    out = {}
    run = {"leader": _md_leader, "split": _md_split}
    for sub in MD_SUBS + MD_LEADER_SUBS:
        out[sub] = (run[sub](rank, prompts) if sub in run
                    else _md_sub(sub, rank, prompts))
        gc.collect()
        torch.cuda.empty_cache()
        out[sub]["left_gib"] = torch.cuda.memory_allocated() / 2**30
        print(f"rank {rank} {sub}: init {out[sub]['init_s']:.1f} s, serve "
              f"{out[sub]['serve_s']:.1f} s, {out[sub]['left_gib']:.2f} GiB "
              "left after", flush=True)
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _rms_rel(g, r) -> float:
    return float((g.float() - r.float()).norm() / r.float().norm())


def _md_hold(label: str, ref: dict, leader: dict, n: int) -> dict:
    """A sub-phase's leader against the one-card run. Each prompt's
    first-step logits: read against one card's elementwise (max |diff|,
    and whether the bf16 limit 2^-6 (|ref| + rms(ref)) holds), and HELD as
    accurate as one card's: their RMS-relative distance from the fp32
    computation of the same weights at most MD_ACCURACY times one card's
    own. The greedy ids equal one card's up to the first position where
    the one-card top-2 margin is below the measured logit difference (the
    rule the spec block holds its partings to)."""
    errs, rows = [], []
    for i, (g, r, t) in enumerate(zip(leader["logits"], ref["logits"],
                                      ref["fp32"])):
        err, ok = _within(g[None], r[None], 0.0, BF16_REL, None)
        errs.append(err)
        mine, one = _rms_rel(g, t), _rms_rel(r, t)
        rows.append({"max_abs": err, "bf16_elementwise": ok,
                     "rms_rel_fp32": mine, "one_card_rms_rel_fp32": one})
        if mine > MD_ACCURACY * max(one, MD_FLOOR):
            raise AssertionError(
                f"multi-device {label}: prompt {i}'s first-step logits are "
                f"{mine:.3e} (RMS-relative) from the fp32 computation, one "
                f"card's {one:.3e}: over {MD_ACCURACY}x")
    diff = max(errs)
    got = leader["held"]
    shared = [_shared(a, b) for a, b in zip(got, ref["ids"])]
    parts = [(i, p, float(ref["margins"][i][p])) for i, p in
             enumerate(shared) if p < min(len(got[i]), len(ref["ids"][i]))]
    bad = [x for x in parts if x[2] >= diff]
    log(f"multi-device {label}: first-step logits against one card's, max "
        f"|diff| {[f'{e:.3e}' for e in errs]}, within the elementwise bf16 "
        f"limit {[x['bf16_elementwise'] for x in rows]}; RMS-relative from "
        f"the fp32 computation {[round(x['rms_rel_fp32'], 5) for x in rows]}"
        f", one card's {[round(x['one_card_rms_rel_fp32'], 5) for x in rows]}"
        f" (held at <= {MD_ACCURACY}x); greedy ids shared with one card "
        f"{shared} of {MD_TOKENS}; partings (prompt, position, one-card "
        f"top-2 margin) {[(i, p, f'{m:.4f}') for i, p, m in parts]}")
    if bad:
        raise AssertionError(f"multi-device {label}: a parting at a margin "
                             f"not below the logit difference {diff:.4f}: "
                             f"{bad}")
    return {"logit_diff": diff, "logits": rows, "shared": shared,
            "partings": parts}


def _md_dp_checks(ranks: list, ref: dict, n_long: int) -> dict:
    """The dp sub-phase's own checks. The long prompt's pages: the rank
    whose group did not write them holds the writer's bits (a digest of
    each rank's K and V). The prefix hit across groups: the same ids and
    first-step logits as its cold run, bit for bit, on every rank. Whether
    the leader's ids and first-step logits are one card's bits (read, not
    held: a dp group's decode products take B / dp rows, one card's B, and
    cuBLAS picks its sums by M)."""
    import torch

    lead = ranks[0]["dp"]
    shas = [x["dp"]["kv_sha"] for x in ranks]
    writer = lead["kv_writer"]
    if any(s != shas[writer] for s in shas):
        raise AssertionError(f"multi-device dp: the {n_long}-token prompt's "
                             f"pages differ between the writer (group "
                             f"{writer}) and the other rank: {shas}")
    for r, x in enumerate(ranks):
        cold, hit = x["dp"]["q_ids"]
        if cold != hit or not x["dp"]["q_logits_equal"]:
            raise AssertionError(
                f"multi-device dp: rank {r}: the prefix hit across groups "
                f"is not its cold run (ids equal {cold == hit}, first "
                f"logits equal {x['dp']['q_logits_equal']})")
    hits = lead["prefix"]["prefix_hits_total"]
    if hits < 1:
        raise AssertionError(f"multi-device dp: no prefix hit ({lead['prefix']})")
    ids_bits = [a == b for a, b in zip(lead["held"], ref["ids"])]
    logit_bits = [bool(torch.equal(a, b))
                  for a, b in zip(lead["logits"], ref["logits"])]
    kv_bits = [bool(torch.equal(a, b)) for a, b in zip(lead["kv"], ref["kv"])]
    log(f"multi-device dp: the {n_long}-token prompt's pages (written by "
        f"group {writer}) equal on both ranks bit for bit ({shas[0][0][:12]}"
        f"..., {shas[0][1][:12]}...); the prefix hit across groups "
        f"({hits} hit(s), {lead['prefix']['prefix_cached_tokens_total']} "
        f"cached tokens) equals its cold run bit for bit, ids and first "
        f"logits, on every rank; one card's bits? ids {ids_bits}, first-step"
        f" logits {logit_bits}, the long prompt's KV {kv_bits}; dp slots "
        f"{lead['dp_slots']}")
    return {"kv_writer": writer, "prefix_hits": hits,
            "one_card_ids": ids_bits, "one_card_logits": logit_bits,
            "one_card_kv": kv_bits}


def _md_pick(ref: dict, idx: list[int]) -> dict:
    """The one-card run of the prompts at `idx` of a reference's."""
    return {**ref, **{k: [ref[k][i] for i in idx]
                      for k in ("ids", "logits", "margins", "fp32")}}


def _md_moe_dp_checks(ranks: list, ref: dict) -> dict:
    """The moe_dp sub-phase's own checks: its group's capacity dispatch,
    whose rows span both dp groups, ran over the whole batch on every
    rank: each layer's capacity drops (`_Drops`, of B * T tokens) more
    than zero in all, the same on both ranks, and one card's for the same
    batch. Whether the leader's ids and first-step logits are one card's
    bits (read, not held)."""
    import torch

    lead = ranks[0]["moe_dp"]
    drops = [x["moe_dp"]["drops"] for x in ranks]
    if sum(drops[0]) == 0 or any(d != drops[0] for d in drops) or (
            drops[0] != ref["drops"]):
        raise AssertionError(
            f"multi-device moe_dp: the group's capacity drops a layer, "
            f"ranks {drops} (of {lead['drop_tokens']} tokens), one card "
            f"{ref['drops']}: want more than zero, alike on every rank and "
            "one card's")
    ids_bits = [a == b for a, b in zip(lead["held"], ref["ids"])]
    logit_bits = [bool(torch.equal(a, b))
                  for a, b in zip(lead["logits"], ref["logits"])]
    gathers = [x["moe_dp"]["gathers"] for x in ranks]
    read = [(g["calls"], round(g["bytes"] / 2**20, 2), round(g["seconds"], 3))
            for g in gathers]
    log(f"multi-device moe_dp: the group's capacity drops a layer {drops[0]}"
        f" of {lead['drop_tokens'][0]} tokens (B * T) on every rank, one "
        f"card's; the MoE layers' gathers over dp a rank (calls, MiB, host "
        f"s) {read}; one card's bits? ids {ids_bits}, first-step logits "
        f"{logit_bits}")
    return {"drops": drops[0], "gathers": gathers, "one_card_ids": ids_bits,
            "one_card_logits": logit_bits}


def _md_lora_hold(ranks: list) -> dict:
    """The lora sub-phase's own checks: every rank put each adapter in the
    same pool row (the cold one loaded mid-run too); the adapter-free row
    of the mixed batch equals the tp=2 engine without --lora-dir (the tp
    sub-phase, the same chat), ids and first-step logits bit for bit."""
    import torch

    lead, tp = ranks[0]["lora"], ranks[0]["tp"]
    rows = [x["lora"]["lora_rows"] for x in ranks]
    if any(r != rows[0] for r in rows):
        raise AssertionError(f"multi-device lora: pool rows differ across "
                             f"ranks: {rows}")
    free = [i for i, (_, a) in enumerate(MD_LORA_ROWS) if a is None]
    for i in free:
        chat = MD_LORA_ROWS[i][0]
        same_ids = lead["held"][i] == tp["held"][chat]
        same_logits = bool(torch.equal(lead["logits"][i], tp["logits"][chat]))
        if not (same_ids and same_logits):
            raise AssertionError(
                f"multi-device lora: adapter-free row {i} differs from the "
                f"tp=2 engine without adapters (ids {same_ids}, first "
                f"logits {same_logits})")
    log(f"multi-device lora: pool rows {rows[0]} on every rank, "
        f"{lead['lora_info']}; rank shards {lead['pool_shapes']}; "
        f"adapter-free row(s) {free} equal the tp=2 engine without "
        "--lora-dir bit for bit (ids and first-step logits)")
    return {"lora_rows": rows[0], "lora_info": lead["lora_info"]}


def _md_kv_check(got: list, ref: list, fp32: list, n: int,
                 sub: str = "sp") -> dict:
    """The ring pass's KV as the pages hold it, [L, n, K, D] each for K and
    V, against one card's chunked prefill's: layer 0's cells, made from the
    same embedding rows, elementwise within the bf16 limit (every position
    in its own cell); every layer as accurate as one card's, its
    RMS-relative distance from the fp32 computation's KV at most
    MD_ACCURACY times one card's (the later layers carry the two runs'
    attention roundings)."""
    out = {}
    for what, g, w, t in zip("KV", got, ref, fp32):
        g, w, t = g.float(), w.float(), t.float()
        err0, ok0 = _within(g[0], w[0], 0.0, BF16_REL, None)
        tn = t.flatten(1).norm(dim=1)
        mine = ((g - t).flatten(1).norm(dim=1) / tn).tolist()
        one = ((w - t).flatten(1).norm(dim=1) / tn).tolist()
        ratio = [a / max(b, MD_FLOOR) for a, b in zip(mine, one)]
        worst = ratio.index(max(ratio))
        out[what] = {"layer0_max_abs": err0,
                     "max_abs": (g - w).abs().max().item(),
                     "worst_layer": worst, "rms_rel_fp32": mine[worst],
                     "one_card_rms_rel_fp32": one[worst]}
        if not ok0 or max(ratio) > MD_ACCURACY:
            raise AssertionError(
                f"multi-device {sub}: the {n}-token prompt's {what} in the "
                f"pages: layer 0 max |diff| from one card's {err0:.3e} "
                f"({'ok' if ok0 else 'FAIL'}); layer {worst} {mine[worst]:.3e}"
                f" from the fp32 KV against one card's {one[worst]:.3e}")
    return out


def _md_leader_checks(ranks: list, ref: dict, dev: dict,
                      launches: dict) -> dict:
    """The leader and split sub-phases across the ranks: every rank's ids,
    parks and tier the leader's; each rank's landed pages its own pages at
    the migration's park; the embeddings as accurate as one card's against
    the fp32 computation, #1 launched in the encode forwards of every
    rank; the split's ids the combined engine's, no prefill dispatch on
    any rank's decode loop; each kernel of the path launched on every
    rank (the launches added to `launches`). Returns the numbers."""
    import torch

    report = {}
    for sub in MD_LEADER_SUBS:
        lead = ranks[0][sub]
        for what in ("ids", "parks", "offload"):
            if any(x[sub][what] != lead[what] for x in ranks[1:]):
                raise AssertionError(f"multi-device {sub}: a rank's {what} "
                                     "differ from the leader's")
        per_rank = [{k: v for k, v in x[sub]["launches"].items() if v}
                    for x in ranks]
        missing = [k for k in BF16_PATH
                   if any(pr.get(k, 0) == 0 for pr in per_rank)]
        if missing:
            raise AssertionError(f"multi-device {sub}: kernels never "
                                 f"launched on a rank: {missing}")
        for pr in per_rank:
            for k, v in pr.items():
                launches[k] = launches.get(k, 0) + v
        col = [x[sub]["collectives"] for x in ranks]
        report[sub] = {"init_s": [x[sub]["init_s"] for x in ranks],
                       "serve_s": [x[sub]["serve_s"] for x in ranks],
                       "collectives": col, "launches": per_rank,
                       "ledger": [x[sub]["ledger"] for x in ranks]}
    lead = ranks[0]["leader"]
    for r, x in enumerate(ranks):
        got = x["leader"]
        if got["land_sha"] != got["park_sha"] or len(got["land_sha"]) != 1:
            raise AssertionError(
                f"multi-device leader: rank {r}'s landed pages are not its "
                f"pages at the park ({got['land_sha']} vs {got['park_sha']})")
        if got["encode_prefills"] < 1:
            raise AssertionError(f"multi-device leader: rank {r} launched "
                                 "no flash_prefill in the encode forwards")
    drained = [p for p in lead["parks"] if p[1] == "drain"]
    if len(drained) != 2:
        raise AssertionError(f"multi-device leader: the drain parked "
                             f"{drained}")
    embed = []
    for i, (g, one, t) in enumerate(zip(lead["embed"], ref["embed"],
                                        ref["fp32_embed"])):
        g = torch.tensor(g)
        mine, theirs = _rms_rel(g, t), _rms_rel(one, t)
        embed.append({"rms_rel_fp32": mine, "one_card_rms_rel_fp32": theirs,
                      "max_abs_one_card": (g - one.float()).abs().max().item()})
        if mine > MD_ACCURACY * max(theirs, MD_FLOOR):
            raise AssertionError(
                f"multi-device leader: embedding {i} is {mine:.3e} "
                f"(RMS-relative) from the fp32 computation, one card's "
                f"{theirs:.3e}: over {MD_ACCURACY}x")
    split = ranks[0]["split"]
    if split["combined"] != lead["combined"]:
        raise AssertionError(
            f"multi-device split: ids shared with the combined engine "
            f"{[_shared(a, b) for a, b in zip(split['combined'], lead['combined'])]}")
    for r, x in enumerate(ranks):
        prefill, _ = x["split"]["ledger"]
        if prefill["decode"] != 0 or prefill["prefill"] < 1:
            raise AssertionError(f"multi-device split: rank {r}'s prefill "
                                 f"dispatches by loop {prefill}")
    report["leader"].update(block_s=lead["block_s"], migrate=lead["migrate"],
                            park_to_export_ms=lead["park_to_export_ms"],
                            drain=lead["drain"], embed=embed,
                            offload=lead["offload"],
                            encode_prefills=[x["leader"]["encode_prefills"]
                                             for x in ranks])
    for sub in MD_LEADER_SUBS:
        rep = report[sub]
        log(f"multi-device {sub} [{dev['smi']}]: mesh "
            f"{ranks[0][sub]['mesh']} over {ranks[0][sub]['backend']}; "
            f"engine init {[round(v, 1) for v in rep['init_s']]} s, serving "
            f"{[round(v, 1) for v in rep['serve_s']]} s; collectives a rank "
            f"(calls, MiB, host s) "
            f"{[(c['calls'], round(c['bytes'] / 2**20, 1), round(c['seconds'], 2)) for c in rep['collectives']]}; "
            f"launches a rank {rep['launches']}; dispatches by loop "
            f"(prefill, decode) {rep['ledger']}")
    mig = lead["migrate"]
    embed_diff = ["%.3e" % e["max_abs_one_card"] for e in embed]
    blocks = {k: round(v, 1) for k, v in lead["block_s"].items()}
    log(f"multi-device leader: blocks {blocks} s; "
        f"/v1/resume after {MD_RESUME_AT} committed ids the uninterrupted "
        f"{MD_RESUME_TOKENS}; the migration after {mig['committed']} ids "
        f"({mig['tokens']} tokens of KV, {mig['b64_mib']:.1f} MiB base64, "
        f"export POST {mig['export_ms']:.1f} ms, of it "
        f"{lead['park_to_export_ms']} ms from the park request to the "
        f"export held) the uninterrupted ids, "
        f"each rank's landed pages its own at the park (sha256); the "
        f"priority park restored from the tier ({lead['offload']}, alike "
        f"on every rank); embeddings RMS-relative from fp32 "
        f"{[round(e['rms_rel_fp32'], 6) for e in embed]}, one card's "
        f"{[round(e['one_card_rms_rel_fp32'], 6) for e in embed]}, max "
        f"|diff| from one card's {embed_diff}, #1 in the "
        f"encode forwards {report['leader']['encode_prefills']}; the drain "
        f"parked {len(drained)} rows on every rank, exports of "
        f"{lead['drain']['exports']} tokens; split: the combined engine's "
        f"ids, no prefill dispatch on any decode loop")
    return report


def phase_multi_device(dev: dict) -> dict:
    """Multi-rank serving on the card (A18): the sub-phases of MD_SUBS and
    MD_LEADER_SUBS in one world of two ranks spawned from this script,
    rank 0 serving HTTP through the port's server with LLMLB_COORDINATOR
    set and rank 1 a follower (see the module docstring, phase 13), random
    weights of seed 0. With one card both ranks share it over gloo (NCCL
    refuses two ranks on one device); with two or more, one rank a card
    over NCCL. Each is held against a
    one-card engine on the same requests, run first here and freed before
    the ranks start; every rank's ids must equal the leader's. Returns the
    launches summed over the ranks and sub-phases, and the numbers."""
    import pickle
    import tempfile

    import torch

    from llmlb_tpu_torch.parallel.distributed import spawn_world

    from llmlb_tpu_torch.kernels import build
    from llmlb_tpu_torch.lora import save_adapter

    t0 = time.perf_counter()
    _md_kernel_checks()
    _md_lora_checks()
    prompts = _md_prompts()
    n_long = len(prompts["llama"][-1])
    adapters = [a for _, a in MD_LORA_ROWS]
    lora_tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    prompts["lora_dir"] = lora_tmp.name
    for name, rank, targets in ADAPTERS:
        save_adapter(lora_tmp.name, name, _md_cfg("lora"), rank=rank,
                     targets=targets, scale=ADAPTER_SCALE)
    refs = {"llama": _md_reference("tp", prompts["llama"],
                                   len(prompts["llama"]) - 1),
            # the ep sub-phase's prompts, then the moe_dp group queued at once
            "mixtral": _md_reference("ep", prompts["mixtral"], None,
                                     together=prompts["moe_dp"]),
            "lora": _md_reference("lora", prompts["lora"], None, adapters,
                                  lora_tmp.name),
            "leader": _md_reference("leader", [], None,
                                    embed=prompts["embed"])}
    # moe_dp's one-card run: the group, then the ep sub-phase's prompts
    refs["moe_dp"] = _md_pick(refs["mixtral"],
                              [2 + i for i in range(MD_MOE_ROWS)]
                              + list(MD_MOE_AFTER))
    log(f"multi-device: one-card references in "
        f"{refs['llama']['seconds']:.1f} s (Llama-3-8B, {MD_CUT_LAYERS} "
        f"layers, prompts of {[len(p) for p in prompts['llama']]} tokens), "
        f"{refs['mixtral']['seconds']:.1f} s (Mixtral, "
        f"{MIX_BF16_LAYERS} layers, {[len(p) for p in prompts['mixtral']]},"
        f" then the moe_dp group {[len(p) for p in prompts['moe_dp']]} "
        f"queued at once, its capacity drops a layer "
        f"{refs['mixtral']['drops']}),"
        f" {refs['lora']['seconds']:.1f} s (Llama-3-8B, {MD_CUT_LAYERS} "
        f"layers, with adapters {adapters}) and "
        f"{refs['leader']['seconds']:.1f} s (Llama-3-8B, {MD_CUT_LAYERS} "
        f"layers, the embeddings)")
    backend = "nccl" if dev["count"] >= 2 else "gloo"
    world = 2
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, lora_tmp:
        src = f"{tmp}/prompts.pkl"
        with open(src, "wb") as f:
            pickle.dump(prompts, f)
        outs = spawn_world(
            lambda rank, port: [sys.executable, str(Path(__file__).resolve()),
                                "--md-rank", str(rank), str(world), str(port),
                                backend, src, f"{tmp}/rank{rank}.pkl"],
            world, timeout_s=900)
        for r, (_, stdout, _) in enumerate(outs):
            for line in stdout.splitlines():
                log(f"  {line}")
        bad = [(r, rc, err) for r, (rc, _, err) in enumerate(outs) if rc]
        if bad:
            raise AssertionError("multi-device: " + "\n".join(
                f"rank {r} exited {rc}:\n{err[-3000:]}" for r, rc, err in bad))
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    ranks_s = time.perf_counter() - t_ranks
    launches: dict[str, int] = {}
    report = {"backend": backend, "world": world, "subphases": {}}
    for sub in MD_SUBS:
        lead = ranks[0][sub]
        ref = refs[{"ep": "mixtral", "moe_dp": "moe_dp",
                    "lora": "lora"}.get(sub, "llama")]
        n = len(lead["held"])
        h = MD_HTTP[sub]  # the leader's HTTP streams went to its clients
        for r in range(1, world):
            if ranks[r][sub]["streams"][h:] != lead["streams"][h:]:
                raise AssertionError(f"multi-device {sub}: rank {r}'s ids "
                                     "differ from the leader's")
        per_rank = [{k: v for k, v in x[sub]["launches"].items() if v}
                    for x in ranks]
        missing = [k for k in MD_PATH[sub]
                   if any(pr.get(k, 0) == 0 for pr in per_rank)]
        if missing:
            raise AssertionError(f"multi-device {sub}: kernels never "
                                 f"launched on a rank: {missing}")
        for pr in per_rank:
            for k, v in pr.items():
                launches[k] = launches.get(k, 0) + v
        held = _md_hold(sub, ref, lead, n)
        rings = [x[sub]["ring_passes"] for x in ranks]
        if rings != [1 if sub == "sp" else 0] * world:
            raise AssertionError(f"multi-device {sub}: ring passes {rings}")
        if sub in ("sp", "dp"):
            held["kv_err"] = _md_kv_check(lead["kv"], ref["kv"],
                                          ref["fp32_kv"], n_long, sub)
        if sub == "dp":
            held.update(_md_dp_checks(ranks, ref, n_long))
        if sub == "moe_dp":
            held.update(_md_moe_dp_checks(ranks, ref))
        if sub == "lora":
            held.update(_md_lora_hold(ranks))
        col = [x[sub]["collectives"] for x in ranks]
        log(f"multi-device {sub} [{dev['smi']}]: mesh {lead['mesh']} over "
            f"{lead['backend']}; rank heads/kv/ffn/experts {lead['local']}, "
            f"params {lead['param_gib']:.2f} GiB a rank; engine init "
            f"{[round(x[sub]['init_s'], 1) for x in ranks]} s, serving "
            f"{[round(x[sub]['serve_s'], 1) for x in ranks]} s (HTTP chats "
            f"{lead['http']} tokens, then {n} prompts x {MD_TOKENS} ids on "
            f"the core); collectives a rank (calls, MiB, host s) "
            f"{[(c['calls'], round(c['bytes'] / 2**20, 1), round(c['seconds'], 2)) for c in col]}; "
            f"launches a rank {per_rank}"
            + (f"; the {n_long}-token prompt's KV in the pages: layer 0 "
               f"within the bf16 limit of one card's, every layer as "
               f"accurate as one card's ({held['kv_err']})"
               if sub in ("sp", "dp") else ""))
        report["subphases"][sub] = {
            "init_s": [x[sub]["init_s"] for x in ranks],
            "serve_s": [x[sub]["serve_s"] for x in ranks],
            "collectives": col, "launches": per_rank,
            **{k: v for k, v in held.items() if k != "partings"},
            "partings": [(i, p, round(m, 4)) for i, p, m in held["partings"]]}
    report["subphases"].update(_md_leader_checks(ranks, refs["leader"], dev,
                                                 launches))
    report["ranks_s"] = ranks_s
    report["seconds"] = time.perf_counter() - t0
    log(f"multi-device: {report['seconds']:.1f} s ({ranks_s:.1f} s the ranks' "
        f"world, backend {backend}); launches summed over ranks {launches}")
    report["launches"] = launches
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout to import llmlb_tpu_torch from (another "
                             "commit with the checkpoint loader and KV "
                             "shipping, to time two trees in one call)")
    parser.add_argument("--serve-only", action="store_true",
                        help="run the device, build and serve phases only")
    parser.add_argument("--ids-only", action="store_true",
                        help="print the bf16 serve phase's timed prompts' "
                             "greedy ids on a one-card engine (with --tree, "
                             "another checkout's)")
    parser.add_argument("--multi-device-only", action="store_true",
                        help="run the device, build and multi-device phases "
                             "only")
    parser.add_argument("--md-rank", nargs=6, default=None,
                        metavar=("RANK", "WORLD", "PORT", "BACKEND", "IN",
                                 "OUT"),
                        help="(internal) one rank of the multi-device phase")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve() if args.tree else REPO
    if not all((tree / "llmlb_tpu_torch" / f).exists() for f in (
            "engine/kv_transfer.py", "ops/grammar.py")):
        print(f"chip_smoke: {tree} has no checkpoint loader, KV shipping or "
              "structured outputs, which the serve phases drive; run that "
              "tree's own chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    try:
        import llmlb_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    if Path(llmlb_tpu_torch.__file__).resolve().parents[1] != tree:
        print(f"chip_smoke: imported {llmlb_tpu_torch.__file__}, not from "
              f"{tree}", file=sys.stderr)
        return 2

    if args.md_rank is not None:
        rank, world, port, backend, src, dst = args.md_rank
        md_rank_main(int(rank), int(world), int(port), backend, src, dst)
        return 0

    t_start = time.perf_counter()
    phase = "device"
    kernels = []
    took: dict[str, float] = {}  # seconds each phase took

    def run(name: str, fn, *args, **kwargs):
        nonlocal phase
        phase = name
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    try:
        dev = run("device", phase_device)
        run("build", phase_build)
        if args.ids_only:
            log(json.dumps({"bf16_ids": phase_ids(), "tree": str(tree)}))
            return 0
        if args.multi_device_only:
            md = run("multi-device", phase_multi_device, dev)
            log(f"total {time.perf_counter() - t_start:.1f} s; by phase {took}")
            log(json.dumps({"multi_device": {k: v for k, v in md.items()
                                             if k != "subphases"}}))
            log(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": dev["kind"],
                "count": dev["count"]}}))
            return 0
        if not args.serve_only:
            kernels = run("kernels", phase_kernels)
            run("unembed", phase_unembed)
            run("model entry points", phase_model_entry_points)
        ckpt = run("checkpoint", phase_checkpoint, dev)
        stats = run("serve", phase_serve, dev, "bf16", BF16_PATH, ckpt=ckpt)
        stats_int8 = run("serve int8", phase_serve, dev, "quantize=all",
                         INT8_PATH, bf16_ids=stats["ids"], ckpt=ckpt,
                         quantize="all")
        ckpt["tmp"].cleanup()
        stats_lora = run("serve lora", phase_serve_lora, dev, stats["ids"])
        stats_dense = run(
            "serve dense", phase_serve, dev, "dense", DENSE_PATH,
            bf16_ids=stats["ids"], bf16_long_ids=stats["long_ids"],
            structured_ids=stats["overload"]["structured"]["fused_ids"],
            kv_layout="dense")
        stats_mix = run("serve mixtral", phase_serve_mixtral, dev)
        stats_mix["bf16"] = run("mixtral bf16", phase_mixtral_bf16, dev)
        stats_mm = (None if args.serve_only
                    else run("multimodal", phase_multimodal, dev))
        stats_md = (None if args.serve_only
                    else run("multi-device", phase_multi_device, dev))
    except BaseException:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' FAILED", file=sys.stderr)
        return 1
    serves = {"bf16": stats, "quantize=all": stats_int8, "lora": stats_lora,
              "dense": stats_dense}
    log(json.dumps({"serve": {
        label: {**{k: st[k] for k in (
            "ttft_s", "ttft_long_s", "ttft_long_hit_s", "ttft_long_off_s",
            "prefix_ttft_on_s", "prefix_ttft_off_s", "decode_tok_s_1",
            "tok_s_8", "tok_s_8_off", "decode_tok_s_1_eager") if k in st},
                **{k: st["overload"][k] for k in (
                    "park_m", "resume_ms", "ref_gap", "ref_prefill_ms",
                    "sweep", "embed_batch_ms", "embed_one_ms")
                   if k in st.get("overload", {})},
                **({"checkpoint": st["checkpoint"]} if "checkpoint" in st
                   else {}),
                **({"kv_ship": st["overload"]["kv_ship"]}
                   if "kv_ship" in st.get("overload", {}) else {}),
                **({"structured": {k: v for k, v in st["overload"][
                    "structured"].items()
                    if k not in ("launches", "fused_ids")}}
                   if "structured" in st.get("overload", {}) else {}),
                **({"spec": {k: v for k, v in st["overload"]["spec"].items()
                             if k in ("rates", "counts", "logit_diff",
                                      "replay_ms", "partings", "rate_on",
                                      "rate_off")}}
                   if "spec" in st.get("overload", {}) else {}),
                **({"spec_graphs": st["overload"]["spec_graphs"]["replay_ms"],
                    "budget": st["overload"]["budget"]}
                   if "budget" in st.get("overload", {}) else {}),
                **({"disagg": {k: v for k, v in st["overload"][
                    "disagg"].items() if k != "launches"}}
                   if "disagg" in st.get("overload", {}) else {}),
                **({"gateway": {k: v for k, v in st["overload"][
                    "gateway"].items() if k != "launches"}}
                   if "gateway" in st.get("overload", {}) else {})}
        for label, st in serves.items()}, "mixtral": {
            k: v for k, v in stats_mix.items() if k != "launches"},
        "multimodal": stats_mm,
        "multi_device": stats_md and {k: v for k, v in stats_md.items()
                                      if k != "launches"},
        "tree": str(tree), "card": dev["smi"]}))
    own_path = {"lora_delta": stats_lora, "flash_decode": stats_dense,
                "flash_extend": stats_dense,
                **{n: stats_int8 for n in INT8_PATH if n != "flash_prefill"}}
    for k in kernels:  # each kernel's count from the path it belongs to
        k["launches"] = own_path.get(k["name"], stats)["launches"][k["name"]]
        if stats_md is not None:  # with the multi-device ranks' launches
            k["launches"] += stats_md["launches"].get(k["name"], 0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase {took}")
    log(json.dumps({"kernels": [{key: k[key] for key in order}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev["kind"],
                                           "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
